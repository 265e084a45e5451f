#!/usr/bin/env python
"""Loss-floor evidence for the early presets at their trained budgets: the
port's counterpart of ``scripts/loss_floor_report.py``, read from the
per-epoch histories that ``scripts/torch_train_early_presets.py`` writes
(``<art_dir>/<model>_<grid>/<model>_x.json``, ``ml.train.save_weights``'
sidecars).  Numpy only; nothing runs on a device.

- ``best_epoch`` / ``epochs``: where the minimum validation loss sits.
- ``tail_decades_per_100ep``: the least-squares slope of log10(val_loss)
  over the last third of training (at least 10 epochs).
- ``projected_floor_gain_decades``: that slope carried to the reference's
  epoch budget (``REF_EPOCHS``), the most its extra epochs could buy if the
  tail went on as it is.

The verdict per model: ``at_floor`` if the tail rises, is flatter than 0.1
decades per 100 epochs, or projects under 0.15 decades to the reference's
budget.  The ``loss_floor`` block is written into ``<art_dir>/summary.json``
as the JAX script writes it, each model's numbers beside JAX's record of
the same model (``jax_<key>``, ``d_<key>``, from
``docs/artifacts/<art_dir's name>/summary.json``, else ``ml_early``'s),
and a table is printed.

Usage: python scripts/torch_loss_floor_report.py [art_dir]
(default ``docs/artifacts/torch/ml_early``)
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")

# Reference epoch budgets (CNN_<X>.py model.fit epochs= in the reference's
# CNN<X>_192/): One/Two/Four/Five 500, Six 200, Seven 500.
REF_EPOCHS = {
    "cnn_one": 500, "cnn_two": 500, "cnn_three": 500, "cnn_four": 500,
    "cnn_five": 500, "cnn_six": 200, "cnn_seven": 500,
    "cnn_ten": 400,   # CNNTen_384/CNN_Ten.py:170 (per-component fits)
}

FLAT_SLOPE = 0.1      # decades per 100 epochs
SMALL_GAIN = 0.15     # projected decades to the reference budget


def analyze(history: dict, trained: int, ref_budget: int) -> dict:
    val = np.asarray(history.get("val_loss", history["loss"]), np.float64)
    n = len(val)
    best = int(np.argmin(val))
    tail = val[max(0, n - max(10, n // 3)):]
    # Least-squares slope of log10(val) over the tail, in decades/100ep.
    x = np.arange(len(tail), dtype=np.float64)
    y = np.log10(np.maximum(tail, 1e-300))
    slope = float(np.polyfit(x, y, 1)[0] * 100.0) if len(tail) >= 4 else 0.0
    extra = max(0, ref_budget - trained)
    projected = slope * extra / 100.0
    # A rising val-loss tail (slope > 0) means the best-val floor is already
    # behind us (early-stopping regime): more epochs cannot help.
    at_floor = (slope > 0 or abs(slope) < FLAT_SLOPE
                or abs(projected) < SMALL_GAIN)
    return {
        "epochs": trained,
        "ref_epochs": ref_budget,
        "best_epoch": best,
        "best_val_loss": float(val[best]),
        "final_val_loss": float(val[-1]),
        "tail_decades_per_100ep": round(slope, 4),
        "projected_floor_gain_decades": round(projected, 4),
        "at_floor": bool(at_floor),
    }


def _model_jsons(art_dir: str):
    """Yield (key, history-json path) for every ``cnn_*_{x,y}.json`` under
    the artifact dir's model subdirectories."""
    for sub in sorted(os.listdir(art_dir)):
        mdir = os.path.join(art_dir, sub)
        if not os.path.isdir(mdir):
            continue
        for fn in sorted(os.listdir(mdir)):
            if fn.startswith("cnn_") and fn.endswith(("_x.json", "_y.json")):
                comp = fn[-6]                           # x or y
                yield (sub if comp == "x" else f"{sub}_{comp}"), os.path.join(mdir, fn)


def jax_floor(art_dir: str) -> dict:
    """JAX's ``loss_floor`` models of the record this one stands beside."""
    for name in (os.path.basename(os.path.normpath(art_dir)), "ml_early"):
        path = os.path.join(JAX_ARTIFACTS, name, "summary.json")
        if os.path.exists(path):
            with open(path) as fh:
                floor = json.load(fh).get("loss_floor")
            if floor:
                return floor["models"]
    return {}


def beside(port: dict, jax: dict | None) -> dict:
    """``port`` with JAX's number beside each of its numbers."""
    out = dict(port)
    for key, value in port.items():
        ref = (jax or {}).get(key)
        if (isinstance(value, (int, float)) and isinstance(ref, (int, float))
                and not isinstance(value, bool) and not isinstance(ref, bool)):
            out[f"jax_{key}"] = ref
            out[f"d_{key}"] = value - ref
        elif isinstance(ref, bool):
            out[f"jax_{key}"] = ref
    return out


def main(art_dir: str | None = None) -> int:
    art_dir = art_dir or os.path.join(ROOT, "docs", "artifacts", "torch", "ml_early")
    summary_path = os.path.join(art_dir, "summary.json")
    with open(summary_path) as f:
        summary = json.load(f)
    jax = jax_floor(art_dir)
    out = {}
    for key, jpath in _model_jsons(art_dir):
        with open(jpath) as f:
            hist = json.load(f)["history"]
        name = os.path.basename(jpath)[:-7]   # cnn_two_x.json -> cnn_two
        trained = len(hist["loss"])
        ref = REF_EPOCHS.get(name)
        if ref is None:
            continue  # 384-class models have their own budget record
        out[key] = beside(analyze(hist, trained, ref), jax.get(key))
    summary["loss_floor"] = {
        "what": ("floor evidence at the trained budget vs the reference's "
                 "epoch counts; see scripts/torch_loss_floor_report.py docstring"),
        "criteria": {"flat_tail_decades_per_100ep": FLAT_SLOPE,
                     "small_projected_gain_decades": SMALL_GAIN},
        "models": out,
    }
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    w = max([len(k) for k in out] + [5])
    print(f"{'model':<{w}}  ep/ref   best@  tail d/100ep  proj d  at_floor")
    for k, v in out.items():
        print(f"{k:<{w}}  {v['epochs']}/{v['ref_epochs']:<5} "
              f"{v['best_epoch']:>5}  {v['tail_decades_per_100ep']:>12} "
              f"{v['projected_floor_gain_decades']:>7}  {v['at_floor']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
