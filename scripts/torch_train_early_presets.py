#!/usr/bin/env python
"""Train the early-generation presets ``cnn_two`` .. ``cnn_seven`` on the
card: the port's counterpart of ``scripts/train_early_presets.py``, with its
command line (plus ``--device``).  The 2x-downsampled 192^2 dataset, 120
epochs by default, the x component, Adam (``cnn_seven`` also at its native
384^2); each run checkpoints every 25 epochs and records its loss descent
and the full-field R^2 and relative L2 of u_x at the Re nearest 5000 that
is not quarantined (a partial dataset may lack Re 5000 itself).

``<out>/summary.json`` (default ``docs/artifacts/torch/ml_early``) holds,
as the JAX script's does, one entry per ``<model>_<grid>``, and beside each
number JAX's record of the same entry (``jax_<key>``, ``d_<key>``) from
``docs/artifacts/<out's name>/summary.json`` where that exists
(``ml_early_ref_budget``, ``ml_early_glorot``: the same script with other
arguments), else from ``docs/artifacts/ml_early/summary.json``.  The card's
machine has no matplotlib: no loss plots are drawn there.

Usage (from the repository root, one card visible):

    python scripts/torch_train_early_presets.py [--epochs 120] [--models cnn_two,...,cnn_seven]
        [--data data/ml_full] [--out docs/artifacts/torch/ml_early]

``--device cpu`` trains on the CPU in place of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

from latticeboltzmannsimulations_torch.ml import datagen, predict, train as tr  # noqa: E402
from latticeboltzmannsimulations_torch.ml.models import PRESETS  # noqa: E402
from torch_train_full import (HELD_OUT, SEED, beside, downsample, figures,  # noqa: E402
                              full_field_r2, split_dataset)

EVAL_RE = 5000.0
JAX_ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")


def jax_summary(out_root: str) -> dict:
    """JAX's record that this run's summary stands beside."""
    for name in (os.path.basename(os.path.normpath(out_root)), "ml_early"):
        path = os.path.join(JAX_ARTIFACTS, name, "summary.json")
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
    return {"models": {}}


def eval_index(eval_ds) -> int:
    """The slot of the Re nearest ``EVAL_RE`` that is not quarantined (a
    zero-filled slot must never be the truth: rel_l2 would divide by 0)."""
    ok = (np.ones(len(eval_ds.re_range), bool) if eval_ds.failed is None
          else ~eval_ds.failed)
    cand = np.where(ok)[0]
    if not len(cand):
        raise RuntimeError("all eval slots quarantined in this dataset")
    return int(cand[np.argmin(np.abs(eval_ds.re_range[cand] - EVAL_RE))])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--models",
                    default="cnn_two,cnn_three,cnn_four,cnn_five,cnn_six,"
                            "cnn_seven")
    ap.add_argument("--seven-384-epochs", type=int, default=60,
                    help="extra cnn_seven run at native 384² (0 disables)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "rmsprop"])
    ap.add_argument("--schedule", default=None,
                    choices=["cosine", "plateau", "inverse"])
    ap.add_argument("--clip-norm", type=float, default=None,
                    help="global-norm gradient clipping (stabilises "
                         "raw-scaled presets that diverge at lr 1e-3)")
    ap.add_argument("--kernel-init", default="lecun_normal",
                    choices=["lecun_normal", "glorot_uniform"],
                    help="glorot_uniform = Keras 2.x Conv/ConvTranspose "
                         "default (the r5 init-controlled retry)")
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    data_dir = args.data or os.path.join(ROOT, "data", "ml_full")
    out_root = args.out or os.path.join(ROOT, "docs", "artifacts", "torch", "ml_early")
    os.makedirs(out_root, exist_ok=True)
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    ds = datagen.load_dataset(data_dir)
    meta_path = os.path.join(data_dir, "metadata.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    u_lid = meta.get("u_lid", 0.08)
    train_ds, _ = split_dataset(ds, HELD_OUT)
    ds192 = downsample(ds, 2)
    train192 = downsample(train_ds, 2)
    log(f"dataset {ds.f_final.shape}; training M2-M7 on 192² downsample")

    summary_path = os.path.join(out_root, "summary.json")
    summary = (json.load(open(summary_path))
               if os.path.exists(summary_path) else {"models": {}})
    jax = jax_summary(out_root).get("models", {})

    def run(name, data, eval_ds, grid_tag, epochs):
        out_dir = os.path.join(out_root, f"{name}_{grid_tag}")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        res = tr.train(name, data, component="x", epochs=epochs,
                       optimizer=args.optimizer, learning_rate=args.lr,
                       schedule=args.schedule, clip_norm=args.clip_norm,
                       kernel_init=args.kernel_init,
                       checkpoint_path=os.path.join(out_dir, f"{name}_x.ckpt"),
                       checkpoint_every=25, device=args.device)
        dt = time.time() - t0
        tr.save_weights(res, out_dir, scalers=data.scalers)
        if figures():
            tr.plot_history(res.history, os.path.join(out_dir, f"{name}_x_loss.png"))
        i = eval_index(eval_ds)
        eval_re = float(eval_ds.re_range[i])
        fnet, aux = predict.build_input(name, eval_re, eval_ds.feq_initial,
                                        data.scalers, u_lid=u_lid)
        u_cnn = predict.predict_velocity(name, res.params, res.params, fnet, aux,
                                         data.scalers, device=args.device)
        u_true = eval_ds.u_final[i]
        h = res.history
        rec = {
            "epochs": epochs, "grid": data.fnet.shape[1],
            "first_loss": h["loss"][0], "final_loss": h["loss"][-1],
            "final_val_mse": h["val_loss"][-1],
            "eval_re": eval_re,
            "r2_ux_re5000": round(full_field_r2(u_true[0], u_cnn[0]), 5),
            "rel_l2_ux_re5000": round(
                float(np.linalg.norm(u_cnn[0] - u_true[0])
                      / np.linalg.norm(u_true[0])), 5),
            "train_s": round(dt, 1),
            "lr": args.lr,
            "optimizer": args.optimizer,
            **({"kernel_init": args.kernel_init}
               if args.kernel_init != "lecun_normal" else {}),
            **({"schedule": args.schedule} if args.schedule else {}),
            **({"clip_norm": args.clip_norm}
               if args.clip_norm is not None else {}),
        }
        key = f"{name}_{grid_tag}"
        summary["models"][key] = dict(beside(rec, jax.get(key)), seed=SEED, device=args.device)
        with open(summary_path, "w") as fh:
            json.dump(summary, fh, indent=1)
        log(f"{name}@{grid_tag}: loss {h['loss'][0]:.3e} -> "
            f"{h['loss'][-1]:.3e}, val {h['val_loss'][-1]:.3e}, "
            f"relL2(ux)@Re5000 {rec['rel_l2_ux_re5000']:.4f} in {dt:.0f}s")

    for name in [m for m in args.models.split(",") if m]:
        data = tr.prepare_inputs(train192, PRESETS[name], u_lid=u_lid)
        run(name, data, ds192, "192", args.epochs)

    if args.seven_384_epochs and "cnn_seven" in args.models:
        data = tr.prepare_inputs(train_ds, PRESETS["cnn_seven"], u_lid=u_lid)
        run("cnn_seven", data, ds, "384", args.seven_384_epochs)

    log(f"done -> {summary_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
