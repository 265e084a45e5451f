#!/usr/bin/env python
"""Resume ``cnn_eight``'s retraining on the whole dataset at its y
component, on the card: the port's counterpart of
``scripts/resume_eight_y.py``.  Trains y with ``train_full``'s recipe (Adam,
the preset's 600 epochs), then runs ``train_full``'s held-out evaluation
with the x weights an earlier run saved in ``<out>/cnn_eight``
(``torch_train_full.evaluate_saved``, which reads both halves from disk)
and merges the model's entry into ``<out>/summary.json`` exactly as
``torch_train_full.py`` writes it, JAX's record of ``cnn_eight``
(``docs/artifacts/ml_full/summary.json``) beside each number.

The JAX script takes no arguments: its dataset and output are
``data/ml_full`` and ``docs/artifacts/ml_full``.  Here ``--data`` and
``--out`` name them (defaults ``data/ml_full`` and
``docs/artifacts/torch/ml_full``), and ``--device cpu`` trains on the CPU
in place of the card.

Usage (from the repository root, one card visible):

    python scripts/torch_resume_eight_y.py [--data data/ml_full] [--out docs/artifacts/torch/ml_full]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

from latticeboltzmannsimulations_torch.ml import datagen, train as tr  # noqa: E402
from latticeboltzmannsimulations_torch.ml.models import PRESETS  # noqa: E402
from torch_train_full import (HELD_OUT, SEED, evaluate_saved, figures, merge_summary,  # noqa: E402
                              model_record, split_dataset)

NAME = "cnn_eight"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:8.1f}s] {msg}", flush=True)

    data_dir = args.data or os.path.join(ROOT, "data", "ml_full")
    out_root = args.out or os.path.join(ROOT, "docs", "artifacts", "torch", "ml_full")
    out_dir = os.path.join(out_root, NAME)

    ds = datagen.load_dataset(data_dir)
    meta_path = os.path.join(data_dir, "metadata.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    u_lid = meta.get("u_lid", 0.08)
    train_ds, held = split_dataset(ds, HELD_OUT)
    data = tr.prepare_inputs(train_ds, PRESETS[NAME], u_lid=u_lid)
    log(f"dataset {ds.f_final.shape}; resuming {NAME}/y")

    t_y = time.time()
    res_y = tr.train(NAME, data, component="y", optimizer="adam", verbose=False,
                     device=args.device)
    train_s = round(time.time() - t_y, 2)
    tr.save_weights(res_y, out_dir, scalers=data.scalers)
    if figures():
        tr.plot_history(res_y.history, os.path.join(out_dir, f"{NAME}_y_loss.png"))
    log(f"{NAME}/y: {len(res_y.history['loss'])} epochs, final val MSE "
        f"{res_y.history['val_loss'][-1]:.3e}")

    # the x leg from disk beside the y leg just saved
    _, entry = evaluate_saved(NAME, ("x", "y"), data, ds, held, u_lid, out_dir, log,
                              device=args.device)
    merge_summary(out_root, NAME, model_record(NAME, entry, train_s={"y": train_s}, seed=SEED,
                                               device=args.device))
    log("summary merged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
