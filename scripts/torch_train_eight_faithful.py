#!/usr/bin/env python
"""The reference's own recipe for ``cnn_eight`` at native 384^2 on the
card, both components: the port's counterpart of
``scripts/train_eight_faithful.py``.  RMSprop at lr 1e-3 with Keras
inverse-time decay 0.02, 600 epochs, batch 20 (reference:
``CNNEight_384/CNN_Eight.py:145-151``); ``LBM_KERNEL_INIT=glorot_uniform``
runs the same recipe with Keras 2.x's initialiser into ``cnn_eight_glorot``.

Resumable: a component whose weights are already on disk (the port's
``.pt`` or the JAX package's ``.msgpack``) is not trained again, and each
training run checkpoints every 10 epochs.  Both components are then read
back from disk and evaluated at ``train_full``'s held-out Re
(``torch_train_full.evaluate_saved``).  ``<out>/<dir>/summary.json`` holds
the JAX script's keys with JAX's record of the same directory
(``docs/artifacts/ml_full/cnn_eight_faithful/summary.json``) beside each
number (``jax_<key>``, ``d_<key>``), and the seconds each component trained.

The JAX script takes no arguments (its dataset and output are
``data/ml_full`` and ``docs/artifacts/ml_full``).  Here ``--data`` and
``--out`` name them (defaults ``data/ml_full`` and
``docs/artifacts/torch/ml_full``), and ``--device cpu`` trains on the CPU.

Usage (from the repository root, one card visible):

    python scripts/torch_train_eight_faithful.py [--data data/ml_full] [--out docs/artifacts/torch/ml_full]
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
from torch_train_full import (HELD_OUT, SEED, beside, evaluate_saved, figures,  # noqa: E402
                              split_dataset)

NAME = "cnn_eight"
EPOCHS = 600
LR = 1e-3
SCHEDULE = "inverse"  # Keras decay=0.02 parity (CNN_Eight.py:145)
BATCH = 20
KERNEL_INIT = os.environ.get("LBM_KERNEL_INIT", "lecun_normal")
CHECKPOINT_EVERY = 10
JAX_DIR = os.path.join(ROOT, "docs", "artifacts", "ml_full")


def out_name() -> str:
    return "cnn_eight_glorot" if KERNEL_INIT == "glorot_uniform" else "cnn_eight_faithful"


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
    out_dir = os.path.join(out_root, out_name())
    os.makedirs(out_dir, exist_ok=True)

    ds = datagen.load_dataset(data_dir)
    meta_path = os.path.join(data_dir, "metadata.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    u_lid = meta.get("u_lid", 0.08)
    train_ds, held = split_dataset(ds, HELD_OUT)
    data = tr.prepare_inputs(train_ds, PRESETS[NAME], u_lid=u_lid)
    log(f"dataset {ds.f_final.shape}; faithful {NAME} recipe: "
        f"RMSprop lr={LR} {SCHEDULE} x {EPOCHS} epochs, batch {BATCH}")

    seconds = {}
    for comp in ("x", "y"):
        stem = os.path.join(out_dir, f"{NAME}_{comp}")
        if any(os.path.exists(stem + ext) for ext in (".pt", ".msgpack")):
            log(f"{comp}: resuming from existing weights")
            continue
        t_c = time.time()
        res = tr.train(NAME, data, component=comp, epochs=EPOCHS, optimizer="rmsprop",
                       learning_rate=LR, schedule=SCHEDULE, batch_size=BATCH, verbose=True,
                       kernel_init=KERNEL_INIT, checkpoint_path=stem + ".ckpt",
                       checkpoint_every=CHECKPOINT_EVERY, device=args.device)
        seconds[comp] = round(time.time() - t_c, 2)
        tr.save_weights(res, out_dir, scalers=data.scalers)
        if figures():
            tr.plot_history(res.history, stem + "_loss.png")
        log(f"{comp}: {len(res.history['loss'])} epochs, final val MSE "
            f"{res.history['val_loss'][-1]:.3e}")

    _, entry = evaluate_saved(NAME, ("x", "y"), data, ds, held, u_lid, out_dir, log,
                              device=args.device)
    recipe = {"optimizer": "rmsprop", "lr": LR,
              "schedule": SCHEDULE + " (Keras decay=0.02 parity, CNN_Eight.py:145)",
              "epochs": EPOCHS, "batch_size": BATCH, "kernel_init": KERNEL_INIT}
    summary = {"recipe": recipe, "final_val_mse": entry["final_val_mse"],
               "held_out_eval": entry["held_out_eval"]}
    jax_path = os.path.join(JAX_DIR, out_name(), "summary.json")
    jax = json.load(open(jax_path)) if os.path.exists(jax_path) else None
    summary = dict(beside(summary, jax), train_s=seconds, seed=SEED, device=args.device)
    summary_path = os.path.join(out_dir, "summary.json")
    with open(summary_path, "w") as fh:
        json.dump(summary, fh, indent=1)
    log(f"done -> {summary_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
