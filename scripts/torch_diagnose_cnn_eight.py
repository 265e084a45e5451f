#!/usr/bin/env python
"""Why does ``cnn_eight`` collapse at 384^2?  The controlled experiment of
``scripts/diagnose_cnn_eight.py`` on the card, with its command line (plus
``--device``): seven matched runs of the x component, Adam, each evaluated
at the held-out Re 5000 against the stored LBM field (full-field R^2 and
relative L2 of u_x):

  base150     lr 1e-3 constant       lr3e-4    lr 3e-4 constant
  cosine      lr 1e-3 cosine         plateau   lr 1e-3 /5 at 50 % and 80 %
  auxin       cnn_eight with the BC planes at its input (``aux_bc_at_input``)
  msfront     cnn_eight with cnn_nine's multiscale front
  g192        the unchanged preset on the 2x-downsampled dataset

The two structural variants are ``dataclasses.replace`` of the port's
``cnn_eight`` preset, registered in ``PRESETS`` (``register_variants``) as
the JAX script registers its flax ones.  ``<out>/summary.json`` (default
``docs/artifacts/torch/cnn_eight_diag``) holds the JAX script's record with
JAX's run of the same tag beside each number (``jax_<key>``, ``d_<key>``,
from ``docs/artifacts/cnn_eight_diag/summary.json``).  The card's machine
has no matplotlib: no loss plots are drawn there.

Usage (from the repository root, one card visible):

    python scripts/torch_diagnose_cnn_eight.py [--epochs 150] [--data data/ml_full] [--only base150,g192]

``--device cpu`` trains on the CPU in place of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
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
JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "cnn_eight_diag", "summary.json")
# the structural variants of cnn_eight, by preset name
VARIANTS = {"cnn_eight_auxin": {"aux_bc_at_input": True},
            "cnn_eight_ms": {"multiscale_front": (2, 4, 8, 12)}}


def register_variants() -> None:
    for name, change in VARIANTS.items():
        PRESETS[name] = dataclasses.replace(PRESETS["cnn_eight"], name=name, **change)


def run_one(tag, preset_name, data, ds, u_lid, epochs, lr, schedule, out_dir, log,
            device="cuda"):
    t0 = time.time()
    res = tr.train(preset_name, data, component="x", epochs=epochs,
                   learning_rate=lr, optimizer="adam", schedule=schedule, device=device)
    dt = time.time() - t0
    if figures():
        tr.plot_history(res.history, os.path.join(out_dir, f"{tag}_loss.png"))
    # Held-out eval (x component, Re=5000 vs the stored LBM field).
    fnet, aux = predict.build_input(preset_name, EVAL_RE, ds.feq_initial,
                                    data.scalers, u_lid=u_lid)
    u_cnn = predict.predict_velocity(preset_name, res.params, res.params,
                                     fnet, aux, data.scalers, device=device)
    i = int(np.argwhere(ds.re_range == EVAL_RE)[0, 0])
    u_true = ds.u_final[i]
    rec = {
        "tag": tag, "preset": preset_name, "epochs": epochs, "lr": lr,
        "schedule": schedule or "constant",
        "val_mse": res.history["val_loss"][-1],
        "min_val_mse": float(np.min(res.history["val_loss"])),
        "r2_ux_re5000": round(full_field_r2(u_true[0], u_cnn[0]), 5),
        "rel_l2_ux_re5000": round(
            float(np.linalg.norm(u_cnn[0] - u_true[0])
                  / np.linalg.norm(u_true[0])), 5),
        "train_s": round(dt, 1),
    }
    log(f"{tag}: val {rec['val_mse']:.3e} (min {rec['min_val_mse']:.3e}) "
        f"relL2(ux)@Re5000 {rec['rel_l2_ux_re5000']:.4f} in {dt:.0f}s")
    return rec


def write_summary(out_dir: str, epochs: int, recs: list, device: str) -> None:
    jax = {}
    if os.path.exists(JAX_RECORD):
        with open(JAX_RECORD) as fh:
            jax = {r["tag"]: r for r in json.load(fh)["runs"]}
    runs = [beside(r, jax.get(r["tag"])) for r in recs]
    with open(os.path.join(out_dir, "summary.json"), "w") as fh:
        json.dump({"epochs": epochs, "eval_re": EVAL_RE, "runs": runs, "seed": SEED,
                   "device": device}, fh, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="",
                    help="comma list of tags to run (default: all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    data_dir = args.data or os.path.join(ROOT, "data", "ml_full")
    out_dir = args.out or os.path.join(ROOT, "docs", "artifacts", "torch", "cnn_eight_diag")
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    ds = datagen.load_dataset(data_dir)
    meta_path = os.path.join(data_dir, "metadata.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    u_lid = meta.get("u_lid", 0.08)
    train_ds, _ = split_dataset(ds, HELD_OUT)
    log(f"dataset {ds.f_final.shape}, {len(train_ds.re_range)} train cavities")

    register_variants()
    data384 = tr.prepare_inputs(train_ds, PRESETS["cnn_eight"], u_lid=u_lid)
    ep = args.epochs
    runs = [
        ("base150", "cnn_eight", data384, ds, 1e-3, None),
        ("lr3e-4", "cnn_eight", data384, ds, 3e-4, None),
        ("cosine", "cnn_eight", data384, ds, 1e-3, "cosine"),
        ("plateau", "cnn_eight", data384, ds, 1e-3, "plateau"),
        ("auxin", "cnn_eight_auxin", data384, ds, 1e-3, None),
        ("msfront", "cnn_eight_ms", data384, ds, 1e-3, None),
    ]
    only = {t for t in args.only.split(",") if t}
    recs = []
    for tag, name, data, dsx, lr, sched in runs:
        if only and tag not in only:
            continue
        recs.append(run_one(tag, name, data, dsx, u_lid, ep, lr, sched, out_dir, log,
                            args.device))
        write_summary(out_dir, ep, recs, args.device)

    if not only or "g192" in only:
        ds192_full = downsample(ds, 2)
        train192 = downsample(train_ds, 2)
        data192 = tr.prepare_inputs(train192, PRESETS["cnn_eight"], u_lid=u_lid)
        recs.append(run_one("g192", "cnn_eight", data192, ds192_full, u_lid, ep, 1e-3, None,
                            out_dir, log, args.device))

    write_summary(out_dir, ep, recs, args.device)
    log(f"done -> {out_dir}/summary.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
