#!/usr/bin/env python
"""The surrogate pipeline end to end on the card, in one pass at 192^2: the
port's counterpart of ``scripts/ml_demo_tpu.py``, with its configuration.

1. datagen: 48 cavities, Re 100..5000, SRT + Smagorinsky, float32, in
   batches of 24 stacked through the sweep kernel (``ml.generate_dataset``),
   a 120 000-step cap, checked every 5 000 steps (tol 1e-7, 3 hits);
2. training: ``cnn_eight`` for x and y, 500 epochs, batch 8 (TF32 off);
3. prediction at the unseen Re = 1000 against a fresh LBM solution
   (``ml.predict.lbm_reference``, the CUDA pull kernel, a 200 000-step cap)
   and Ghia.

Writes ``docs/artifacts/torch/ml_demo/``: the dataset (``data/``), the
weights (``cnn_eight_{x,y}.pt`` and their sidecars), the loss and
comparison figures where matplotlib is installed, and ``metrics.json``
with JAX's record (``docs/artifacts/ml_demo/metrics.json``) beside each
number (``jax_*``).  The LBM solution must land within ``R2_TOL`` in
R2(Ux) and ``L2_TOL`` in L2 of JAX's; the surrogate, whose initial weights
are not JAX's, must reach ``R2_CNN_MIN`` and ``CNN_VS_LBM_MAX``.  The exit
code is 1 when one misses.

Usage (from the repository root, one card visible):

    python scripts/torch_ml_demo.py
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.kernels import pull  # noqa: E402
from latticeboltzmannsimulations_torch.ml import (  # noqa: E402
    PRESETS, generate_dataset, save_dataset,
)
from latticeboltzmannsimulations_torch.ml import predict as ml_predict  # noqa: E402
from latticeboltzmannsimulations_torch.ml import train as ml_train  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(REPO, "docs", "artifacts", "torch", "ml_demo")
JAX_METRICS = os.path.join(REPO, "docs", "artifacts", "ml_demo", "metrics.json")

R2_TOL = 1e-3
L2_TOL = 5e-3            # 0.5 points of L2
R2_CNN_MIN = 0.95
CNN_VS_LBM_MAX = 0.35


def gates(metrics: dict, jax: dict) -> list:
    """The bounds ``metrics`` misses, as text."""
    missed = []
    if abs(metrics["r2_lbm_ux"] - jax["r2_lbm_ux"]) > R2_TOL:
        missed.append(f"r2_lbm_ux {metrics['r2_lbm_ux']} vs JAX {jax['r2_lbm_ux']}")
    if abs(metrics["l2_lbm"] - jax["l2_lbm"]) > L2_TOL:
        missed.append(f"l2_lbm {metrics['l2_lbm']} vs JAX {jax['l2_lbm']}")
    if metrics["r2_cnn_ux"] < R2_CNN_MIN:
        missed.append(f"r2_cnn_ux {metrics['r2_cnn_ux']} < {R2_CNN_MIN}")
    if metrics["cnn_vs_lbm_l2"] > CNN_VS_LBM_MAX:
        missed.append(f"cnn_vs_lbm_l2 {metrics['cnn_vs_lbm_l2']} > {CNN_VS_LBM_MAX}")
    return missed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device
    os.makedirs(OUT, exist_ok=True)
    figures = importlib.util.find_spec("matplotlib") is not None
    card = card_line() if device == "cuda" else None
    print(f"device: {device_name(device)}; nvidia-smi: {card}; figures: {figures}", flush=True)
    t0 = time.perf_counter()

    # --- datagen: 48 cavities, Re 100..5000, in batches of 24 ---------------
    # 192^2: cnn_eight's stride pyramid divides 192 (models.check_grid)
    cfg = SimConfig(
        nx=192, ny=192, reynolds=100.0, collision="srt",
        turbulence="smagorinsky", precision="float32",
        max_steps=120_000, report_interval=5_000,
        convergence_tol=1e-7, convergence_hits=3,
    ).validate()
    re_values = np.linspace(100.0, 5000.0, 48)
    sweep0 = pull.sweep_launches
    ds = generate_dataset(cfg, re_values, batch_size=24, progress=print, device=device)
    sweep_launches = pull.sweep_launches - sweep0
    save_dataset(ds, os.path.join(OUT, "data"))
    t1 = time.perf_counter()
    print(f"datagen: {len(re_values)} cavities in {t1 - t0:.1f}s, "
          f"{sweep_launches} pull_sweep_step launches")

    # --- train cnn_eight (reduced epochs for the demo) ----------------------
    preset = PRESETS["cnn_eight"]
    data = ml_train.prepare_inputs(ds, preset, u_lid=cfg.u_lid)
    results = {}
    for comp in ("x", "y"):
        res = ml_train.train("cnn_eight", data, component=comp,
                             epochs=500, batch_size=8, verbose=False, device=device)
        ml_train.save_weights(res, OUT, scalers=data.scalers)
        if figures:
            ml_train.plot_history(res.history, os.path.join(OUT, f"cnn_eight_{comp}_loss.png"))
        results[comp] = res
        print(f"train[{comp}]: final val MSE {res.history['val_loss'][-1]:.3e}")
    t2 = time.perf_counter()

    # --- predict at an unseen Re and compare with LBM + Ghia ----------------
    re_test = 1000.0
    fnet, aux = ml_predict.build_input(
        "cnn_eight", re_test, ds.feq_initial, data.scalers, u_lid=cfg.u_lid)
    u_cnn = ml_predict.predict_velocity(
        "cnn_eight", results["x"].params, results["y"].params,
        fnet, aux, data.scalers, device=device)
    cfg_ref = SimConfig(nx=192, ny=192, reynolds=re_test, collision="srt",
                        turbulence="smagorinsky", precision="float32",
                        max_steps=200_000, report_interval=10_000).validate()
    pull0 = pull.launches
    t3 = time.perf_counter()
    u_lbm = ml_predict.lbm_reference(cfg_ref, device=device)
    lbm_s = time.perf_counter() - t3
    pull_launches = pull.launches - pull0
    if figures:
        metrics = ml_predict.comparison_figure(
            cfg_ref, u_lbm, u_cnn, os.path.join(OUT, f"cnn8_predict_Re{re_test:g}.png"))
    else:
        metrics = dict(ml_predict.comparison_metrics(cfg_ref, u_lbm, u_cnn), figure=None)
    metrics["train_s"] = round(t2 - t1, 1)
    metrics["datagen_s"] = round(t1 - t0, 1)
    metrics.update(lbm_s=round(lbm_s, 2), pull_sweep_launches=sweep_launches,
                   pull_launches=pull_launches, device=device_name(device), card=card)
    with open(JAX_METRICS) as fh:
        jax = json.load(fh)
    metrics.update({f"jax_{k}": v for k, v in jax.items() if k != "figure"})
    missed = gates(metrics, jax)
    metrics["ok"] = not missed
    print(json.dumps(metrics))
    with open(os.path.join(OUT, "metrics.json"), "w") as fh:
        json.dump(metrics, fh, indent=2)
    if missed:
        print(f"MISSED: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
