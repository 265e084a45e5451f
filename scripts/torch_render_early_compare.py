#!/usr/bin/env python
"""Render truth-against-prediction figures for the early-preset runs: the
port's counterpart of ``scripts/render_early_compare.py``.  For each
``<model>_<grid>`` directory under ``--out`` that holds x weights (the
port's ``.pt`` or the JAX package's ``.msgpack``, read by
``ml.train.load_weights``), one forward pass at Re 5000 on the CPU and a
three-panel figure (the LBM u_x, the prediction, the error) beside the
weights as ``<model>_predict_re5000.png``; each relative L2 is printed.

Like the JAX script it runs on the CPU only: the figures need matplotlib,
which the card's machine does not have.  ``--data`` names the dataset (the
JAX script reads ``data/ml_full``).

Usage: python scripts/torch_render_early_compare.py [--out docs/artifacts/torch/ml_early] [--data data/ml_full]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

from latticeboltzmannsimulations_torch.ml import datagen, predict, train as tr  # noqa: E402
from torch_train_full import downsample  # noqa: E402

EVAL_RE = 5000.0


def main(argv=None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="artifact root to scan (default docs/artifacts/torch/ml_early)")
    ap.add_argument("--data", default=None)
    args = ap.parse_args(argv)
    data_dir = args.data or os.path.join(ROOT, "data", "ml_full")
    out_root = args.out or os.path.join(ROOT, "docs", "artifacts", "torch", "ml_early")

    ds384 = datagen.load_dataset(data_dir)
    ds192 = downsample(ds384, 2)
    i_eval = int(np.argwhere(ds384.re_range == EVAL_RE)[0, 0])
    meta_path = os.path.join(data_dir, "metadata.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    u_lid = meta.get("u_lid", 0.08)

    for entry in sorted(os.listdir(out_root)):
        mdir = os.path.join(out_root, entry)
        if not os.path.isdir(mdir):
            continue
        name, grid_tag = entry.rsplit("_", 1)
        ds = ds384 if grid_tag == "384" else ds192
        stem = os.path.join(mdir, f"{name}_x")
        if not any(os.path.exists(stem + ext) for ext in (".pt", ".msgpack")):
            print(f"  {entry}: no weights, skipping")
            continue
        params, meta_x = tr.load_weights(name, "x", mdir)
        scalers = meta_x.get("scalers", {})
        fnet, aux = predict.build_input(name, EVAL_RE, ds.feq_initial, scalers, u_lid=u_lid)
        u_cnn = predict.predict_velocity(name, params, params, fnet, aux, scalers,
                                         device="cpu")
        ux_cnn = u_cnn[0]
        ux_true = np.asarray(ds.u_final[i_eval, 0])
        rel_l2 = float(np.linalg.norm(ux_cnn - ux_true) / np.linalg.norm(ux_true))

        fig, axes = plt.subplots(1, 3, figsize=(13, 4.2), constrained_layout=True)
        vmax = float(np.abs(ux_true).max())
        for ax, field, title in (
            (axes[0], ux_true, f"LBM ux (Re={EVAL_RE:.0f}, held out)"),
            (axes[1], ux_cnn, f"{name} prediction"),
        ):
            im = ax.imshow(field.T, origin="upper", cmap="RdBu_r", vmin=-vmax, vmax=vmax)
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.85)
        im = axes[2].imshow(np.abs(ux_cnn - ux_true).T, origin="upper", cmap="magma")
        axes[2].set_title(f"|error|  (relL2 {rel_l2:.3f})")
        fig.colorbar(im, ax=axes[2], shrink=0.85)
        for ax in axes:
            ax.set_xticks([])
            ax.set_yticks([])
        path = os.path.join(mdir, f"{name}_predict_re{EVAL_RE:.0f}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        print(f"  {entry}: relL2(ux) {rel_l2:.4f} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
