#!/usr/bin/env python
"""Where the 192^2 demo's surrogate leaves its loss plateau: the dataset of
``scripts/torch_ml_demo.py`` (48 cavities, Re 100..5000, through the sweep
kernel), then ``cnn_eight``'s x component trained with the demo's recipe
(500 epochs, batch 8, TF32 off) from each of ``--seeds``' initial weights,
each run's loss history beside the JAX package's record of the demo
(``docs/artifacts/ml_demo/cnn_eight_x.json``).  ``--precision float32`` is
the port's training; ``--precision tpu`` trains with every convolution at
the TPU's default precision, as JAX's demo was trained
(``torch_predict_extrapolate.tpu_conv_precision``: bfloat16 operands,
float32 sums, forward and backward).

A run of this recipe first sits on a plateau near the targets' variance (a
field that does not depend on Re); the epoch at which its training loss
first falls below ``ESCAPE`` says whether and when it left it.

Usage (from the repository root, one card visible):

    python scripts/torch_demo_plateau.py --seeds 0,1,2,3 --precision tpu

Writes ``--out`` (``docs/artifacts/torch/ml_demo/plateau.json``), each
run under ``runs.<precision>.<seed>``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.ml import PRESETS, generate_dataset  # noqa: E402
from latticeboltzmannsimulations_torch.ml import train as ml_train  # noqa: E402
from torch_predict_extrapolate import tpu_conv_precision  # noqa: E402

OUT = os.path.join(ROOT, "docs", "artifacts", "torch", "ml_demo", "plateau.json")
JAX_HISTORY = os.path.join(ROOT, "docs", "artifacts", "ml_demo", "cnn_eight_x.json")
ESCAPE = 1e-3
EPOCHS = 500                              # the demo's (scripts/torch_ml_demo.py)
EPOCHS_SHOWN = (0, 1, 4, 9, 49, 99, 199, 299, 399, 499)


def escape_epoch(loss: list) -> int | None:
    """The first epoch (from 1) whose training loss is below ``ESCAPE``."""
    return next((i + 1 for i, v in enumerate(loss) if v < ESCAPE), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--precision", default="float32", choices=("float32", "tpu"))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    card = card_line() if args.device == "cuda" else None
    print(f"device: {device_name(args.device)}; nvidia-smi: {card}", flush=True)
    cfg = SimConfig(nx=192, ny=192, reynolds=100.0, collision="srt",
                    turbulence="smagorinsky", precision="float32",
                    max_steps=120_000, report_interval=5_000,
                    convergence_tol=1e-7, convergence_hits=3).validate()
    ds = generate_dataset(cfg, np.linspace(100.0, 5000.0, 48), batch_size=24,
                          device=args.device)
    data = ml_train.prepare_inputs(ds, PRESETS["cnn_eight"], u_lid=cfg.u_lid)
    with open(JAX_HISTORY) as fh:
        jax = json.load(fh)["history"]
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            out = json.load(fh)
    out.update({"card": card, "escape_below": ESCAPE, "epochs": EPOCHS,
                "jax": {"escape_epoch": escape_epoch(jax["loss"]),
                        "loss": {e + 1: jax["loss"][e] for e in EPOCHS_SHOWN}}})
    runs = out.setdefault("runs", {}).setdefault(args.precision, {})
    print(f"JAX's record: loss below {ESCAPE} from epoch {out['jax']['escape_epoch']}",
          flush=True)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        with tpu_conv_precision() if args.precision == "tpu" else contextlib.nullcontext():
            res = ml_train.train("cnn_eight", data, component="x", epochs=EPOCHS,
                                 batch_size=8, seed=seed, device=args.device)
        h = res.history
        rec = {"escape_epoch": escape_epoch(h["loss"]), "final_loss": h["loss"][-1],
               "final_val_loss": h["val_loss"][-1], "wall_s": round(time.perf_counter() - t0, 2),
               "loss": {e + 1: h["loss"][e] for e in EPOCHS_SHOWN}}
        runs[str(seed)] = rec
        print(f"{args.precision} seed {seed}: loss below {ESCAPE} from epoch "
              f"{rec['escape_epoch']}; final loss {rec['final_loss']:.3e}, val "
              f"{rec['final_val_loss']:.3e}; {rec['wall_s']} s", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
