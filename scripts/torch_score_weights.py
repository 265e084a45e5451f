#!/usr/bin/env python
"""Saved surrogate weights scored against a kept held-out record, without
the dataset: each model's two halves (the port's ``.pt`` or the JAX
package's ``.msgpack``, with their JSON sidecars) predict the seven
held-out Re of ``scripts/torch_train_full.py``'s record
``held_out_truth.npz`` with their own sidecar's scalers (those their
training fitted: JAX's weights JAX's dataset's, the port's the port's),
and every number stands beside the JAX package's record of the same model
(``docs/artifacts/ml_full/summary.json``, then ``ml_full_b/summary.json``)
as ``jax_<key>`` and ``d_<key>``.

Scoring JAX's own weights on the port's truth tells a miss of the port's
trained model apart: if JAX's weights score as in JAX's record, the port's
truth is the same as far as the surrogate sees, and a miss lies in the
training; if they do not, the truth differs.

Usage (from the repository root):

    python scripts/torch_score_weights.py --device cpu
        [--truth docs/artifacts/torch/ml_full/held_out_truth.npz]
        [--weights cnn_nine=docs/artifacts/ml_full/cnn_nine,cnn_ten=docs/artifacts/ml_full_b/cnn_ten]
        [--source jax] [--out docs/artifacts/torch/ml_full/weights_scores.json]

Each run's models are merged into ``--out`` under ``models.<name>.<source>``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

from torch_train_full import beside, jax_record, load_truth, score_saved  # noqa: E402

ART = os.path.join(ROOT, "docs", "artifacts")
JAX_WEIGHTS = {"cnn_nine": os.path.join(ART, "ml_full", "cnn_nine"),
               "cnn_ten": os.path.join(ART, "ml_full_b", "cnn_ten")}
TRUTH = os.path.join(ART, "torch", "ml_full", "held_out_truth.npz")
OUT = os.path.join(ART, "torch", "ml_full", "weights_scores.json")


def _rel(path: str) -> str:
    """``path`` from the repository root where it lies under it."""
    path = os.path.abspath(path)
    return os.path.relpath(path, ROOT) if path.startswith(ROOT + os.sep) else path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--truth", default=TRUTH)
    ap.add_argument("--weights", default=",".join(f"{m}={d}" for m, d in JAX_WEIGHTS.items()),
                    help="model=directory of its saved halves, comma-separated")
    ap.add_argument("--source", default="jax", help="whose weights these are")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    truth = load_truth(args.truth)
    log(f"truth: {len(truth.held)} held-out Re {sorted(truth.held)} from {args.truth}")
    summary = {"models": {}}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            summary = json.load(fh)
    summary["truth"] = _rel(args.truth)
    for item in filter(None, args.weights.split(",")):
        name, _, weights_dir = item.partition("=")
        entry = score_saved(name, weights_dir, truth, log, args.device)
        record = dict(beside(entry, jax_record(name)), weights=_rel(weights_dir),
                      device=args.device)
        summary["models"].setdefault(name, {})[args.source] = record
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=1)
    log(f"done -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
