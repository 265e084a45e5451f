#!/usr/bin/env python
"""Where a validation run's trajectory comes from: one run of
``scripts/torch_validate.py`` or ``scripts/torch_slow_gates.py`` through
several routes and precisions on the card, each interval's R2(Ux), L2 and
mean u printed beside the JAX package's metrics log of the same run.

The plain engine (``torch/float32``) does each float operation as PyTorch
does it on the card, and the kernels are held to it bit for bit;
``torch/float64`` shows how far float32 rounding moves a run.  A route
that leaves the JAX record where the plain engine meets it rounds
otherwise than the reference (PERF.md, section 6).

Usage (from the repository root, one card visible):

    python scripts/torch_validation_precision.py re1000_512_mrt --steps 100000 \\
        --routes cuda-pull/float32,torch/float32,torch/float64

Prints one JSON line per route (``history``: step, r2_ux, l2, mean_u, and
the JAX log's values at that step where the checkout holds the log).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate  # noqa: E402

ART = os.path.join(ROOT, "docs", "artifacts")
# scripts/r5_validate.py:63-64: the one NEBB record of the JAX package's
# XLA engine (not its Pallas kernel) on the TPU.
EXTRA = {"re400_192_srt": dict(nx=192, ny=192, reynolds=400.0, collision="srt",
                               max_steps=1_600_000, report_interval=200_000)}


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_configs() -> dict:
    """name -> SimConfig keywords of every validation run and slow gate."""
    out = dict(EXTRA)
    for name, nx, re, coll, turb, bc, steps, interval in _script("torch_validate").RUNS:
        out[name] = dict(nx=nx, ny=nx, reynolds=re, collision=coll, turbulence=turb,
                         boundary=bc, max_steps=steps, report_interval=interval)
    for name, kwargs, steps, *_ in _script("torch_slow_gates").GATES:
        out[name] = dict(kwargs, max_steps=steps, report_interval=10_000)
    return out


def jax_log(name: str) -> dict:
    """step -> the JAX metrics log's interval record (the last run the log
    holds: the log appends)."""
    path = os.path.join(ART, name, f"{name}_metrics.jsonl")
    if not os.path.exists(path):
        return {}
    out = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if not rec.get("final"):
                out[rec["step"]] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run", choices=sorted(run_configs()))
    ap.add_argument("--steps", type=int, default=None, help="default: the run's cap")
    ap.add_argument("--routes", default="cuda-pull/float32,torch/float64")
    args = ap.parse_args(argv)
    print(f"device: {device_name('cuda')}; nvidia-smi: {card_line()}", flush=True)
    kwargs = run_configs()[args.run]
    if args.steps is not None:
        kwargs["max_steps"] = args.steps
    theirs = jax_log(args.run)
    for route in args.routes.split(","):
        backend, precision = route.split("/")
        cfg = SimConfig(precision=precision, **kwargs).validate()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            s = simulate(cfg, SimOptions(out_dir=tmp, project="run", verbose=False,
                                         backend=backend))
            wall = time.perf_counter() - t0
            with open(os.path.join(tmp, "run_metrics.jsonl")) as fh:
                recs = [json.loads(line) for line in fh]
        history = []
        past = None
        for r in recs:
            if r.get("final"):
                continue
            j = theirs.get(r["step"], {})
            history.append({
                "step": r["step"], "r2_ux": r.get("r2_ux"), "l2": r.get("l2"),
                "mean_u": r["mean_u"],
                "d_mean_u": None if past is None else abs(r["mean_u"] - past) / cfg.u_lid,
                "jax_r2_ux": j.get("r2_ux"), "jax_l2": j.get("l2"),
                "jax_mean_u": j.get("mean_u")})
            past = r["mean_u"]
        print(json.dumps({"run": args.run, "route": route, "backend": s.backend,
                          "steps": s.steps, "converged": s.converged, "wall_s": wall,
                          "r2_ux": s.r2_ux, "l2": s.l2_combined, "history": history}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
