#!/usr/bin/env python
"""Flagship physics validation on the card: the port's counterpart of
``scripts/validate_tpu.py`` and of every run of ``scripts/r5_validate.py``
(the BC-closure controls on the tangential and bounce-back walls, the
re-measured rollup rows, the fine-interval runs and BASELINE config 3,
``re10000_1024_mrt_les``).

Each run goes through ``simulate(backend="auto")`` in float32 to its step
cap (``re1000_512_bb`` on the push kernel, ``cuda-push``), and its record
keeps the JAX scripts' keys, with the route taken
(``backend``), the card, and the JAX package's record of the same run
beside it (``jax_r2_ux``, ``jax_l2_pct``: ``docs/artifacts/validation.json``
and ``validation_r5.json``).  A run passes when it comes within
``R2_TOL`` in R2(Ux) and ``L2_TOL_PCT`` points of L2 of the JAX record;
the script exits 1 when any run misses.  For config 3 the R2/L2 at each
report interval is printed and kept (``history``) beside the JAX run's
metrics log, for the record: Re=10^4 is chaotic in float32.  No plots:
the card's machine has no matplotlib.

Usage (from the repository root, one card visible; names pick runs):

    python scripts/torch_validate.py [re1000_512_mrt ...]

Writes ``docs/artifacts/torch/validation.json`` (a run's record replaces
an earlier one of the same name); each run's directory, with its metrics
log, goes under ``docs/artifacts/torch/runs/validation/`` (git-ignored).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate  # noqa: E402

ART = os.path.join(ROOT, "docs", "artifacts")
OUT = os.path.join(ART, "torch", "validation.json")
RUNS_DIR = os.path.join(ART, "torch", "runs", "validation")
# The JAX package's records: the validate_tpu runs, config 3, and config 3's
# per-interval metrics.
JAX_RECORDS = (os.path.join(ART, "validation.json"), os.path.join(ART, "validation_r5.json"))
JAX_HISTORY = {"re10000_1024_mrt_les": os.path.join(
    ART, "re10000_1024_mrt_les", "re10000_1024_mrt_les_metrics.jsonl")}

# Within this much of the JAX record: |d R2(Ux)| and |d L2| in points.
R2_TOL = 1e-3
L2_TOL_PCT = 0.5

RUNS = [
    # (name, nx, Re, collision, turbulence, boundary, max_steps, report_interval)
    # scripts/validate_tpu.py:22-29, each at its 100 000-step interval
    ("re1000_512_mrt", 512, 1000.0, "mrt", "none", "nebb", 1_500_000, 100_000),
    ("re3200_384_mrt", 384, 3200.0, "mrt", "none", "nebb", 4_000_000, 100_000),
    ("re5000_384_mrt_les", 384, 5000.0, "mrt", "smagorinsky", "nebb", 1_500_000, 100_000),
    # scripts/r5_validate.py:50-72, each with its own cap and interval.
    # A. BC-closure controls at the Re=1000 flagship
    ("re1000_512_tang", 512, 1000.0, "mrt", "none", "nebb_tangential",
     4_000_000, 100_000),
    ("re1000_512_bb", 512, 1000.0, "mrt", "none", "bounce_back",
     1_500_000, 100_000),
    # B. the rollup rows re-measured under the current harness
    ("re3200_384_mrt_les", 384, 3200.0, "mrt", "smagorinsky", "nebb",
     2_000_000, 200_000),
    ("re3200_384_srt_les", 384, 3200.0, "srt", "smagorinsky", "nebb",
     2_000_000, 200_000),
    ("re400_192_srt", 192, 400.0, "srt", "none", "nebb",
     1_600_000, 200_000),
    # C. the convergence-gate runs (fine report interval)
    ("re1000_512_mrt_fine", 512, 1000.0, "mrt", "none", "nebb",
     4_000_000, 10_000),
    ("re3200_384_mrt_fine", 384, 3200.0, "mrt", "none", "nebb",
     8_000_000, 10_000),
    # D. BASELINE config 3: plain Smagorinsky
    ("re10000_1024_mrt_les", 1024, 10000.0, "mrt", "smagorinsky", "nebb",
     3_000_000, 150_000),
]


def jax_records() -> dict:
    """The JAX package's validation records by name."""
    rows = {}
    for path in JAX_RECORDS:
        with open(path) as fh:
            rows.update((r["name"], r) for r in json.load(fh))
    return rows


def read_history(path: str) -> dict:
    """step -> (R2(Ux), L2) of a metrics log's interval records."""
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return {r["step"]: (r["r2_ux"], r["l2"]) for r in recs
            if not r.get("final") and "r2_ux" in r}


def run(name, nx, re, collision, turbulence, boundary, max_steps, interval,
        out_root=RUNS_DIR, device="cuda") -> dict:
    """One run to its step cap on ``device``, its record beside JAX's."""
    cfg = SimConfig(
        nx=nx, ny=nx, reynolds=re, collision=collision, turbulence=turbulence,
        boundary=boundary, precision="float32", max_steps=max_steps,
        report_interval=interval,
    ).validate()
    out_dir = os.path.join(out_root, name)
    metrics = os.path.join(out_dir, f"{name}_metrics.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)      # the log appends: keep this run's alone
    t0 = time.perf_counter()
    s = simulate(cfg, SimOptions(out_dir=out_dir, project=name, save_plots=False,
                                 backend="auto", verbose=True), device=device)
    wall_s = time.perf_counter() - t0
    jax = jax_records()[name]
    rec = {
        "name": name, "grid": nx, "re": re, "collision": collision,
        "turbulence": turbulence, "boundary": boundary, "steps": s.steps,
        "report_interval": interval, "converged": s.converged,
        "r2_ux": s.r2_ux, "l2_pct": 100 * s.l2_combined,
        "mlups": s.mlups, "wall_s": round(wall_s, 1),
        "backend": s.backend, "device": device_name(device),
        "card": card_line() if torch.device(device).type == "cuda" else None,
        "jax_steps": jax["steps"], "jax_r2_ux": jax["r2_ux"], "jax_l2_pct": jax["l2_pct"],
        "d_r2_ux": s.r2_ux - jax["r2_ux"], "d_l2_pct": 100 * s.l2_combined - jax["l2_pct"],
    }
    rec["ok"] = bool(s.steps == jax["steps"] and abs(rec["d_r2_ux"]) <= R2_TOL
                     and abs(rec["d_l2_pct"]) <= L2_TOL_PCT)
    if name in JAX_HISTORY:
        ours, theirs = read_history(metrics), read_history(JAX_HISTORY[name])
        rec["history"] = [
            {"step": step, "r2_ux": r2, "l2": l2,
             "jax_r2_ux": theirs.get(step, (None, None))[0],
             "jax_l2": theirs.get(step, (None, None))[1]}
            for step, (r2, l2) in sorted(ours.items())]
        for h in rec["history"]:
            print(f"  {name} step {h['step']}: R2(Ux) {h['r2_ux']:.6f} (JAX "
                  f"{h['jax_r2_ux']}), L2 {h['l2']:.5f} (JAX {h['jax_l2']})", flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    unknown = only - {r[0] for r in RUNS}
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}; one of {[r[0] for r in RUNS]}")
    print(f"device: {device_name('cuda')}; nvidia-smi: {card_line()}", flush=True)
    rows = []
    if os.path.exists(OUT):
        with open(OUT) as fh:
            rows = json.load(fh)
    records = []
    for spec in RUNS:
        if only and spec[0] not in only:
            continue
        rec = run(*spec)
        records.append(rec)
        rows = [r for r in rows if r["name"] != rec["name"]] + [rec]
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "w") as fh:
            json.dump(rows, fh, indent=1)
    missed = [r["name"] for r in records if not r["ok"]]
    if missed:
        print(f"MISSED the JAX record (|dR2| <= {R2_TOL}, |dL2| <= {L2_TOL_PCT} "
              f"points): {missed}", file=sys.stderr)
        return 1
    print(f"all {len(records)} runs within the JAX records -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
