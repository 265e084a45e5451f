#!/usr/bin/env python
"""High-Reynolds physics gates on the card: the port's counterpart of
``scripts/slow_gates.py``, with the same four gates, step caps and bounds.

Each gate runs ``simulate`` with ``backend="auto"`` (``cuda-pull`` for the
NEBB and tangential lids, the push oracle for ``bounce_back``) and builds
the JAX script's record, plus the route taken (``backend``) and the JAX
package's record of the same gate (``jax_steps``, ``jax_r2_ux``,
``jax_l2_combined``, from ``docs/artifacts/slow_gates.json``).  Exits 1
when any gate fails.

Usage (from the repository root, one card visible):

    python scripts/torch_slow_gates.py

Writes ``docs/artifacts/torch/slow_gates.json``; each gate's run directory
goes under ``docs/artifacts/torch/runs/slow_gates/`` (git-ignored).
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate  # noqa: E402

JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "slow_gates.json")
OUT = os.path.join(ROOT, "docs", "artifacts", "torch", "slow_gates.json")
RUNS_DIR = os.path.join(ROOT, "docs", "artifacts", "torch", "runs", "slow_gates")

GATES = [
    # (name, cfg kwargs, max_steps, r2_min, l2_max, require_converged), as
    # scripts/slow_gates.py:28-53 has them.  re400 pins the convergence
    # detector end to end: it must stop (tol 1e-7) before the step cap.
    ("re400_256_mrt",
     dict(nx=256, ny=256, reynolds=400.0, collision="mrt",
          convergence_tol=1e-7),
     1_200_000, 0.999, 0.020, True),
    ("re1000_256_mrt",
     dict(nx=256, ny=256, reynolds=1000.0, collision="mrt"),
     1_500_000, 0.999, 0.030, False),
    # the halfway bounce-back wall with the Bouzidi lid, on the push oracle
    ("re100_128_bounce_back",
     dict(nx=128, ny=128, reynolds=100.0, collision="srt",
          boundary="bounce_back"),
     40_000, 0.99, 0.05, False),
    # the Zou-He tangential lid with its corner treatment
    ("re100_128_nebb_tangential",
     dict(nx=128, ny=128, reynolds=100.0, collision="srt",
          boundary="nebb_tangential"),
     40_000, 0.99, 0.05, False),
]


def jax_records() -> dict:
    """The JAX package's gate records by name."""
    with open(JAX_RECORD) as fh:
        return {r["gate"]: r for r in json.load(fh)}


def run_gate(name, kwargs, max_steps, r2_min, l2_max, require_converged,
             out_dir, device="cuda"):
    """One gate through ``simulate(backend="auto")`` on ``device``: the JAX
    script's record, the route, and the JAX record beside it."""
    cfg = SimConfig(precision="float32", max_steps=max_steps,
                    report_interval=10_000, **kwargs).validate()
    summary = simulate(cfg, SimOptions(out_dir=os.path.join(out_dir, name),
                                       verbose=False, metrics_jsonl=False),
                       device=device)
    ok = (summary.r2_ux is not None and summary.r2_ux > r2_min
          and summary.l2_combined < l2_max
          and (summary.converged or not require_converged))
    jax = jax_records().get(name, {})
    rec = {
        "gate": name, "steps": summary.steps,
        "converged": summary.converged,
        "require_converged": require_converged,
        "mlups": round(summary.mlups, 1),
        "r2_ux": round(float(summary.r2_ux), 6),
        "l2_combined": round(float(summary.l2_combined), 5),
        "r2_min": r2_min, "l2_max": l2_max, "ok": bool(ok),
        "backend": summary.backend, "device": device_name(device),
        "jax_steps": jax.get("steps"),
        "jax_r2_ux": jax.get("r2_ux"),
        "jax_l2_combined": jax.get("l2_combined"),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    print(f"device: {device_name('cuda')}; nvidia-smi: {card_line()}", flush=True)
    os.makedirs(RUNS_DIR, exist_ok=True)
    records = [run_gate(*g, RUNS_DIR) for g in GATES]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(records, fh, indent=1)
    failed = [r["gate"] for r in records if not r["ok"]]
    if failed:
        print(f"FAILED gates: {failed}", file=sys.stderr)
        return 1
    print(f"all {len(records)} gates passed -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
