#!/usr/bin/env python
"""Fidelity probes on the card: the port's counterpart of
``scripts/probe_fidelity.py``.  The same three float32 runs at u_lid 0.08,
each through ``simulate(backend="auto")`` in 200 000-step intervals:
``re400_192_srt`` (SRT, capped at 1.5 M steps, so 1.6 M in whole
intervals), ``re1000_512_mrt_long`` (MRT, 8 M) and ``re10000_512_mrt_les``
(MRT + Smagorinsky, 3 M).

Each row keeps the JAX script's keys, with the route taken (``backend``),
the card, JAX's ``docs/artifacts/probes.json`` figures beside its own
(``jax_probes_*`` and ``d_probes_*``, shown, never gated) and the gate of
``REFERENCES``: probes.json predates three changes of the JAX harness (the
Re=400 uy station out of the gates, the r4 scoring fixes, and the mass
correction, on by default in both packages), so each gated row is held to
the current JAX record of its configuration, or the nearest one, within
``scripts/torch_validate.py``'s bounds (1e-3 in R2(Ux), 0.5 points of L2).
``re400_192_srt`` is the run ``torch_validate.py`` gates: it must also
equal the port's own ``docs/artifacts/torch/validation.json`` row of that
name exactly (steps, R2(Ux), L2), where that file holds it.  The script
exits 1 when a gated row misses.  No plots: the card's machine has no
matplotlib.

Usage (from the repository root, one card visible):

    python scripts/torch_probe_fidelity.py [--device cuda|cpu]

Writes ``docs/artifacts/torch/probes.json``; each run's directory, with its
metrics log, goes under ``docs/artifacts/torch/runs/validation/`` beside
``torch_validate.py``'s runs (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate  # noqa: E402

# The port's records; the JAX package's records stay where they are.
ART = os.path.join(ROOT, "docs", "artifacts", "torch")
JAX_ART = os.path.join(ROOT, "docs", "artifacts")
JAX_PROBES = os.path.join(JAX_ART, "probes.json")
JAX_RECORD = os.path.join(JAX_ART, "validation_r5.json")

# scripts/torch_validate.py's bounds: |d R2(Ux)| and |d L2| in points.
R2_TOL = 1e-3
L2_TOL_PCT = 0.5
REPORT_INTERVAL = 200_000

RUNS = [
    # name, nx, re, collision, turbulence, u_lid, max_steps
    ("re400_192_srt", 192, 400.0, "srt", "none", 0.08, 1_500_000),
    ("re1000_512_mrt_long", 512, 1000.0, "mrt", "none", 0.08, 8_000_000),
    ("re10000_512_mrt_les", 512, 10000.0, "mrt", "smagorinsky", 0.08, 3_000_000),
]

# Each run's reference: the run of JAX_RECORD it is held to (None: not
# gated), whether the port's own validation record of the same name must
# equal it, and why.
REFERENCES = {
    "re400_192_srt": {
        "jax": "re400_192_srt", "own": True,
        "why": ("validation_r5.json re400_192_srt: the same configuration and the "
                "same 1 600 000 steps (both packages' simulate run whole intervals while "
                "step < max_steps), re-measured under the current harness; "
                "probes.json's row predates the r4 scoring fixes and the mass "
                "correction"),
    },
    "re1000_512_mrt_long": {
        "jax": "re1000_512_mrt_fine", "own": False,
        "why": ("validation_r5.json re1000_512_mrt_fine, the nearest current-harness "
                "JAX record: same grid, Re, operator, u_lid, walls and mass "
                "correction, at a 10 000-step interval to 4 M steps, not 200 000 to "
                "8 M; RESULTS.md records L2 flat from 1.2 M to 8 M steps under mass "
                "correction. probes.json's 2.748 % is the drift without it"),
    },
    "re10000_512_mrt_les": {
        "jax": None, "own": False,
        "why": ("not gated: no JAX record of this configuration was made under the "
                "current harness; probes.json's row predates the r4 scoring fixes "
                "and the mass correction, so its deltas are shown only"),
    },
}


def _rows_by_name(path: str) -> dict:
    """A record's rows by name; none where the file is absent."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return {r["name"]: r for r in json.load(fh)}


def gate(row: dict, jax_record: dict, own_record: dict) -> dict:
    """``row``'s reference fields and verdict: within the bounds of the JAX
    record ``REFERENCES`` names (the same steps where the reference is the
    same run), and equal to the port's own validation record of the same
    name where the reference asks for it and ``own_record`` holds it."""
    ref = REFERENCES[row["name"]]
    out = {"reference": ref["why"], "ref_run": ref["jax"], "ref_steps": None,
           "ref_r2_ux": None, "ref_l2_pct": None, "ok": None}
    if ref["jax"] is None:
        return out
    jax = jax_record[ref["jax"]]
    out.update(ref_steps=jax["steps"], ref_r2_ux=jax["r2_ux"], ref_l2_pct=jax["l2_pct"],
               d_ref_r2_ux=row["r2_ux"] - jax["r2_ux"],
               d_ref_l2_pct=row["l2_pct"] - jax["l2_pct"])
    ok = abs(out["d_ref_r2_ux"]) <= R2_TOL and abs(out["d_ref_l2_pct"]) <= L2_TOL_PCT
    if ref["jax"] == row["name"]:
        ok = ok and row["steps"] == jax["steps"]
    if ref["own"] and row["name"] in own_record:
        own = own_record[row["name"]]
        out["own_validation"] = {k: own[k] for k in ("steps", "r2_ux", "l2_pct")}
        out["own_equal"] = all(row[k] == own[k] for k in ("steps", "r2_ux", "l2_pct"))
        ok = ok and out["own_equal"]
    out["ok"] = bool(ok)
    return out


def run(name, nx, re, collision, turbulence, u_lid, max_steps,
        interval=None, out_root=None, device="cuda") -> dict:
    """One probe run to its step cap on ``device`` (every ``interval``
    steps, by default ``REPORT_INTERVAL``; under ``out_root``, by default
    the port's validation runs), with the JAX script's keys, the route and
    the card."""
    cfg = SimConfig(
        nx=nx, ny=nx, reynolds=re, collision=collision, turbulence=turbulence,
        u_lid=u_lid, precision="float32", max_steps=max_steps,
        report_interval=interval or REPORT_INTERVAL,
    ).validate()
    out_dir = os.path.join(out_root or os.path.join(ART, "runs", "validation"), name)
    metrics = os.path.join(out_dir, f"{name}_metrics.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)      # the log appends: keep this run's alone
    t0 = time.perf_counter()
    s = simulate(cfg, SimOptions(out_dir=out_dir, project=name, save_plots=False,
                                 backend="auto", verbose=True), device=device)
    row = {
        "name": name, "grid": nx, "re": re, "u_lid": u_lid,
        "steps": s.steps, "converged": s.converged,
        "r2_ux": s.r2_ux, "l2_pct": 100 * s.l2_combined,
        "wall_s": round(time.perf_counter() - t0, 1),
        "mlups": s.mlups, "backend": s.backend, "device": device_name(device),
        "card": card_line() if str(device).startswith("cuda") else None,
    }
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(f"device: {device_name('cuda')}; nvidia-smi: {card_line()}", flush=True)
    jax_probes = _rows_by_name(JAX_PROBES)
    jax_record = _rows_by_name(JAX_RECORD)
    rows = []
    for spec in RUNS:
        row = run(*spec, device=args.device)
        theirs = jax_probes.get(row["name"])
        if theirs is not None:
            row.update(jax_probes_steps=theirs["steps"], jax_probes_r2_ux=theirs["r2_ux"],
                       jax_probes_l2_pct=theirs["l2_pct"],
                       d_probes_r2_ux=row["r2_ux"] - theirs["r2_ux"],
                       d_probes_l2_pct=row["l2_pct"] - theirs["l2_pct"])
        # the port's own validation record as it stands now (on the card,
        # written by torch_validate.py earlier in the same call)
        row.update(gate(row, jax_record, _rows_by_name(os.path.join(ART, "validation.json"))))
        rows.append(row)
        print(json.dumps(row), flush=True)
        os.makedirs(ART, exist_ok=True)
        with open(os.path.join(ART, "probes.json"), "w") as fh:
            json.dump(rows, fh, indent=1)
    missed = [r["name"] for r in rows if r["ok"] is False]
    if missed:
        print(f"MISSED the reference (|dR2| <= {R2_TOL}, |dL2| <= {L2_TOL_PCT} points; "
              f"re400_192_srt also equal to the port's validation record): {missed}",
              file=sys.stderr)
        return 1
    print(f"gated rows within their references -> {os.path.join(ART, 'probes.json')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
