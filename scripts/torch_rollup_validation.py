#!/usr/bin/env python
"""The port's validation rollup: the counterpart of
``scripts/rollup_validation.py``, a pure aggregation that needs no card.

Each run directory that ``scripts/torch_validate.py`` and
``scripts/torch_probe_fidelity.py`` leave under
``docs/artifacts/torch/runs/validation/re*/`` carries a
``<name>_metrics.jsonl`` whose last row is the run's final record
(``final: true``).  Each row of the rollup is that record with the JAX
script's rounding (R2 5 places, L2 % 3, MLUPS 1) and notes, the route
and the card (beside the MLUPS) of the run's row of the same name in
``validation.json`` or ``probes.json`` beside the runs, and JAX's
``docs/artifacts/validation_rollup.json`` row of the same run beside it
(``jax_*``, ``d_*``).  ``port`` is the run's directory under
``docs/artifacts/torch``.  JAX's rows that no script made (``NO_SCRIPT``,
ad-hoc command-line runs) are listed with ``"port": null``.

Usage:  python scripts/torch_rollup_validation.py

Writes ``docs/artifacts/torch/validation_rollup.json``.
"""

from __future__ import annotations

import glob
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's records; the JAX package's rollup stays where it is.
ART = os.path.join(ROOT, "docs", "artifacts", "torch")
JAX_ROLLUP = os.path.join(ROOT, "docs", "artifacts", "validation_rollup.json")

# scripts/rollup_validation.py's notes.
NOTES = {
    "re1000_512_tang": "BC-closure control: Zou-He tangential lid "
                       "(boundary=nebb_tangential); see RESULTS.md",
    "re1000_512_bb": "BC-closure control: halfway bounce-back walls; "
                     "see RESULTS.md",
}

# JAX's rollup rows that no script of the JAX package makes.
NO_SCRIPT = ("re1000_512_mrt_ma004", "re1000_512_mrt_mc", "re1000_512_mrt_mc004",
             "re3200_384_mrt_fixed", "re400_384_mrt", "re7500_512_mrt_les")
NO_SCRIPT_WHY = ("an ad-hoc command-line run of the JAX package: no script of it "
                 "makes this run, so the port has none to reproduce")


def rollup(runs_dir: str) -> list:
    """``scripts/rollup_validation.py``'s rows over ``runs_dir``: the last
    line of each ``re*/*_metrics.jsonl`` where it is a final record."""
    rows = []
    for path in sorted(glob.glob(os.path.join(runs_dir, "re*", "*_metrics.jsonl"))):
        name = os.path.basename(os.path.dirname(path))
        with open(path) as fh:
            lines = [ln for ln in fh.read().splitlines() if ln.strip()]
        if not lines:
            continue
        rec = json.loads(lines[-1])
        if not rec.get("final"):
            continue
        row = {
            "run": name,
            "steps": int(rec["step"]),
            "r2_ux": round(float(rec["r2_ux"]), 5),
            "l2_pct": round(100.0 * float(rec["l2"]), 3),
            "mlups": round(float(rec["mlups"]), 1),
        }
        if name in NOTES:
            row["note"] = NOTES[name]
        rows.append(row)
    return rows


def run_records(art: str) -> dict:
    """The rows of ``validation.json`` and ``probes.json`` in ``art`` by run
    name (a probe's row over a validation row of the same name: the later
    script of a card call); none where a file is absent."""
    out = {}
    for record in ("validation.json", "probes.json"):
        path = os.path.join(art, record)
        if os.path.exists(path):
            with open(path) as fh:
                out.update({r["name"]: r for r in json.load(fh)})
    return out


def beside_jax(rows: list, jax_rows: list, art: str) -> list:
    """``rows`` each beside JAX's row of the same run, with the route and
    card of the port's record of that run in ``art``, then JAX's rows with
    no script behind them, in run order."""
    jax = {r["run"]: r for r in jax_rows}
    records = run_records(art)
    out = []
    for row in rows:
        name = row["run"]
        record = records.get(name, {})
        full = {**row, "port": os.path.join("runs", "validation", name),
                "backend": record.get("backend"), "card": record.get("card")}
        theirs = jax.get(name)
        if theirs is not None:
            full.update(jax_steps=theirs["steps"], jax_r2_ux=theirs["r2_ux"],
                        jax_l2_pct=theirs["l2_pct"], jax_mlups=theirs["mlups"],
                        d_steps=row["steps"] - theirs["steps"],
                        d_r2_ux=round(row["r2_ux"] - theirs["r2_ux"], 5),
                        d_l2_pct=round(row["l2_pct"] - theirs["l2_pct"], 3))
        out.append(full)
    ours = {r["run"] for r in rows}
    for name in NO_SCRIPT:
        if name in jax and name not in ours:
            theirs = jax[name]
            out.append({"run": name, "port": None, "why": NO_SCRIPT_WHY,
                        "jax_steps": theirs["steps"], "jax_r2_ux": theirs["r2_ux"],
                        "jax_l2_pct": theirs["l2_pct"], "jax_mlups": theirs["mlups"]})
    return sorted(out, key=lambda r: r["run"])


def main(art: str | None = None) -> int:
    """The rollup of the runs under ``art`` (by default ``ART``) into
    ``<art>/validation_rollup.json``."""
    art = art or ART
    with open(JAX_ROLLUP) as fh:
        jax_rows = json.load(fh)
    rows = beside_jax(rollup(os.path.join(art, "runs", "validation")), jax_rows, art)
    out = os.path.join(art, "validation_rollup.json")
    os.makedirs(art, exist_ok=True)
    with open(out, "w") as fh:
        json.dump(rows, fh, indent=1)
        fh.write("\n")
    n_port = sum(r["port"] is not None for r in rows)
    print(f"{out}: {n_port} runs of the port, {len(rows) - n_port} of JAX's with no script")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
