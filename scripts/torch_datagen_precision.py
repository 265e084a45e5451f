#!/usr/bin/env python
"""How the sweep's convergence gate reads a chunk's last bits: one chunk of
``scripts/torch_datagen_full.py`` (7 cavities at 384^2, SRT + Smagorinsky,
float32) run as ``--variants`` copies at once, copy k (from
``--first-ulp``) with each cavity's float32 omega moved by k units in the
last place (a relative change of viscosity under 1e-6 per unit; copy 0 is
the chunk itself), all copies
stacked in one batch of ``ml.generate_dataset`` (the sweep kernel on the
card).  Each cavity's mean u is read at every check from the sweep's own
loop (``datagen._mean_u``), and the datagen rule
(``convergence_hits`` + 1 checks in a row under ``--tol`` for every cavity
of a copy) gives each copy's stop: in the sweep, by ``--sweep-cap``; else
in the top-up (``scripts/torch_datagen_topup.py``: its hits counted afresh
from the sweep's cap, the restart's ``mean_past`` infinite), by
``--steps``.  A copy that has not stopped by then reports how many of its
cavities had converged at the last check, as a capped chunk does.  (The
top-up rebuilds the lid carry from the stored fields; here the trajectory
runs on, a last-bit difference of the same kind.)

Where the copies of a chunk stop far apart, the gate's stopping step is
set by the last bits of the arithmetic, and the spread says how closely
another arithmetic (the TPU's) can be held to it.

Usage (from the repository root, one card visible):

    python scripts/torch_datagen_precision.py --chunks 310,940 --steps 1000000

Writes ``--out`` (``docs/artifacts/torch/datagen_precision.json``): per
chunk (its first Re, and ``+<first ulp>`` unless that is 0), JAX's record of it, each copy's omegas, sweep stop, final stop or
converged count at ``--steps``, each cavity's median |d mean u| / u_lid
over the copy's last quarter before its stop, and the trace of the copy's
largest |d mean u| / u_lid at each check (log10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.ml import datagen  # noqa: E402

OUT = os.path.join(ROOT, "docs", "artifacts", "torch", "datagen_precision.json")
JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "ml_full", "dataset_metadata.json")


def shifted_re(cfg: SimConfig, re: float, k: int) -> float:
    """The Reynolds number whose omega, rounded to float32, is ``re``'s
    moved by ``k`` units in the last place (``re`` itself for 0)."""
    if k == 0:
        return float(re)
    om = np.float32(dataclasses.replace(cfg, reynolds=float(re)).omega)
    for _ in range(abs(k)):
        om = np.nextafter(om, np.float32(2.0 if k > 0 else 0.0))
    shifted = cfg.u_lid * cfg.ny * 6.0 / (2.0 / float(om) - 1.0)   # omega = 2 / (6 nu + 1)
    if np.float32(dataclasses.replace(cfg, reynolds=shifted).omega) != om:
        raise ValueError(f"no Reynolds number gives omega {om!r} near {re}")
    return shifted


def gate(trace: np.ndarray, cfg: SimConfig, sweep_cap: int) -> dict:
    """The datagen rule over one copy's per-check mean u (``trace (checks,
    cavities)``, a check every ``cfg.report_interval`` steps): the sweep's
    stop by ``sweep_cap``, else the top-up's (hits afresh after the cap),
    else the cavities converged at the last check."""
    ri, hits_needed = cfg.report_interval, cfg.convergence_hits
    mean_past = np.full(trace.shape[1], np.inf)
    hits = np.zeros(trace.shape[1], dtype=int)
    d_all = []
    for i, mean_u in enumerate(trace):
        step = (i + 1) * ri
        d = np.abs(mean_u - mean_past) / cfg.u_lid
        d_all.append(d)
        hits = np.where(d < cfg.convergence_tol, hits + 1, 0)
        mean_past = mean_u
        if np.all(hits > hits_needed):
            kind = "sweep" if step <= sweep_cap else "topup"
            return {"stop": step, "stopped_in": kind, "converged": int(len(hits)),
                    "d": np.array(d_all)}
        if step == sweep_cap:             # the top-up restarts its count
            mean_past = np.full(trace.shape[1], np.inf)
            hits = np.zeros(trace.shape[1], dtype=int)
    return {"stop": None, "stopped_in": None, "converged": int((hits > hits_needed).sum()),
            "d": np.array(d_all)}


def run_chunk(cfg: SimConfig, res: np.ndarray, ulps: range, sweep_cap: int, device) -> dict:
    """A copy of the chunk ``res`` for each of ``ulps`` through one
    ``generate_dataset`` batch, each copy gated on its own."""
    re_all = np.array([shifted_re(cfg, r, k) for k in ulps for r in res])
    trace = []
    plain = datagen._mean_u

    def read(u):
        trace.append(plain(u))
        return trace[-1]

    datagen._mean_u = read
    t0 = time.perf_counter()
    try:
        datagen.generate_dataset(cfg, re_all, batch_size=len(re_all), device=device)
    finally:
        datagen._mean_u = plain
    wall = time.perf_counter() - t0
    trace = np.array(trace)
    n = len(res)
    copies = []
    for i, k in enumerate(ulps):
        g = gate(trace[:, i * n:(i + 1) * n], cfg, sweep_cap)
        d = g.pop("d")[1:]                    # the first check has no predecessor
        d[~np.isfinite(d)] = np.nan           # the top-up's first check has none either
        upto = d[:(g["stop"] or len(trace) * cfg.report_interval) // cfg.report_interval - 1]
        tail = upto[-max(1, len(upto) // 4):]
        copies.append({
            "ulps": k,
            "omega": [float(np.float32(dataclasses.replace(cfg, reynolds=r).omega))
                      for r in re_all[i * n:(i + 1) * n]],
            **g, "tail_median": np.nanmedian(tail, axis=0).tolist(),
            "worst_log10": [None if np.isnan(v) else v for v in
                            np.round(np.log10(np.maximum(d.max(axis=1), 1e-30)), 3).tolist()]})
    return {"steps_run": len(trace) * cfg.report_interval, "wall_s": round(wall, 2),
            "copies": copies}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="310,940")
    ap.add_argument("--variants", type=int, default=8)
    ap.add_argument("--first-ulp", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1_500_000)
    ap.add_argument("--sweep-cap", type=int, default=1_500_000)
    ap.add_argument("--grid", type=int, default=384)
    ap.add_argument("--n-cav", type=int, default=7)
    ap.add_argument("--report-interval", type=int, default=5_000)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = SimConfig(nx=args.grid, ny=args.grid, reynolds=1000.0, collision="srt",
                    turbulence="smagorinsky", precision="float32", max_steps=args.steps,
                    report_interval=args.report_interval,
                    convergence_tol=args.tol).validate()
    with open(JAX_RECORD) as fh:
        jax = {c["re_lo"]: c for c in json.load(fh)["chunks"]}
    card = card_line() if args.device == "cuda" else None
    print(f"device: {device_name(args.device)}; nvidia-smi: {card}", flush=True)
    out = {"card": card, "report_interval": args.report_interval, "tol": args.tol,
           "convergence_hits": cfg.convergence_hits, "chunks": {}}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            out["chunks"] = json.load(fh).get("chunks", {})
    for lo in (float(c) for c in args.chunks.split(",") if c):
        res = np.arange(lo, min(lo + args.n_cav * 10.0, 5100.0), 10.0)
        rec = {"re": res.tolist(), "variants": args.variants, "sweep_cap": args.sweep_cap,
               "steps": args.steps}
        if lo in jax:
            rec["jax"] = {k: jax[lo][k] for k in ("steps", "converged", "of")}
        ulps = range(args.first_ulp, args.first_ulp + args.variants)
        rec.update(run_chunk(cfg, res, ulps, args.sweep_cap, args.device))
        out["chunks"][f"{lo:g}" + (f"+{args.first_ulp}" if args.first_ulp else "")] = rec
        print(f"chunk Re {lo:g}..{res[-1]:g}: JAX {rec.get('jax')}; {args.variants} copies "
              f"(omega +k ulps) stop at "
              f"{[(c['stop'], c['stopped_in']) if c['stop'] else ('capped', c['converged']) for c in rec['copies']]}; "
              f"{rec['steps_run']} steps in {rec['wall_s']} s", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
