#!/usr/bin/env python
"""Convergence top-up on the card: the port's counterpart of
``scripts/datagen_topup.py``.  It reopens the chunks of
``scripts/torch_datagen_full.py`` that reached the step cap with a cavity
unconverged, restarts each batch from its stored fields and runs it on to
the total budget (3 M steps, the reference's ``maxIt``,
``MRT_GPU_datagen.py:61``) or to convergence, whichever comes first.

The restart, step for step as the JAX script's:

* a short batch is padded to ``--n-cav`` cavities by repeats of its last;
* the lid-density carry is the lid-row density of the stored fields, summed
  over the populations in lattice order (``ops.equilibrium.population_sum``,
  the plain engine's order);
* each cavity's omega is ``dataclasses.replace(cfg, reynolds=Re).omega``,
  rounded to float32;
* every ``--report-interval`` steps through the sweep kernel's runner
  (``kernels.pull.make_sweep_runner``, one CUDA graph replay per interval),
  the observables of the state, then each cavity's f and lid densities
  scaled by 1 / its mean density (in float32), then the per-cavity mean u
  reduced on the host in float64 over both components; the hits count
  from ``mean_past = inf`` at the restart, and the batch stops when each of
  its own cavities has more than ``convergence_hits``;
* the budget is ``min(--extra-steps, --total-cap - steps)``.

The final u is observed from the unpadded fields, and the chunk is written
anew in place with the cumulative ``steps`` and the ``converged`` flags, so
the pass resumes; each chunk is logged to ``<data>/topup.jsonl``.  Re-run
``scripts/torch_datagen_full.py`` after it to assemble the dataset again.

Usage (from the repository root, one card visible):

    python scripts/torch_datagen_topup.py [--data data/ml_full] [--extra-steps 1500000]

``--device cpu`` runs the plain stacked step on the CPU in its place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from latticeboltzmannsimulations_torch import engine  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig, resolve_device  # noqa: E402
from latticeboltzmannsimulations_torch.kernels import pull  # noqa: E402
from latticeboltzmannsimulations_torch.ml import datagen  # noqa: E402
from latticeboltzmannsimulations_torch.ops.equilibrium import population_sum  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--grid", type=int, default=384)
    ap.add_argument("--n-cav", type=int, default=7)
    ap.add_argument("--extra-steps", type=int, default=1_500_000,
                    help="max additional steps per batch this pass")
    ap.add_argument("--total-cap", type=int, default=3_000_000,
                    help="reference-parity cumulative cap (maxIt 3M)")
    ap.add_argument("--report-interval", type=int, default=5_000)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_dir = args.data or os.path.join(root, "data", "ml_full")
    chunk_dir = os.path.join(data_dir, "chunks")

    cfg = SimConfig(
        nx=args.grid, ny=args.grid, reynolds=1000.0, collision="srt",
        turbulence="smagorinsky", precision="float32",
        max_steps=args.extra_steps, report_interval=args.report_interval,
        convergence_tol=args.tol,
    ).validate()

    device = resolve_device(args.device)
    n_cav, nx, ny = args.n_cav, cfg.nx, cfg.ny
    chunk = cfg.report_interval
    runner = pull.make_sweep_runner(cfg, n_cav, chunk, device)

    t0 = time.time()
    log_path = os.path.join(data_dir, "topup.jsonl")
    todo = []
    for fn in sorted(os.listdir(chunk_dir)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(chunk_dir, fn)) as z:
            steps = int(z["steps"])
            conv = z["converged"] if "converged" in z else None
        if steps >= args.total_cap:
            continue
        if conv is not None and bool(np.all(conv)):
            continue
        # a chunk without flags that stopped short of the sweep's cap converged
        if conv is None and steps < 1_500_000:
            continue
        todo.append(fn)
    print(f"{len(todo)} capped chunks to top up", flush=True)

    for fn in todo:
        path = os.path.join(chunk_dir, fn)
        with np.load(path) as z:
            res = z["re"]
            f_c = z["f_final"]          # (b, 9, nx, ny)
            steps0 = int(z["steps"])
        b = len(res)
        pad = n_cav - b
        fb = np.concatenate([f_c, np.repeat(f_c[-1:], pad, 0)]) if pad else f_c
        f = torch.from_numpy(np.ascontiguousarray(
            fb.transpose(1, 0, 2, 3).reshape(9, n_cav * nx, ny))).to(device)
        state = engine.State(f, population_sum(f)[:, 0].contiguous())  # lid-row density carry
        res_pad = np.concatenate([res, np.repeat(res[-1:], pad)])
        omegas = np.array([dataclasses.replace(cfg, reynolds=float(r)).omega
                           for r in res_pad], dtype=np.float32)

        budget = min(args.extra_steps, args.total_cap - steps0)
        mean_past = np.full(n_cav, np.inf)
        hits = np.zeros(n_cav, dtype=int)
        steps = 0
        t_chunk = time.time()
        while steps < budget:
            state = runner(state, omegas)
            steps += chunk
            rho_b, u_b = engine.batched_observables(cfg, engine.unstack_cavities(state, n_cav))
            state = datagen._renormed(state, rho_b)
            mean_u = datagen._mean_u(u_b)
            if not np.all(np.isfinite(mean_u[:b])):
                raise FloatingPointError(f"divergence in top-up of {fn}")
            done = np.abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol
            hits = np.where(done, hits + 1, 0)
            mean_past = mean_u
            if np.all(hits[:b] > cfg.convergence_hits):
                break
        batch = engine.unstack_cavities(state, n_cav)
        own = engine.State(batch.f[:b], batch.rho_lid[:b])
        _, u_b = engine.batched_observables(cfg, own)
        f_out, u_out = own.f.cpu().numpy(), u_b.cpu().numpy()
        run_s = time.time() - t_chunk
        conv = hits[:b] > cfg.convergence_hits
        np.savez_compressed(path, re=res, f_final=f_out, u_final=u_out,
                            steps=steps0 + steps, converged=conv)
        msg = {"chunk": fn, "re_lo": float(res[0]), "extra_steps": steps,
               "total_steps": steps0 + steps,
               "converged": int(conv.sum()), "of": b,
               "elapsed_s": round(time.time() - t0, 1),
               "run_s": round(run_s, 2),
               "write_s": round(time.time() - t_chunk - run_s, 2)}
        print(json.dumps(msg), flush=True)
        with open(log_path, "a") as fh:
            fh.write(json.dumps(msg) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
