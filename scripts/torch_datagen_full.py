#!/usr/bin/env python
"""The full-parity dataset on the card: the port's counterpart of
``scripts/datagen_full.py``, with its command line, chunk files,
``progress.jsonl``, resume and assembly.  500 cavities at 384^2, Re =
100..5090 step 10, SRT + Smagorinsky, float32, each batch of ``--n-cav``
cavities stacked along x through the sweep form of the CUDA pull kernel
(``ml.generate_dataset(..., batch_size=n_cav)`` routes there on the card),
run until every cavity of the batch holds |d mean(u)| / u_lid < ``--tol``
at each ``--report-interval`` (``convergence_hits`` + 1 times running) or
the batch reaches ``--max-steps``.

Each finished batch is written at once to ``<out>/chunks/re<Re0>.npz``
(``re, f_final, u_final, steps, converged, failed``), keyed by its first Re,
and logged to ``<out>/progress.jsonl``, with ``batch_s``, the batch's time
from the end of the one before (or the start: the first includes the
kernels' build and the graphs' capture), and ``write_s``, the time of the
compressed write alone, beside JAX's keys.  A re-run skips the Re values
that a chunk holds.  The batches are consecutive groups of ``--n-cav`` Re
values, run in bit-reversed order; the chunks are then assembled into the
four-array layout (``ml.save_dataset``) with ``metadata.json``.  A batch
runs until all of its cavities converge, so a cavity's result depends on
who shares its batch: ``--re-start R --re-stop R + 70`` (with the default
step and ``--n-cav``) reproduces exactly the batch of the full sweep that
starts at ``R`` when ``R`` is 100 plus a multiple of 70.

Usage (from the repository root, one card visible):

    python scripts/torch_datagen_full.py [--grid 384] [--n-cav 7] [--out data/ml_full]

``--device cpu`` runs the plain batched engine on the CPU in its place.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from latticeboltzmannsimulations_torch import engine  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.ml import datagen  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=384)
    ap.add_argument("--n-cav", type=int, default=7,
                    help="cavities stacked per dispatch (7*384=2688 wide "
                         "stays VMEM-resident on v5e)")
    ap.add_argument("--max-steps", type=int, default=1_500_000)
    ap.add_argument("--report-interval", type=int, default=5_000)
    # The reference datagen's convergence test, |d mean(u)|/uLB < 1e-7 at
    # every check (MRT_GPU_datagen.py:729-733); the framework-wide default,
    # 1e-8, never fires within a practical cap at 384^2.
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--re-start", type=float, default=100.0)
    ap.add_argument("--re-stop", type=float, default=5100.0)
    ap.add_argument("--re-step", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--assemble-partial", action="store_true",
                    help="skip generation and assemble the 4-file layout "
                         "from whatever chunks exist (subset of Re values); "
                         "for bounded sweeps cut off by a time budget")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = args.out or os.path.join(root, "data", "ml_full")
    chunk_dir = os.path.join(out_dir, "chunks")
    os.makedirs(chunk_dir, exist_ok=True)

    cfg = SimConfig(
        nx=args.grid, ny=args.grid, reynolds=1000.0, collision="srt",
        turbulence="smagorinsky", precision="float32",
        max_steps=args.max_steps, report_interval=args.report_interval,
        convergence_tol=args.tol,
    ).validate()

    re_all = np.arange(args.re_start, args.re_stop, args.re_step, dtype=np.float64)

    def chunk_path(re0: float) -> str:
        return os.path.join(chunk_dir, f"re{re0:08.1f}.npz")

    # Resume: the Re values a chunk holds are done; batches are formed from
    # the rest in order, and a chunk is keyed by its batch's first Re.
    done = set()
    for fn in os.listdir(chunk_dir):
        if fn.endswith(".npz"):
            with np.load(os.path.join(chunk_dir, fn)) as z:
                done.update(float(r) for r in z["re"])
    remaining = np.asarray([r for r in re_all if float(r) not in done])
    print(f"{len(re_all)} Re values total, {len(done)} done, "
          f"{len(remaining)} remaining", flush=True)

    t_start = time.time()
    log_path = os.path.join(out_dir, "progress.jsonl")
    batch_start = [t_start]

    def on_batch(res, f_chunk, u_chunk, steps, converged, failed=None):
        if failed is None:
            failed = np.zeros(len(res), dtype=bool)
        t_write = time.time()
        batch_s = t_write - batch_start[0]
        np.savez_compressed(
            chunk_path(float(res[0])), re=res,
            f_final=f_chunk, u_final=u_chunk, steps=steps,
            converged=converged, failed=failed,
        )
        write_s = time.time() - t_write
        with open(log_path, "a") as fh:
            fh.write(json.dumps({
                "re_lo": float(res[0]), "re_hi": float(res[-1]),
                "steps": int(steps), "failed": int(np.sum(failed)),
                "elapsed_s": round(time.time() - t_start, 1),
                "batch_s": round(batch_s, 2), "write_s": round(write_s, 2),
            }) + "\n")
        batch_start[0] = time.time()

    def progress(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    # Consecutive Re groups per batch (similar convergence times), the
    # batches in bit-reversed order: a sweep cut short still spans the
    # whole Re range, and --assemble-partial builds a training set from it.
    if len(remaining) and not args.assemble_partial:
        reordered = datagen.bit_reversed_batches(remaining, args.n_cav)
        datagen.generate_dataset(cfg, reordered, batch_size=args.n_cav,
                                 progress=progress, on_batch=on_batch,
                                 device=args.device)

    print("assembling...", flush=True)
    chunks = {}
    chunk_stats = []
    for fn in sorted(os.listdir(chunk_dir)):
        if fn.endswith(".npz"):
            z = np.load(os.path.join(chunk_dir, fn))
            b = len(z["re"])
            conv = z["converged"] if "converged" in z else np.zeros(b, dtype=bool)
            fail = z["failed"] if "failed" in z else np.zeros(b, dtype=bool)
            # each member read once: an npz member is decompressed anew at
            # every access
            f_c, u_c = z["f_final"], z["u_final"]
            for i, r in enumerate(z["re"]):
                chunks[float(r)] = (f_c[i], u_c[i], bool(fail[i]))
            chunk_stats.append({
                "re_lo": float(z["re"][0]), "re_hi": float(z["re"][-1]),
                "steps": int(z["steps"]), "converged": int(np.sum(conv)),
                "failed": int(np.sum(fail)), "of": b,
            })
    missing = [r for r in re_all if float(r) not in chunks]
    if missing and args.assemble_partial:
        re_all = np.asarray([r for r in re_all if float(r) in chunks])
        print(f"partial assembly: {len(re_all)} of "
              f"{len(re_all) + len(missing)} Re values", flush=True)
        if len(re_all) == 0:
            return 1
    elif missing:
        print(f"STILL MISSING {len(missing)} Re values: {missing[:5]}...", file=sys.stderr)
        return 1
    state0 = engine.init_state(cfg, args.device)
    n, g = len(re_all), args.grid
    f_final = np.empty((n, 9, g, g), np.float32)
    u_final = np.empty((n, 2, g, g), np.float32)
    failed = np.zeros(n, dtype=bool)
    for i, r in enumerate(re_all):
        f_final[i], u_final[i], failed[i] = chunks[float(r)]
    ds = datagen.DatasetArrays(
        re_range=re_all, feq_initial=state0.f.cpu().numpy(),
        f_final=f_final, u_final=u_final,
        failed=failed if failed.any() else None,
    )
    datagen.save_dataset(ds, out_dir)
    steps_arr = np.asarray([c["steps"] for c in chunk_stats])
    meta = {
        "grid": g, "n": n, "re": [float(re_all[0]), float(re_all[-1])],
        "collision": cfg.collision, "turbulence": cfg.turbulence,
        "u_lid": cfg.u_lid,
        # The budget applied: the most cumulative steps of any chunk
        # (scripts/torch_datagen_topup.py carries chunks on to 3 M).
        "max_steps": int(steps_arr.max()) if len(steps_arr) else 0,
        "sweep_max_steps": args.max_steps,
        "converged_cavities": int(sum(c["converged"] for c in chunk_stats)),
        "failed_cavities": int(sum(c["failed"] for c in chunk_stats)),
        "chunks": chunk_stats,
        "shapes": {"f_final": list(f_final.shape), "u_final": list(u_final.shape)},
        "elapsed_s": round(time.time() - t_start, 1),
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
    print(f"dataset written to {out_dir}: f_final {f_final.shape}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
