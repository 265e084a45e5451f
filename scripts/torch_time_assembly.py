#!/usr/bin/env python
"""The seconds of the dataset's assembly (``scripts/torch_datagen_full.py
--assemble-partial``) over chunk files of the whole sweep's shapes, without
running the sweep: one synthetic chunk file per chunk of JAX's record
(``docs/artifacts/ml_full/dataset_metadata.json``: 72 chunks, 500 Re values,
``--n-cav`` = 7 cavities of ``--grid``^2 each), written as the sweep writes
them (``np.savez_compressed`` of ``re, f_final, u_final, steps, converged,
failed``, the record's steps and counts), then the assembly run as the
pipeline runner runs it, a process of its own, and timed on the wall clock.

The fields are float32 with random mantissas, as a converged sweep's are
(f: the initial equilibrium times 1 + 1e-2 noise, u: 2e-2 noise), so that
the compression does about as much work as on the sweep's files.

Usage (from the repository root; about 2.6 GB of chunk files and 3.3 GB of
assembled arrays under ``--dir``, removed at the end):

    python scripts/torch_time_assembly.py [--dir output/assembly_timing]
        [--out docs/artifacts/torch/assembly_cpu.json] [--workers 4]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "ml_full", "dataset_metadata.json")
RE_STEP = 10.0


def write_chunk(chunk_dir: str, chunk: dict, grid: int, seed: int) -> int:
    """One chunk file of the record's ``chunk`` at ``grid``^2; returns its
    size in bytes."""
    from latticeboltzmannsimulations_torch import engine
    from latticeboltzmannsimulations_torch.config import SimConfig

    rng = np.random.default_rng(seed)
    n = chunk["of"]
    re = chunk["re_lo"] + RE_STEP * np.arange(n, dtype=np.float64)
    feq = engine.init_state(SimConfig(nx=grid, ny=grid, precision="float32"), "cpu").f.numpy()
    f = (feq[None] * (1.0 + 1e-2 * rng.standard_normal((n, 9, grid, grid)))).astype(np.float32)
    u = (2e-2 * rng.standard_normal((n, 2, grid, grid))).astype(np.float32)
    converged = np.arange(n) < chunk["converged"]
    path = os.path.join(chunk_dir, f"re{re[0]:08.1f}.npz")
    np.savez_compressed(path, re=re, f_final=f, u_final=u, steps=np.int64(chunk["steps"]),
                        converged=converged, failed=np.zeros(n, dtype=bool))
    return os.path.getsize(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=384)
    ap.add_argument("--dir", default=os.path.join(ROOT, "output", "assembly_timing"))
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "artifacts", "torch",
                                                  "assembly_cpu.json"))
    ap.add_argument("--workers", type=int, default=4, help="processes writing the chunk files")
    args = ap.parse_args(argv)

    with open(JAX_RECORD) as fh:
        chunks = json.load(fh)["chunks"]
    chunk_dir = os.path.join(args.dir, "chunks")
    if os.path.exists(args.dir):
        shutil.rmtree(args.dir)
    os.makedirs(chunk_dir)
    t0 = time.time()
    jobs = ([chunk_dir] * len(chunks), chunks, [args.grid] * len(chunks), range(len(chunks)))
    if args.workers > 1:
        with ProcessPoolExecutor(args.workers) as pool:
            sizes = list(pool.map(write_chunk, *jobs))
    else:
        sizes = list(map(write_chunk, *jobs))
    write_s = time.time() - t0
    print(f"{len(chunks)} chunk files, {sum(sizes)} bytes, written in {write_s:.1f} s",
          flush=True)

    argv = [sys.executable, os.path.join("scripts", "torch_datagen_full.py"), "--grid",
            str(args.grid), "--assemble-partial", "--out", args.dir, "--device", "cpu"]
    t0 = time.time()
    subprocess.run(argv, cwd=ROOT, check=True)
    seconds = time.time() - t0
    with open(os.path.join(args.dir, "metadata.json")) as fh:
        meta = json.load(fh)
    out = {
        "what": "torch_datagen_full.py --assemble-partial over synthetic chunk files of the "
                "whole sweep's shapes, one process, wall clock",
        "seconds": round(seconds, 2), "chunks": len(chunks), "cavities": meta["n"],
        "grid": args.grid, "chunk_bytes": sum(sizes),
        "assembled_bytes": sum(os.path.getsize(os.path.join(args.dir, fn))
                               for fn in os.listdir(args.dir) if fn.endswith(".npy")),
        "host": {"cpu": platform.processor() or platform.machine(), "cores": os.cpu_count()},
        "command": " ".join(["python", *argv[1:-3], "DIR", *argv[-2:]]),
    }
    shutil.rmtree(args.dir)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
