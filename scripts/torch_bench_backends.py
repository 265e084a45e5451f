#!/usr/bin/env python
"""MLUPS of the port's routes on the card: the counterpart of
``scripts/bench_backends.py``, with its flags, over the port's route names
(``sim.BACKENDS``).

Each route and size is timed by ``bench.measure`` (one warm-up chunk, then
``--chunks`` chunks of ``--steps`` steps on the wall clock between two
synchronisations) on the 1024^2-style cavity (Re=5000, float32), and one
JSON record per route and size is appended to
``docs/artifacts/torch/bench_backends.jsonl``.  The sharded routes run on
a ``--mesh MxN`` of the one card (``device=["cuda:0"] * (M*N)``).  A route
that cannot serve a configuration says why and the sweep goes on; nothing
runs in its place.

Usage (from the repository root, one card visible):

    python scripts/torch_bench_backends.py --backends cuda-pull,cuda-tblock \\
        --sizes 1024,2048 [--mesh 2x2] [--steps 2000] [--chunks 3] [--k 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch import bench, sim  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.kernels import tblock  # noqa: E402

OUT = os.path.join(ROOT, "docs", "artifacts", "torch", "bench_backends.jsonl")


def bench_one(name: str, size: int, args, mesh_shape, device: str = "cuda:0"):
    """One route at one size: its record, or None (printing why) where the
    routing refuses the route for this configuration."""
    is_sharded = name in sim._SHARDED
    cfg = SimConfig(
        nx=size, ny=size, reynolds=5000.0, collision=args.collision,
        precision="float32", mesh_shape=mesh_shape if is_sharded else (1, 1),
    ).validate()
    where = [device] * (mesh_shape[0] * mesh_shape[1]) if is_sharded else device
    try:
        sim._select_backend(cfg, name, sim._placement(cfg, where))
    except ValueError as e:
        print(f"{name}@{size}: refused ({e})", flush=True)
        return None
    k = args.k if name == "cuda-tblock" else None
    res = bench.measure(cfg, name, args.steps, args.chunks, where, k_steps=k)
    return {
        "backend": res["route"], "size": size, "collision": args.collision,
        "mesh": list(mesh_shape) if is_sharded else [1, 1],
        "mlups": res["mlups"], "warmup_s": res["warmup_s"],
        "ms_per_step": res["ms_per_step"], "steps": res["steps"],
        "device": bench.device_name(device),
        **({"k": k or tblock.K_STEPS} if "tblock" in res["route"] else {}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", default="cuda-pull,cuda-sharded,cuda-sharded-tblock",
                    help=f"comma-separated, of {', '.join(sim.BACKENDS)}")
    ap.add_argument("--sizes", default="1024,2048")
    ap.add_argument("--mesh", default="1x1", help="the sharded routes' mesh of the card")
    ap.add_argument("--steps", type=int, default=2000, help="steps per timed chunk")
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--collision", default="mrt")
    ap.add_argument("--k", type=int, default=None,
                    help="cuda-tblock's steps per launch (default: the kernel's own)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    mesh_shape = tuple(int(v) for v in args.mesh.split("x"))
    print(f"device: {bench.device_name('cuda')}; nvidia-smi: {bench.card_line()}",
          flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for size in (int(s) for s in args.sizes.split(",")):
        for name in args.backends.split(","):
            rec = bench_one(name, size, args, mesh_shape)
            if rec is None:
                continue
            print(json.dumps(rec), flush=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
