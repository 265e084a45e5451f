#!/usr/bin/env python
"""Weak-scaling shape check: the port's counterpart of
``scripts/weak_scaling_cpu.py``, on the CPU and on one card.

At a fixed ``BLOCK`` x ``BLOCK`` block per shard, the work per step grows
with the number of shards while the halo machinery adds what it adds, so
the cost per global site and step stays flat across meshes where the
exchange is O(edge) and small; the step from flat is the sharding overhead.
Each mesh also times the unsharded runner at the same global grid (the
control), which separates the cache footprint's growth from the sharding.

* ``--device cpu``: the plain sharded engine
  (``parallel.make_sharded_scan_runner``, route ``sharded``) over
  ``make_mesh(shape, ["cpu"] * n)``, against the plain fused engine
  (``engine.make_scan_runner``, route ``torch``); wall-clock timing.  The
  shards run one after another on the process's intra-op threads
  (``threads``), so this is no parallel speed-up either.
* ``--device cuda`` (the default): every shard on the one card, through the
  route ``sim._select_backend`` takes for the mesh, ``cuda-sharded``
  (``kernels/pull_sharded.py``: one ``halo_exchange`` launch and one
  ``pull_sharded_step`` launch per shard a step, replayed as CUDA graphs),
  against ``cuda-pull``; timed with CUDA events over at least
  ``MIN_TIMED_STEPS`` steps a timing (``--steps`` a call, repeated).  One
  card cannot show a parallel speed-up: this measures the cost per site of
  the exchange and of the per-shard launches.

The 1x1 mesh runs the sharded route too, as the JAX script runs its sharded
runner on a 1x1 mesh; ``auto`` never takes it there (a run without a mesh
goes to ``cuda-pull``), so on the card the 1x1 row reads the cost of one
self-wrapping exchange launch a step, which no user's run pays.  Each
mesh's sharded run ends in the control's state exactly, or the script
raises.  Each mesh runs in a subprocess of its own (the JAX script's
``--child MxN`` form).  The percentages are rounded as the JAX
script rounds them; the times are not rounded.

Usage (from the repository root):

    python scripts/torch_weak_scaling_cpu.py [--device cuda|cpu] [--steps N]

Writes the device's table into ``docs/artifacts/torch/weak_scaling_cpu.json``
(``{"cpu": ..., "cuda": ...}``), each row beside the JAX record's row of the
same mesh (``docs/artifacts/weak_scaling_cpu.json``, XLA:CPU on one core).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from latticeboltzmannsimulations_torch import sim  # noqa: E402
from latticeboltzmannsimulations_torch.bench import card_line, device_name  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig, resolve_device  # noqa: E402
from latticeboltzmannsimulations_torch.engine import init_state  # noqa: E402
from latticeboltzmannsimulations_torch.parallel import make_mesh, unshard_state  # noqa: E402

ART = os.path.join(ROOT, "docs", "artifacts", "torch")
JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "weak_scaling_cpu.json")
BLOCK = 256          # per-shard block edge (fixed: weak scaling)
STEPS = 200
REPS = 3
MESHES = [(1, 1), (2, 2), (2, 4)]
# On the card each timing covers at least this many steps (calls of --steps)
MIN_TIMED_STEPS = 10_000
# (sharded route, control route) by device type
ROUTES = {"cuda": ("cuda-sharded", "cuda-pull"), "cpu": ("sharded", "torch")}

NOTES = {
    "cpu": ("CPU shape check: the port's plain sharded engine runs its shards one "
            "after another on the process's intra-op threads, so flat ns/site/step "
            "across meshes == the halo overhead is O(edge)-small; NOT a "
            "parallel-speedup measurement"),
    "cuda": ("one-card shape check: every shard on the same card, so the rows read "
             "the cost per site of the halo exchange launch and of one launch per "
             "shard against one pull_step launch a step; one card cannot show a "
             "parallel speed-up: NOT a parallel-speedup measurement. The 1x1 row "
             "is a route auto never takes (a run without a mesh goes to "
             "cuda-pull), kept for parity with the JAX script: its overhead is "
             "one self-wrapping exchange launch a step, which no user's run pays"),
}
ENGINES = {
    "cpu": ("plain sharded engine (parallel/halo.py make_sharded_scan_runner) over "
            "make_mesh(shape, ['cpu'] * n); control engine.make_scan_runner"),
    "cuda": ("cuda-sharded (csrc/pull_sharded_step.cu per shard, csrc/halo_exchange.cu "
             "once a step, CUDA graphs) on one card; control cuda-pull "
             "(csrc/pull_step.cu)"),
}


def _best(runner, state, calls: int, reps: int, cuda: bool):
    """The least seconds of ``calls`` runner calls over ``reps`` timings,
    after one call that builds (and on the card captures) and warms, and
    the state after all of them."""
    state = runner(state)
    if cuda:
        torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(calls):
                state = runner(state)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                state = runner(state)
            best = min(best, time.perf_counter() - t0)
    return best, state


def measure(mx: int, my: int, device="cuda", steps: int | None = None,
            block: int | None = None, reps: int | None = None,
            min_timed_steps: int = MIN_TIMED_STEPS) -> dict:
    """One mesh's row: the sharded route over ``mx x my`` shards of
    ``block``^2 on ``device`` against the unsharded route at the same global
    grid, with the JAX script's keys and the routes taken.  Both start from
    the same state and run the same steps, so the sharded run's final state
    must equal the control's exactly; raises where it does not."""
    steps, block, reps = steps or STEPS, block or BLOCK, reps or REPS
    device = resolve_device(device)
    cuda = device.type == "cuda"
    sharded_route, control_route = ROUTES[device.type]
    calls = max(1, math.ceil(min_timed_steps / steps)) if cuda else 1
    cfg = SimConfig(nx=block * mx, ny=block * my, reynolds=1000.0,
                    collision="mrt", precision="float32",
                    mesh_shape=(mx, my)).validate()
    mesh = make_mesh((mx, my), [device] * (mx * my))
    routed = sim._select_backend(cfg, "auto" if (mx, my) != (1, 1) else sharded_route, mesh)
    cfg1 = SimConfig(nx=cfg.nx, ny=cfg.ny, reynolds=1000.0, collision="mrt",
                     precision="float32").validate()
    control = sim._select_backend(cfg1, "auto", device)
    if (routed.name, control.name) != (sharded_route, control_route):
        raise RuntimeError(f"mesh {mx}x{my} on {device}: routed to {routed.name} and "
                           f"{control.name}, not {sharded_route} and {control_route}")
    best, out = _best(routed.make_runner(steps), routed.prep(init_state(cfg, device)),
                      calls, reps, cuda)
    # Control: the unsharded runner at the same *global* grid on the same
    # device, separating cache-footprint growth (present in both) from the
    # halo overhead (present only in the sharded run).
    best1, out1 = _best(control.make_runner(steps), init_state(cfg1, device), calls, reps, cuda)
    out = unshard_state(out, device)
    if not (torch.equal(out.f, out1.f) and torch.equal(out.rho_lid, out1.rho_lid)):
        diff = (out.f - out1.f).abs().max().item()
        raise RuntimeError(f"mesh {mx}x{my} on {device}: {routed.name}'s state differs "
                           f"from {control.name}'s after the same steps (max |df| {diff})")
    sites, timed = cfg.nx * cfg.ny, calls * steps
    return {
        "mesh": f"{mx}x{my}", "devices": mx * my,
        "grid": [cfg.nx, cfg.ny], "per_shard": [block, block],
        "steps": steps, "wall_s": best / calls,
        "ns_per_site_step": 1e9 * best / (sites * timed),
        "unsharded_ns_per_site_step": 1e9 * best1 / (sites * timed),
        "sharding_overhead_pct": round(100.0 * (best / best1 - 1.0), 1),
        "route": routed.name, "control_route": control.name,
        "calls": calls, "timed_steps": timed, "equal_to_control": True,
        "threads": torch.get_num_threads(),
    }


def child(mesh_str: str, device: str, steps: int) -> int:
    mx, my = (int(v) for v in mesh_str.split("x"))
    print(json.dumps(measure(mx, my, device, steps)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps per runner call (the JAX script's STEPS)")
    ap.add_argument("--child", metavar="MxN", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.device, args.steps)
    name = device_name(args.device)          # raises where the card is absent
    card = card_line() if args.device == "cuda" else None
    if card is not None:
        print(f"device: {name}; nvidia-smi: {card}", flush=True)
    with open(JAX_RECORD) as fh:
        jax_rows = {r["mesh"]: r for r in json.load(fh)["rows"]}
    rows = []
    for mx, my in MESHES:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", f"{mx}x{my}",
             "--device", args.device, "--steps", str(args.steps)],
            capture_output=True, text=True, timeout=1200, cwd=ROOT,
        )
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    base = rows[0]["ns_per_site_step"]
    for r in rows:
        r["overhead_vs_1x1_pct"] = round(
            100.0 * (r["ns_per_site_step"] / base - 1.0), 1)
        theirs = jax_rows.get(r["mesh"])
        if theirs is not None:
            r.update(jax_ns_per_site_step=theirs["ns_per_site_step"],
                     jax_unsharded_ns_per_site_step=theirs["unsharded_ns_per_site_step"],
                     jax_sharding_overhead_pct=theirs["sharding_overhead_pct"],
                     jax_overhead_vs_1x1_pct=theirs["overhead_vs_1x1_pct"])
    payload = {
        "note": NOTES[args.device],
        "engine": ENGINES[args.device],
        "device": name, "card": card,
        "threads": rows[0]["threads"],
        "timing": ("CUDA events around calls covering at least "
                   f"{MIN_TIMED_STEPS} steps, best of {REPS}" if card is not None
                   else f"wall clock around one call, best of {REPS}"),
        "jax": "docs/artifacts/weak_scaling_cpu.json: jnp sharded scan runner, XLA:CPU, one core",
        "rows": rows,
    }
    path = os.path.join(ART, "weak_scaling_cpu.json")
    tables = {}
    if os.path.exists(path):
        with open(path) as fh:
            tables = json.load(fh)
    tables[args.device] = payload
    os.makedirs(ART, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(tables, fh, indent=1)
        fh.write("\n")
    print(f"wrote the {args.device} table into {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
