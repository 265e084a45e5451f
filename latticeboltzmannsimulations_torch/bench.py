"""Headline benchmark: MLUPS of the 1024x1024 D2Q9 MRT lid-driven cavity
(Re=5000, float32), the port's counterpart of the repository's ``bench.py``.

    python -m latticeboltzmannsimulations_torch bench               # the card
    python -m latticeboltzmannsimulations_torch bench --device cpu  # when asked

Prints exactly ONE JSON line on stdout, with ``bench.py``'s four keys:
``{"metric", "value", "unit", "vs_baseline"}``; the card's name and power
limit, the route, the CUDA-event ms/step and build messages go to stderr.
``LBM_BENCH_N`` (1024), ``LBM_BENCH_COLLISION`` (``mrt``),
``LBM_BENCH_CHUNK`` (10 000 steps per chunk) and ``LBM_BENCH_CHUNKS`` (3
timed chunks) override the defaults, as they do for ``bench.py``.

The runner is the one ``sim._select_backend`` routes the configuration to,
so the bench times the route a run takes (``cuda-pull`` at 1024^2 on the
card).  One warm-up chunk builds the kernels and captures the chunk's CUDA
graph; the timed chunks run between two ``torch.cuda.synchronize()`` calls
on the wall clock.  There is no fallback: without a card, and without
``--device cpu``, the bench raises and prints nothing on stdout; no route
gives way to another.

MLUPS = nx * ny * steps * 1e-6 / elapsed, to six significant digits (one
decimal at the card's five-digit rates, as ``bench.py`` rounds, and still
above 0 on the CPU); ``vs_baseline`` divides by 2000 MLUPS, ``bench.py``'s
divisor (the BASELINE.md build target).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

from . import engine, sim
from .config import SimConfig, resolve_device
from .kernels import tblock

BASELINE_MLUPS = 2000.0
CHUNK = 10_000
CHUNKS = 3


def measure(cfg: SimConfig, backend: str = "auto", steps_per_chunk: int = CHUNK,
            n_chunks: int = CHUNKS, device="cuda", k_steps: int | None = None) -> dict:
    """Time ``n_chunks`` chunks of ``steps_per_chunk`` steps of ``cfg`` from
    rest through the runner ``sim._select_backend`` routes ``backend`` to,
    after one warm-up chunk.  ``device`` is as ``sim.simulate`` takes it
    (one device, or a sequence of ``mx * my`` with a mesh).  ``k_steps``
    sets the temporal-block kernel's steps per launch, and only on the
    ``cuda-tblock`` route.

    Returns ``mlups`` (wall clock), ``route``, ``steps`` (timed),
    ``seconds`` (timed), ``warmup_s``, ``ms_per_step`` (CUDA events on the
    first device's current stream; None off the card) and ``state``, the
    state after the timed chunks.  Raises if that state is not finite."""
    where = sim._placement(cfg, device)
    routed = sim._select_backend(cfg, backend, where)
    first = sim._first_device(where)
    make_runner = routed.make_runner
    if k_steps is not None:
        if routed.name != "cuda-tblock":
            raise ValueError(f"k_steps is the cuda-tblock route's, not {routed.name!r}'s")
        make_runner = lambda n: tblock.make_scan_runner(  # noqa: E731
            cfg, n, first, k_steps=k_steps)
    on_card = first.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    t0 = time.perf_counter()
    runner = make_runner(steps_per_chunk)
    state = runner(routed.prep(engine.init_state(cfg, first)))
    sync()
    warmup_s = time.perf_counter() - t0

    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if on_card:
        start.record()
    for _ in range(n_chunks):
        state = runner(state)
    if on_card:
        end.record()
    sync()
    seconds = time.perf_counter() - t0

    steps = steps_per_chunk * n_chunks
    state = sim._global_state(state, first)
    if not bool(torch.isfinite(state.f).all()):
        raise FloatingPointError(f"non-finite populations after {steps} timed steps "
                                 f"on {routed.name}")
    return {
        "mlups": cfg.nx * cfg.ny * steps * 1e-6 / seconds,
        "route": routed.name,
        "steps": steps,
        "seconds": seconds,
        "warmup_s": warmup_s,
        "ms_per_step": start.elapsed_time(end) / steps if on_card else None,
        "state": state,
    }


def record(cfg: SimConfig, res: dict) -> dict:
    """The benchmark's line of ``measure``'s result: ``bench.py``'s four
    keys, the route named in ``metric``."""
    mlups = res["mlups"]
    return {
        "metric": (f"MLUPS {cfg.nx}x{cfg.ny} D2Q9 {cfg.collision.upper()} "
                   f"cavity ({res['route']})"),
        "value": float(f"{mlups:.6g}"),
        "unit": "MLUPS",
        "vs_baseline": round(mlups / BASELINE_MLUPS, 3),
    }


def device_name(device) -> str:
    """The card's name, or the device's type off the card."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(device: str = "cuda") -> int:
    """The benchmark on ``device``: one JSON line on stdout, the rest on
    stderr.  Raises (so the process exits non-zero with nothing on stdout)
    when the device is absent or the run fails."""
    size = int(os.environ.get("LBM_BENCH_N", "1024"))
    cfg = SimConfig(nx=size, ny=size, reynolds=5000.0,
                    collision=os.environ.get("LBM_BENCH_COLLISION", "mrt"),
                    precision="float32").validate()
    steps_per_chunk = int(os.environ.get("LBM_BENCH_CHUNK", str(CHUNK)))
    n_chunks = int(os.environ.get("LBM_BENCH_CHUNKS", str(CHUNKS)))
    device = resolve_device(device)
    with contextlib.redirect_stdout(sys.stderr):
        if device.type == "cuda":
            print(f"bench: {device_name(device)}; nvidia-smi: {card_line()}")
        res = measure(cfg, "auto", steps_per_chunk, n_chunks, device)
        ms = res["ms_per_step"]
        print(f"bench: route {res['route']}, {res['steps']} steps in "
              f"{res['seconds']:.4f} s after a {res['warmup_s']:.3f} s warm-up chunk"
              + (f", {ms:.5f} ms/step by CUDA events" if ms is not None else ""))
    print(json.dumps(record(cfg, res)), flush=True)
    return 0
