"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` builds ``csrc/pull_step.cu`` (or finds it built);
3. kernel vs plain: 20 steps of the CUDA kernel against the plain PyTorch
   step (``engine.make_fused_step``) on the card, from the same start state,
   for SRT, TRT, MRT, MRT+Smagorinsky and SRT+Smagorinsky+Van Driest at
   128^2 and MRT at 1024^2, to ``atol=2e-5`` (an independent float32
   implementation: the order of operations and FMA contraction differ);
4. main path: ``simulate`` with ``backend="auto"`` and then
   ``run_to_convergence`` at 1024^2 MRT float32 (the benchmark's cavity),
   then the two default-suite Ghia gates through ``simulate`` (Re=100 and
   Re=400, MRT 96^2); each must route to ``"cuda-pull"`` and launch the
   kernel once per step;
5. timing: the benchmark's 1024^2 MRT float32 cavity at Re=5000, one warm-up
   chunk then 3 chunks of 10 000 steps, timed with CUDA events, beside the
   measured device-copy bandwidth and the 72 B/cell bound.

The last three lines are ``nvidia-smi``'s line, one JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result; so does a machine with no
CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time

import torch

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import _build, pull
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate

ATOL = 2e-5
# The TPU kernel that csrc/pull_step.cu replaces, in the JAX package.
REPLACES = "kernels/pallas_pull.py:189 (_make_kernel)"
COMPARE_STEPS = 20
BENCH_N = 1024
BENCH_CHUNK = 10_000
BENCH_CHUNKS = 3
BASELINE_MLUPS = 2000.0           # the benchmark's vs_baseline denominator
BYTES_PER_CELL = 72               # one read and one write of 9 f32 planes
# Floating-point operations per cell of the kernel's MRT path (no LES),
# counted from csrc/pull_step.cu: one per add, multiply or divide.
FLOPS_PER_CELL_MRT = 170
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def compare_case(name: str, cfg: SimConfig, device) -> float:
    """20 kernel steps against 20 plain steps from the same start state."""
    plain = engine.make_fused_step(cfg)
    kernel = pull.make_step(cfg, device)
    s_plain = s_kernel = engine.init_state(cfg, device)
    for _ in range(COMPARE_STEPS):
        s_plain = plain(s_plain)
        s_kernel = kernel(s_kernel)
    torch.cuda.synchronize()
    err_f = (s_kernel.f - s_plain.f).abs().max().item()
    err_lid = (s_kernel.rho_lid - s_plain.rho_lid).abs().max().item()
    print(f"  {name:28s} {cfg.nx}x{cfg.ny}: max|df|={err_f:.3e} "
          f"max|d rho_lid|={err_lid:.3e} (atol {ATOL:g})", flush=True)
    if not (math.isfinite(err_f) and math.isfinite(err_lid)):
        raise AssertionError(f"{name}: non-finite difference")
    if err_f > ATOL or err_lid > ATOL:
        raise AssertionError(f"{name}: kernel and plain version differ beyond {ATOL}")
    return max(err_f, err_lid)


def check_runner_ping_pong(device) -> None:
    """The scan runner's two buffers give the same trajectory as stepping
    (an odd count ends on the second buffer), and leave the input alone."""
    cfg = SimConfig(nx=128, ny=128, reynolds=400.0, collision="mrt")
    s0 = engine.init_state(cfg, device)
    f0 = s0.f.clone()
    out = pull.make_scan_runner(cfg, 7, device)(s0)
    step = pull.make_step(cfg, device)
    s = s0
    for _ in range(7):
        s = step(s)
    torch.cuda.synchronize()
    if not (torch.equal(out.f, s.f) and torch.equal(out.rho_lid, s.rho_lid)):
        raise AssertionError("scan runner and stepwise kernel differ")
    if not torch.equal(s0.f, f0):
        raise AssertionError("the scan runner wrote its input state")
    print("  scan runner (7 steps) == 7 single steps, input untouched", flush=True)


def run_main_path(cfg: SimConfig, device, out_dir: str, gates: dict | None):
    """``simulate`` with the default backend; must route to the kernel and
    launch it once per step."""
    pull.launches = 0
    summary = simulate(cfg, SimOptions(out_dir=out_dir, verbose=False), device=device)
    launches = pull.launches
    print(f"  {cfg.describe()}: backend={summary.backend} steps={summary.steps} "
          f"launches={launches} MLUPS={summary.mlups:.1f} r2_ux={summary.r2_ux} "
          f"r2_uy={summary.r2_uy} l2={summary.l2_combined}", flush=True)
    if summary.backend != "cuda-pull":
        raise AssertionError(f"routed to {summary.backend!r}, not 'cuda-pull'")
    if launches != summary.steps:
        raise AssertionError(f"{launches} kernel launches for {summary.steps} steps")
    if not math.isfinite(summary.mlups):
        raise AssertionError("non-finite MLUPS")
    for key, (op, limit) in (gates or {}).items():
        value = getattr(summary, key)
        ok = value > limit if op == ">" else value < limit
        if not ok:
            raise AssertionError(f"Ghia gate failed: {key}={value} not {op} {limit}")
    return launches


def run_converge_path(cfg: SimConfig, device) -> int:
    """``run_to_convergence``, the package's other entry point: it too must
    launch the kernel once per step and end with a finite field."""
    pull.launches = 0
    res = lbt.run_to_convergence(cfg, device=device)
    launches = pull.launches
    torch.cuda.synchronize()
    print(f"  run_to_convergence {cfg.describe()}: steps={res.steps} "
          f"launches={launches} mean_u={res.mean_u_history}", flush=True)
    if launches != res.steps:
        raise AssertionError(f"{launches} kernel launches for {res.steps} steps")
    if not bool(torch.isfinite(res.state.f).all()):
        raise AssertionError("run_to_convergence: non-finite populations")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
              f"device: {kind}; nvidia-smi: {smi}", flush=True)

    with phase("build"):
        t0 = time.perf_counter()
        path, log = _build.ensure_built()
        if log is None:
            print(f"  cached: {path.name}", flush=True)
        else:
            print(f"  nvcc built {path.name} in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}", flush=True)
        _build.load_library()

    with phase("kernel vs plain"):
        cases = [
            ("srt", dict(collision="srt", reynolds=400.0)),
            ("trt", dict(collision="trt", reynolds=400.0)),
            ("mrt", dict(collision="mrt", reynolds=400.0)),
            ("mrt+smagorinsky", dict(collision="mrt", reynolds=5000.0,
                                     turbulence="smagorinsky")),
            ("srt+smagorinsky+van_driest", dict(collision="srt", reynolds=5000.0,
                                                turbulence="smagorinsky",
                                                van_driest=True)),
        ]
        worst = 0.0
        for name, kw in cases:
            worst = max(worst, compare_case(name, SimConfig(nx=128, ny=128, **kw), device))
        bench_cfg = SimConfig(nx=BENCH_N, ny=BENCH_N, reynolds=5000.0,
                              collision="mrt", precision="float32").validate()
        worst = max(worst, compare_case("mrt", bench_cfg, device))
        check_runner_ping_pong(device)

    with phase("main path: simulate"), tempfile.TemporaryDirectory() as tmp:
        main_cfg = SimConfig(nx=BENCH_N, ny=BENCH_N, reynolds=5000.0,
                             collision="mrt", precision="float32",
                             max_steps=20_000, report_interval=5_000)
        main_launches = run_main_path(main_cfg, device, tmp, None)
        main_launches += run_converge_path(
            dataclasses.replace(main_cfg, max_steps=10_000), device)
        run_main_path(
            SimConfig(nx=96, ny=96, reynolds=100.0, collision="mrt",
                      max_steps=12_000, report_interval=2_000),
            device, tmp, {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)})
        run_main_path(
            SimConfig(nx=96, ny=96, reynolds=400.0, collision="mrt",
                      max_steps=30_000, report_interval=5_000),
            device, tmp, {"r2_ux": (">", 0.995), "r2_uy": (">", 0.995),
                          "l2_combined": ("<", 0.035)})

    with phase("timing"):
        runner = pull.make_scan_runner(bench_cfg, BENCH_CHUNK, device)
        state = runner(engine.init_state(bench_cfg, device))   # warm-up chunk
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BENCH_CHUNKS):
            state = runner(state)
        end.record()
        torch.cuda.synchronize()
        elapsed_ms = start.elapsed_time(end)
        if not bool(torch.isfinite(state.f).all()):
            raise AssertionError("non-finite populations after the timed chunks")
        steps = BENCH_CHUNK * BENCH_CHUNKS
        cells = bench_cfg.nx * bench_cfg.ny
        kernel_ms = elapsed_ms / steps
        mlups = cells * steps * 1e-6 / (elapsed_ms * 1e-3)
        print(json.dumps({
            "metric": (f"MLUPS {bench_cfg.nx}x{bench_cfg.ny} D2Q9 "
                       f"{bench_cfg.collision.upper()} cavity (cuda-pull)"),
            "value": round(mlups, 1),
            "unit": "MLUPS",
            "vs_baseline": round(mlups / BASELINE_MLUPS, 3),
        }), flush=True)

        src = torch.empty(2**28, dtype=torch.float32, device=device)  # 1 GiB
        dst = torch.empty_like(src)
        dst.copy_(src)
        copy_ms = cuda_time_ms(lambda: dst.copy_(src), 20)
        copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
        del src, dst
        bound_mlups = copy_bw / BYTES_PER_CELL * 1e-6
        print(f"  device copy: {copy_bw / 1e9:.1f} GB/s (1 GiB read + 1 GiB "
              f"written per copy); 72 B/cell bound {bound_mlups:.1f} MLUPS; "
              f"kernel at {mlups / bound_mlups:.3f} of it", flush=True)

        plain = engine.make_fused_step(bench_cfg)
        s_plain = engine.init_state(bench_cfg, device)
        for _ in range(2):
            s_plain = plain(s_plain)
        holder = [s_plain]

        def plain_once():
            holder[0] = plain(holder[0])

        plain_ms = cuda_time_ms(plain_once, 10)
        bytes_moved = BYTES_PER_CELL * cells + 2 * 4 * bench_cfg.nx
        bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        ops_ms = FLOPS_PER_CELL_MRT * cells / PEAK_F32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  kernel {kernel_ms:.5f} ms/step; plain version {plain_ms:.4f} "
              f"ms/step; bound {bound_ms:.5f} ms/step by "
              f"{'bytes' if bytes_ms >= ops_ms else 'operations'} at the "
              f"published peak; launches on the main path {main_launches}",
              flush=True)

    print(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "pull_step",
        "route": "cuda",
        "source": "latticeboltzmannsimulations_torch/csrc/pull_step.cu",
        "replaces": REPLACES,
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
