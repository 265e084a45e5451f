"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` builds every ``csrc/*.cu`` into one library (one process
   per source, all started together), or finds it built;
3. kernel vs plain, each from the same start state on the card, to
   ``atol=2e-5`` (an independent float32 implementation: the order of
   operations and FMA contraction differ):
   * ``pull_step`` against 20 plain fused steps (``engine.make_fused_step``)
     for SRT, TRT, MRT, MRT+Smagorinsky and SRT+Smagorinsky+Van Driest at
     128^2 and MRT at 1024^2;
   * ``tblock_step`` (K=8, 20 steps: two launches and four one-step
     remainder launches) against 20 plain fused steps for SRT, TRT, MRT and
     MRT+Smagorinsky at 128^2 and MRT at 2048^2, and against ``pull_step``
     over 64 steps at 2048^2 (to 1e-6);
   * ``push_step`` against 20 push-oracle steps
     (``engine.make_push_oracle_step``) for the same four cases at 128^2 and
     MRT at 1024^2;
4. main paths, each launch counter set to 0 just before a run and read just
   after it:
   * ``simulate`` and ``run_to_convergence`` at 1024^2 MRT float32 (the
     benchmark's cavity) and the two default-suite Ghia gates (MRT 96^2,
     Re=100 and Re=400) through ``cuda-pull``;
   * ``simulate`` at 2048^2 MRT float32 Re=5000 with ``backend="auto"`` (the
     large-cavity path), and through an explicit ``cuda-tblock`` when auto
     picks another backend; the Re=100 Ghia gate at 128^2 through
     ``cuda-tblock``;
   * the Re=100 Ghia gate at 96^2 through ``cuda-push``;
   * a 48^2 ``bounce_back`` run, which routes to the push oracle;
5. timing with CUDA events: the measured device-copy bandwidth; the
   benchmark's 1024^2 MRT cavity through ``pull_step`` (MLUPS); at 1024^2
   and 2048^2, ``pull_step`` beside ``tblock_step`` for K in {4, 5, 8, 16};
   at 1024^2, 2048^2 and 4096^2, ``pull_step`` and ``tblock_step`` (default
   K) in turns, which sets where ``auto`` takes the latter;
   ``push_step`` at 1024^2; each kernel's plain version.

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
from latticeboltzmannsimulations_torch import engine, sim
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import _build, pull, push, tblock
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate

ATOL = 2e-5
TBLOCK_VS_PULL_ATOL = 1e-6
# The TPU kernel each CUDA kernel replaces, in the JAX package.
REPLACES = {
    "pull_step": "kernels/pallas_pull.py:189 (_make_kernel)",
    "tblock_step": "kernels/pallas_pull_tblock.py:72 (_make_kernel)",
    "push_step": "kernels/pallas_push.py:65 (_make_kernel)",
}
SOURCES = {name: f"latticeboltzmannsimulations_torch/csrc/{name}.cu" for name in REPLACES}
COUNTERS = {"pull_step": pull, "tblock_step": tblock, "push_step": push}
COMPARE_STEPS = 20
TBLOCK_COMPARE_K = 8
BENCH_N = 1024
LARGE_N = 2048
BENCH_CHUNK = 10_000
BENCH_CHUNKS = 3
SWEEP_STEPS = 1_920                # a multiple of every K of the sweep
SWEEP_K = (4, 5, 8, 16)
AHEAD_N = (1024, 2048, 4096)       # sizes where tblock_step meets pull_step
# tblock_step counts as ahead only by more than the 1.5% spread of MLUPS
# between calls (PERF.md): a smaller lead changed sign from call to call.
AHEAD_MARGIN = 1.015
BASELINE_MLUPS = 2000.0           # the benchmark's vs_baseline denominator
BYTES_PER_CELL = 72               # one read and one write of 9 f32 planes
# Floating-point operations per cell of the kernels' MRT path (no LES),
# counted from csrc/lbm_cell.cuh: one per add, multiply or divide.
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


def check_close(name: str, cfg: SimConfig, f_a, f_b, lid_a=None, lid_b=None,
                atol: float = ATOL) -> float:
    """Print and check max |df| (and max |d rho_lid| where given)."""
    torch.cuda.synchronize()
    err_f = (f_a - f_b).abs().max().item()
    err_lid = 0.0 if lid_a is None else (lid_a - lid_b).abs().max().item()
    lid_txt = "" if lid_a is None else f" max|d rho_lid|={err_lid:.3e}"
    print(f"  {name:36s} {cfg.nx}x{cfg.ny}: max|df|={err_f:.3e}{lid_txt} "
          f"(atol {atol:g})", flush=True)
    if not (math.isfinite(err_f) and math.isfinite(err_lid)):
        raise AssertionError(f"{name}: non-finite difference")
    if err_f > atol or err_lid > atol:
        raise AssertionError(f"{name}: the two differ beyond {atol}")
    return max(err_f, err_lid)


def compare_case(name: str, cfg: SimConfig, device) -> float:
    """20 one-step kernel steps against 20 plain steps."""
    plain = engine.make_fused_step(cfg)
    kernel = pull.make_step(cfg, device)
    s_plain = s_kernel = engine.init_state(cfg, device)
    for _ in range(COMPARE_STEPS):
        s_plain = plain(s_plain)
        s_kernel = kernel(s_kernel)
    return check_close(f"pull {name}", cfg, s_kernel.f, s_plain.f,
                       s_kernel.rho_lid, s_plain.rho_lid)


def compare_tblock(name: str, cfg: SimConfig, device) -> float:
    """20 steps through the temporal-block runner (K=8: two launches, then
    four one-step remainder launches) against 20 plain steps."""
    plain = engine.make_fused_step(cfg)
    s0 = engine.init_state(cfg, device)
    s_plain = s0
    for _ in range(COMPARE_STEPS):
        s_plain = plain(s_plain)
    before = tblock.launches
    s_kernel = tblock.make_scan_runner(cfg, COMPARE_STEPS, device,
                                       k_steps=TBLOCK_COMPARE_K)(s0)
    if tblock.launches - before != COMPARE_STEPS // TBLOCK_COMPARE_K:
        raise AssertionError("the tblock runner did not launch K-step blocks")
    return check_close(f"tblock K={TBLOCK_COMPARE_K} {name}", cfg, s_kernel.f,
                       s_plain.f, s_kernel.rho_lid, s_plain.rho_lid)


def compare_tblock_pull(cfg: SimConfig, device, n: int) -> float:
    """The temporal-block kernel against the one-step kernel over n steps:
    the same arithmetic, so they should agree far below the plain
    tolerance."""
    s0 = engine.init_state(cfg, device)
    a = tblock.make_scan_runner(cfg, n, device, k_steps=TBLOCK_COMPARE_K)(s0)
    b = pull.make_scan_runner(cfg, n, device)(s0)
    return check_close(f"tblock K={TBLOCK_COMPARE_K} vs pull_step, {n} steps", cfg,
                       a.f, b.f, a.rho_lid, b.rho_lid, atol=TBLOCK_VS_PULL_ATOL)


def compare_push(name: str, cfg: SimConfig, device) -> float:
    """20 push-kernel steps against 20 push-oracle steps."""
    plain = engine.make_push_oracle_step(cfg)
    kernel = push.make_push_step(cfg, device)
    f_plain = f_kernel = engine.init_state(cfg, device).f
    for _ in range(COMPARE_STEPS):
        f_plain = plain(f_plain)
        f_kernel = kernel(f_kernel)
    return check_close(f"push {name}", cfg, f_kernel, f_plain)


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


def reset_counters() -> None:
    for module in COUNTERS.values():
        module.launches = 0


def read_counters() -> dict:
    return {name: module.launches for name, module in COUNTERS.items()}


def run_main_path(cfg: SimConfig, device, out_dir: str, backend: str,
                  expect: str | None, gates: dict | None = None) -> dict:
    """``simulate`` through ``backend``; checks the route (when ``expect``
    is given), the launches of the routed kernel against the steps, a
    finite field and the Ghia gates.  Returns the launch counts."""
    reset_counters()
    summary = simulate(cfg, SimOptions(out_dir=out_dir, verbose=False,
                                       backend=backend), device=device)
    torch.cuda.synchronize()
    counts = read_counters()
    print(f"  {cfg.describe()} backend={backend}: routed to {summary.backend}, "
          f"steps={summary.steps} launches={counts} MLUPS={summary.mlups:.1f} "
          f"r2_ux={summary.r2_ux} r2_uy={summary.r2_uy} l2={summary.l2_combined}",
          flush=True)
    if expect is not None and summary.backend != expect:
        raise AssertionError(f"routed to {summary.backend!r}, not {expect!r}")
    if not math.isfinite(summary.mlups):
        raise AssertionError("non-finite MLUPS")
    steps, chunks = summary.steps, summary.steps // cfg.report_interval
    blocks, rem = divmod(cfg.report_interval, tblock.K_STEPS)
    want = {
        "cuda-pull": {"pull_step": steps, "tblock_step": 0, "push_step": 0},
        "cuda-tblock": {"pull_step": chunks * rem, "tblock_step": chunks * blocks,
                        "push_step": 0},
        "cuda-push": {"pull_step": 0, "tblock_step": 0, "push_step": steps},
    }.get(summary.backend, {"pull_step": 0, "tblock_step": 0, "push_step": 0})
    if counts != want:
        raise AssertionError(f"{summary.backend}: launches {counts}, expected {want}")
    for key, (op, limit) in (gates or {}).items():
        value = getattr(summary, key)
        ok = value > limit if op == ">" else value < limit
        if not ok:
            raise AssertionError(f"Ghia gate failed: {key}={value} not {op} {limit}")
    return counts


def run_converge_path(cfg: SimConfig, device) -> dict:
    """``run_to_convergence``, the package's other entry point: it too must
    launch the kernel once per step and end with a finite field."""
    reset_counters()
    res = lbt.run_to_convergence(cfg, device=device)
    torch.cuda.synchronize()
    counts = read_counters()
    print(f"  run_to_convergence {cfg.describe()}: steps={res.steps} "
          f"launches={counts} mean_u={res.mean_u_history}", flush=True)
    if counts["pull_step"] != res.steps:
        raise AssertionError(f"{counts} kernel launches for {res.steps} steps")
    if not bool(torch.isfinite(res.state.f).all()):
        raise AssertionError("run_to_convergence: non-finite populations")
    return counts


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] += n


def time_runner(runner, state, steps: int) -> float:
    """Device ms per step of ``runner`` (``steps`` steps per call): one
    warm-up call, then one timed call."""
    state = runner(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = runner(state)
    end.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out[0] if isinstance(out, tuple) else out).all()):
        raise AssertionError("non-finite populations after a timed run")
    return start.elapsed_time(end) / steps


def time_plain(step, state, reps: int = 10) -> float:
    """Device ms per call of a plain step (``state`` is carried)."""
    holder = [step(step(state))]

    def once():
        holder[0] = step(holder[0])

    return cuda_time_ms(once, reps)


def bound(cells: int, nx: int, k_steps: int = 1) -> tuple[float, str]:
    """Least ms per step for the work of one fused step, at the published
    peaks: the 9 planes read once and written once (plus the lid densities)
    per launch of ``k_steps`` steps, or the operations of one step."""
    bytes_ms = (BYTES_PER_CELL * cells + 2 * 4 * nx) / k_steps / PEAK_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_CELL_MRT * cells / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


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
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}", flush=True)
        _build.load_library()

    worst = {name: 0.0 for name in REPLACES}
    with phase("kernel vs plain"):
        small = [
            ("srt", dict(collision="srt", reynolds=400.0)),
            ("trt", dict(collision="trt", reynolds=400.0)),
            ("mrt", dict(collision="mrt", reynolds=400.0)),
            ("mrt+smagorinsky", dict(collision="mrt", reynolds=5000.0,
                                     turbulence="smagorinsky")),
        ]
        vd = ("srt+smagorinsky+van_driest", dict(collision="srt", reynolds=5000.0,
                                                 turbulence="smagorinsky",
                                                 van_driest=True))
        for name, kw in small + [vd]:
            worst["pull_step"] = max(worst["pull_step"], compare_case(
                name, SimConfig(nx=128, ny=128, **kw), device))
        bench_cfg = SimConfig(nx=BENCH_N, ny=BENCH_N, reynolds=5000.0,
                              collision="mrt", precision="float32").validate()
        large_cfg = dataclasses.replace(bench_cfg, nx=LARGE_N, ny=LARGE_N)
        worst["pull_step"] = max(worst["pull_step"],
                                 compare_case("mrt", bench_cfg, device))
        check_runner_ping_pong(device)
        for name, kw in small:
            worst["tblock_step"] = max(worst["tblock_step"], compare_tblock(
                name, SimConfig(nx=128, ny=128, **kw), device))
        worst["tblock_step"] = max(worst["tblock_step"],
                                   compare_tblock("mrt", large_cfg, device))
        worst["tblock_step"] = max(worst["tblock_step"],
                                   compare_tblock_pull(large_cfg, device, 64))
        for name, kw in small:
            worst["push_step"] = max(worst["push_step"], compare_push(
                name, SimConfig(nx=128, ny=128, **kw), device))
        worst["push_step"] = max(worst["push_step"],
                                 compare_push("mrt", bench_cfg, device))

    main_launches = {name: 0 for name in REPLACES}
    with phase("main path: cuda-pull"), tempfile.TemporaryDirectory() as tmp:
        main_cfg = dataclasses.replace(bench_cfg, max_steps=10_000,
                                       report_interval=5_000)
        add_counts(main_launches, run_main_path(main_cfg, device, tmp, "auto",
                                                "cuda-pull"))
        add_counts(main_launches, run_converge_path(
            dataclasses.replace(main_cfg, max_steps=5_000), device))
        add_counts(main_launches, run_main_path(
            SimConfig(nx=96, ny=96, reynolds=100.0, collision="mrt",
                      max_steps=12_000, report_interval=2_000),
            device, tmp, "auto", "cuda-pull",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))
        add_counts(main_launches, run_main_path(
            SimConfig(nx=96, ny=96, reynolds=400.0, collision="mrt",
                      max_steps=30_000, report_interval=5_000),
            device, tmp, "auto", "cuda-pull",
            {"r2_ux": (">", 0.995), "r2_uy": (">", 0.995),
             "l2_combined": ("<", 0.035)}))

    with phase("main path: large cavity"), tempfile.TemporaryDirectory() as tmp:
        large_run = dataclasses.replace(large_cfg, max_steps=8_000,
                                        report_interval=2_000)
        counts = run_main_path(large_run, device, tmp, "auto", None)
        add_counts(main_launches, counts)
        if counts["tblock_step"] == 0:
            add_counts(main_launches, run_main_path(large_run, device, tmp,
                                                    "cuda-tblock", "cuda-tblock"))
        add_counts(main_launches, run_main_path(
            SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt",
                      max_steps=16_000, report_interval=2_000),
            device, tmp, "cuda-tblock", "cuda-tblock",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))

    with phase("main path: push scheme"), tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_main_path(
            SimConfig(nx=96, ny=96, reynolds=100.0, collision="mrt",
                      max_steps=12_000, report_interval=2_000),
            device, tmp, "cuda-push", "cuda-push",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))
        run_main_path(
            SimConfig(nx=48, ny=48, reynolds=100.0, boundary="bounce_back",
                      max_steps=200, report_interval=100),
            device, tmp, "auto", "push-oracle")
    print(f"  launches on the main paths: {main_launches}", flush=True)
    for name, n in main_launches.items():
        if n == 0:
            raise AssertionError(f"{name} was launched no time on the main paths")

    timing = {}
    with phase("timing"):
        src = torch.empty(2**28, dtype=torch.float32, device=device)  # 1 GiB
        dst = torch.empty_like(src)
        dst.copy_(src)
        copy_ms = cuda_time_ms(lambda: dst.copy_(src), 20)
        copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
        del src, dst
        print(f"  device copy: {copy_bw / 1e9:.1f} GB/s (1 GiB read + 1 GiB "
              f"written per copy)", flush=True)

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
        mlups = cells * steps * 1e-6 / (elapsed_ms * 1e-3)
        print(json.dumps({
            "metric": (f"MLUPS {bench_cfg.nx}x{bench_cfg.ny} D2Q9 "
                       f"{bench_cfg.collision.upper()} cavity (cuda-pull)"),
            "value": round(mlups, 1),
            "unit": "MLUPS",
            "vs_baseline": round(mlups / BASELINE_MLUPS, 3),
        }), flush=True)
        bound_mlups = copy_bw / BYTES_PER_CELL * 1e-6
        b_ms, b_by = bound(cells, bench_cfg.nx)
        timing["pull_step"] = dict(
            ms=elapsed_ms / steps, bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_plain(engine.make_fused_step(bench_cfg),
                                engine.init_state(bench_cfg, device)))
        print(f"  pull_step {BENCH_N}^2: {timing['pull_step']['ms']:.5f} ms/step, "
              f"{mlups:.1f} MLUPS, {mlups / bound_mlups:.3f} of the measured "
              f"72 B/cell copy bound; plain {timing['pull_step']['plain_ms']:.4f} "
              f"ms/step; bound {b_ms:.5f} ms/step by {b_by}", flush=True)

        for n in (BENCH_N, LARGE_N):
            cfg = dataclasses.replace(bench_cfg, nx=n, ny=n)
            cells = n * n
            s0 = engine.init_state(cfg, device)
            pull_ms = time_runner(pull.make_scan_runner(cfg, SWEEP_STEPS, device),
                                  s0, SWEEP_STEPS)
            plain_ms = time_plain(engine.make_fused_step(cfg), s0)
            print(f"  {n}^2 pull_step {pull_ms:.5f} ms/step "
                  f"({cells * 1e-3 / pull_ms:.1f} MLUPS); plain {plain_ms:.4f} "
                  f"ms/step", flush=True)
            for k in SWEEP_K:
                ms = time_runner(tblock.make_scan_runner(cfg, SWEEP_STEPS, device,
                                                         k_steps=k), s0, SWEEP_STEPS)
                b_ms, b_by = bound(cells, n, k)
                print(f"  {n}^2 tblock_step K={k:2d} {ms:.5f} ms/step "
                      f"({cells * 1e-3 / ms:.1f} MLUPS, {pull_ms / ms:.3f}x "
                      f"pull_step); bound {b_ms:.5f} ms/step by {b_by}", flush=True)
                if n == LARGE_N and k == tblock.K_STEPS:
                    timing["tblock_step"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                                 plain_ms=plain_ms)

        # Where is tblock_step (default K) ahead of pull_step?  Timed in turns
        # (pull, tblock, tblock, pull), each run from the same state after
        # SWEEP_STEPS steps: from the state at rest both kernels run slower
        # (tiny values in the still fluid), tblock_step more so.
        ahead = []
        for n in AHEAD_N:
            cfg = dataclasses.replace(bench_cfg, nx=n, ny=n)
            runners = {"pull": pull.make_scan_runner(cfg, SWEEP_STEPS, device),
                       "tblock": tblock.make_scan_runner(cfg, SWEEP_STEPS, device)}
            s1 = runners["pull"](engine.init_state(cfg, device))
            runners["tblock"](s1)
            ms = {"pull": [], "tblock": []}
            for name in ("pull", "tblock", "tblock", "pull"):
                ms[name].append(cuda_time_ms(lambda: runners[name](s1), 1) / SWEEP_STEPS)
            p_ms, t_ms = sum(ms["pull"]) / 2, sum(ms["tblock"]) / 2
            if p_ms / t_ms > AHEAD_MARGIN:
                ahead.append(n)
            print(f"  {n}^2 in turns: pull_step {ms['pull']} tblock_step "
                  f"K={tblock.K_STEPS} {ms['tblock']} ms/step; tblock/pull "
                  f"{p_ms / t_ms:.3f}x", flush=True)
        print(f"  tblock_step ahead of pull_step by more than {AHEAD_MARGIN - 1:.1%} "
              f"at {ahead}; sim.py routes auto to it from "
              f"{sim.TBLOCK_AUTO_MIN_CELLS} cells", flush=True)

        cells = BENCH_N * BENCH_N
        f0 = engine.init_state(bench_cfg, device).f
        ms = time_runner(push.make_push_scan_runner(bench_cfg, SWEEP_STEPS, device),
                         f0, SWEEP_STEPS)
        b_ms, b_by = bound(cells, BENCH_N)
        timing["push_step"] = dict(
            ms=ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_plain(engine.make_push_oracle_step(bench_cfg), f0))
        print(f"  {BENCH_N}^2 push_step {ms:.5f} ms/step ({cells * 1e-3 / ms:.1f} "
              f"MLUPS); plain {timing['push_step']['plain_ms']:.4f} ms/step; bound "
              f"{b_ms:.5f} ms/step by {b_by}", flush=True)

    print(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": main_launches[name],
        "max_abs_err": worst[name],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,
    } for name in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
