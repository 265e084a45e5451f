"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` builds every ``csrc/*.cu`` into one library (one process
   per source, all started together), or finds it built, and prints each
   kernel's registers and spills (``-Xptxas -v``);
3. exact constant division: ``lbm_cell.cuh``'s ``div_exact<b>`` against the
   IEEE ``x / b`` over all 2^32 inputs, one launch for each b of 6, 9, 12
   and 36: 0 mismatches;
4. kernel vs plain, each from the same start state on the card, to
   ``atol=2e-5`` (an independent float32 implementation: the order of
   operations and FMA contraction differ):
   * ``pull_step`` against 20 plain fused steps (``engine.make_fused_step``)
     for SRT, TRT, MRT, MRT+Smagorinsky and SRT+Smagorinsky+Van Driest at
     128^2 and MRT at 1024^2;
   * ``tblock_step`` (K=8, 20 steps: two launches and four one-step
     remainder launches) against 20 plain fused steps for SRT, TRT, MRT and
     MRT+Smagorinsky at 128^2 and MRT at 2048^2, and (default K) against
     ``pull_step`` over 64 steps at 2048^2, 4096^2 and the Re=100 Ghia
     run's 128^2, which must agree exactly;
   * ``push_step`` against 20 push-oracle steps
     (``engine.make_push_oracle_step``) for the same four cases at 128^2 and
     MRT at 1024^2;
   * on a 2x2 mesh of this one card (``devices=[card] * 4``, each shard with
     its real wall flags and halo strips): ``pull_sharded_step`` (SRT, TRT,
     MRT, MRT+Smagorinsky, SRT+Smagorinsky+Van Driest) and
     ``tblock_sharded_step`` (K=5, the first four) against 20 steps of the
     plain sharded engine at 256^2, and both at the sizes the main path
     runs them (MRT 4096^2 and the Re=100 Ghia case at 128^2, each on the
     2x2 mesh); ``cuda-sharded`` against ``cuda-pull`` over 64 steps at
     4096^2 on 2x2 and 1x4 meshes, which must agree exactly;
     ``tblock_sharded_step`` against ``pull_sharded_step`` over 64 steps at
     4096^2 on 2x2 and 4x1 meshes, which must agree exactly;
   * (a) ``halo_x_exchange`` on a 4096^2 carry set of the tight layout (K=5)
     on 2x2 and 4x1 meshes of the card, filled from a seeded generator,
     against the plain x-phase copies on a copy of it: equal
     (``torch.equal``), and nothing outside the x halos moved; (b) the
     temporal-block sharded runner with ``halo_impl="rdma"`` against
     ``"ppermute"`` at 4096^2 MRT Re=5000 on the same meshes, over 64 and
     67 steps (the latter through the remainder): max |d| = 0;
5. main paths, each launch counter set to 0 just before a run and read just
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
   * the sharded cavity: ``simulate`` at 4096^2 MRT float32 Re=5000 on a
     2x2 mesh of this card with ``backend="auto"`` and through the sharded
     kernel that auto does not take there (``cuda-sharded`` or
     ``cuda-sharded-tblock``), in the order auto, other, other, auto; the
     Re=100 Ghia gate at 128^2 on the 2x2 mesh through ``cuda-sharded``;
   * the x-ring exchange: the temporal-block sharded runner with
     ``halo_impl="rdma"`` at 4096^2 on the 2x2 mesh in 500-step calls, and
     the Re=100 Ghia gate at 128^2 on the 2x2 mesh through it;
   * (c) the remote form: two processes on the card (a ``gloo`` group on a
     ``file://`` store), after a probe that CUDA IPC maps memory between
     them; on a (2, 1) mesh at 1024^2 MRT, the ``"rdma"`` runner (x strips
     written through IPC into the other process's carries) and the
     ``"ppermute"`` runner (x strips sent through host-staged ``gloo``),
     gathered on rank 0, against the one-process mesh over 64 steps: max
     |d| = 0; and the two-process exchange's time with its host barriers;
6. timing with CUDA events: the measured device-copy bandwidth; the
   benchmark's 1024^2 MRT cavity through ``pull_step`` (MLUPS); at 1024^2
   and 2048^2, ``pull_step`` beside ``tblock_step`` for K in ``SWEEP_K``;
   at 1024^2, 2048^2 and 4096^2, ``pull_step`` and ``tblock_step`` (default
   K) in turns from rest and from the state after 1 920 steps, which sets
   where ``auto`` takes the latter;
   ``push_step`` at 1024^2; each kernel's plain version; at 4096^2 on the
   2x2 mesh: both sharded runners from rest in ``simulate``'s calls, with
   the one-step runner's pad and unpad copies timed apart; from a state
   further on,
   ``pull_sharded_step`` and ``tblock_sharded_step`` (default K) with the
   halo exchange timed apart, and the two sharded runners in turns, which
   with the main path's MLUPS sets where ``auto`` takes the temporal-block
   one; (d) at 4096^2 on the 2x2 mesh, ``halo_x_exchange`` alone, the same
   strips by ``copy_pairs`` (its plain version and the library time), its
   bound, and the two temporal-block runners (``"rdma"``, ``"ppermute"``)
   in turns from the state 7 680 steps on.

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

import torch.distributed as dist
from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import engine, sim
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import (
    _build,
    halo_rdma,
    pull,
    pull_sharded,
    push,
    tblock,
    tblock_sharded,
)
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    make_sharded_fused_step,
    make_sharded_scan_runner,
    multihost,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate
from latticeboltzmannsimulations_torch.validate import compare_to_ghia

ATOL = 2e-5
# The temporal-block kernels do the one-step kernels' arithmetic in the same
# order: they must agree exactly.
TBLOCK_VS_PULL_ATOL = 0.0
# The TPU kernel each CUDA kernel replaces, in the JAX package.
REPLACES = {
    "pull_step": "kernels/pallas_pull.py:189 (_make_kernel)",
    "tblock_step": "kernels/pallas_pull_tblock.py:72 (_make_kernel)",
    "push_step": "kernels/pallas_push.py:65 (_make_kernel)",
    "pull_sharded_step": "kernels/pallas_pull_sharded.py:84 (_make_local_kernel)",
    "tblock_sharded_step": "kernels/pallas_pull_tblock_sharded.py:57 (_make_kernel)",
    "halo_x_exchange": ("kernels/halo_rdma.py:137 (make_x_halo_exchange; "
                        "_make_local_kernel :57, _make_remote_kernel :85)"),
}
SOURCES = {name: f"latticeboltzmannsimulations_torch/csrc/{name}.cu" for name in REPLACES}
COUNTERS = {"pull_step": pull, "tblock_step": tblock, "push_step": push,
            "pull_sharded_step": pull_sharded, "tblock_sharded_step": tblock_sharded,
            "halo_x_exchange": halo_rdma}
COMPARE_STEPS = 20
TBLOCK_COMPARE_K = 8
BENCH_N = 1024
LARGE_N = 2048
BENCH_CHUNK = 10_000
BENCH_CHUNKS = 3
SWEEP_STEPS = 1_920                # a multiple of every K of the sweep
SWEEP_K = (4, 5, 6, 8, 10, 12, 16)
# The divisors of lbm_cell.cuh's exact constant division, each checked over
# all 2^32 inputs.
DIVISORS = (6, 9, 12, 36)
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
# The sharded cavity: the BASELINE's scale-out size, on a 2x2 mesh of this
# one card (and a 1x4 mesh for the comparison with pull_step).
SHARDED_N = 4096
SHARDED_MESH = (2, 2)
SHARDED_COMPARE_N = 256
SHARDED_STEPS = SWEEP_STEPS        # a multiple of the sharded tblock's K
SHARDED_WARM_STEPS = 4 * SHARDED_STEPS   # steps before the sharded timing
# The x-ring exchange: the meshes of the card it is checked on, the steps of
# the runner comparison (the second runs through the remainder), the
# two-process case, and the launches per timing.
RDMA_MESHES = (SHARDED_MESH, (4, 1))
RDMA_COMPARE_STEPS = (64, 67)
IPC_N = 1024
IPC_MESH = (2, 1)
IPC_STEPS = 64
EXCHANGE_REPS = 200
IPC_EXCHANGE_REPS = 50


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
    """The temporal-block kernel (default K) against the one-step
    kernel over n steps (the remainder through the latter): the same
    arithmetic in the same order, so they must agree exactly."""
    s0 = engine.init_state(cfg, device)
    a = tblock.make_scan_runner(cfg, n, device)(s0)
    b = pull.make_scan_runner(cfg, n, device)(s0)
    return check_close(f"tblock K={tblock.K_STEPS} vs pull_step, {n} steps", cfg,
                       a.f, b.f, a.rho_lid, b.rho_lid, atol=TBLOCK_VS_PULL_ATOL)


def check_exact_division(device) -> dict:
    """lbm_cell.cuh's div_exact<b> against the IEEE x / b over all 2^32
    inputs, one launch per divisor: no input may differ."""
    lib = _build.load_library()
    found = {}
    for b in DIVISORS:
        mismatches = torch.zeros(1, dtype=torch.int64, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.lbm_exact_div_check(b, None, 1 << 32, mismatches.data_ptr(),
                                      torch.cuda.current_stream(device).cuda_stream)
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"exact_div_check launch failed: "
                               f"{lib.lbm_error_string(err).decode()}")
        found[b] = mismatches.item()
        print(f"  div_exact<{b}> vs x / {b} over all 2^32 inputs: {found[b]} "
              f"mismatches ({start.elapsed_time(end):.1f} ms)", flush=True)
    if any(found.values()):
        raise AssertionError(f"the exact division differs from x / b: {found}")
    return found


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


def sharded_mesh(device, shape=SHARDED_MESH):
    """A mesh of ``shape`` shards, every one on this card."""
    return make_mesh(shape, [device] * (shape[0] * shape[1]))


def compare_sharded(name: str, cfg: SimConfig, device, module) -> float:
    """20 steps of a sharded kernel's runner (``module``: ``pull_sharded`` or
    ``tblock_sharded`` at its default K) against 20 steps of the plain
    sharded engine, on a mesh of this card."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device), mesh)
    plain = unshard_state(make_sharded_scan_runner(cfg, COMPARE_STEPS, mesh)(s0), device)
    out = unshard_state(module.make_sharded_runner(cfg, COMPARE_STEPS, mesh)(s0), device)
    kernel = module.__name__.rsplit(".", 1)[1]
    return check_close(f"{kernel} {name} mesh {cfg.mesh_shape}", cfg, out.f, plain.f,
                       out.rho_lid, plain.rho_lid)


def compare_sharded_pull(cfg: SimConfig, device, n: int) -> float:
    """``cuda-sharded`` against ``cuda-pull`` on the global grid over n
    steps: the same arithmetic, the wrap supplied by the halo, so they must
    agree exactly."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = engine.init_state(cfg, device)
    a = unshard_state(pull_sharded.make_sharded_runner(cfg, n, mesh)(
        shard_state(s0, mesh)), device)
    b = pull.make_scan_runner(dataclasses.replace(cfg, mesh_shape=(1, 1)), n, device)(s0)
    return check_close(f"cuda-sharded vs pull_step, {n} steps, mesh {cfg.mesh_shape}",
                       cfg, a.f, b.f, a.rho_lid, b.rho_lid, atol=0.0)


def compare_tblock_sharded_pull(cfg: SimConfig, device, n: int) -> float:
    """The sharded temporal-block kernel against the sharded one-step kernel
    over n steps (blocks of the default K, the remainder through the
    latter)."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device), mesh)
    a = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh)(s0), device)
    b = unshard_state(pull_sharded.make_sharded_runner(cfg, n, mesh)(s0), device)
    return check_close(f"tblock_sharded K={tblock_sharded.K_STEPS} vs pull_sharded, "
                       f"{n} steps, mesh {cfg.mesh_shape}", cfg, a.f, b.f,
                       a.rho_lid, b.rho_lid, atol=TBLOCK_VS_PULL_ATOL)


def noisy_state(cfg: SimConfig, device, seed: int = 7) -> engine.State:
    """The start state with seeded noise (1e-3 relative), so that every
    population of every strip moves."""
    s = engine.init_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(s.f.shape, generator=gen, device=device)
    return engine.State(s.f * (1.0 + 1e-3 * noise), s.rho_lid)


def random_carries(device, shape, lay: halo.Layout, seed: int = 7):
    """Carries of the tight layout and their lid panels on a mesh ``shape``
    of this card, filled from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mx, my = shape
    width = lay.lx + 2 * lay.depth

    def blocks(*size):
        return tuple(tuple(torch.rand(size, generator=gen, device=device)
                           for _ in range(my)) for _ in range(mx))

    return blocks(9, width, lay.pitch), blocks(width)


def compare_x_exchange(device, shape, n: int = SHARDED_N) -> float:
    """(a) The exchange kernel on an n^2 carry set (K=5) against the plain
    x-phase copies on a copy of it: equal, one launch for the whole mesh of
    this card, and the cells and y halos untouched."""
    mx, my = shape
    k = tblock_sharded.K_STEPS
    lay = halo.Layout.tight(n // mx, n // my, k)
    carries, panels = random_carries(device, shape, lay)
    copies = [tuple(tuple(tuple(b.clone() for b in col) for col in blocks)
                    for blocks in (carries, panels)) for _ in range(2)]
    plain, orig = copies
    exchange = halo_rdma.make_x_halo_exchange(sharded_mesh(device, shape), carries,
                                              panels, lay)
    before = halo_rdma.launches
    exchange()
    launched = halo_rdma.launches - before
    halo.copy_pairs(halo.move_pairs(halo_rdma.x_moves(*plain, lay)))
    torch.cuda.synchronize()
    err, equal = 0.0, True
    for ix in range(mx):
        for iy in range(my):
            for got, want, was in zip((carries, panels), plain, orig):
                a, b, c = got[ix][iy], want[ix][iy], was[ix][iy]
                # the cells and y halos: every x position but the x halos
                inner = (slice(k, k + lay.lx),) if a.dim() == 1 else (slice(None),
                                                                       slice(k, k + lay.lx))
                err = max(err, (a - b).abs().max().item())
                equal &= torch.equal(a, b) and torch.equal(a[inner], c[inner])
    print(f"  halo_x_exchange {n}^2 K={k} mesh {shape}: {launched} launch, "
          f"max|d| vs the plain x-phase copies {err:.3e}, equal and nothing else "
          f"moved: {equal}", flush=True)
    if launched != 1:
        raise AssertionError(f"halo_x_exchange: {launched} launches for one card, not 1")
    if not equal or err != 0.0:
        raise AssertionError(f"halo_x_exchange differs from the plain copies on {shape}")
    return err


def compare_rdma_runner(cfg: SimConfig, device, n: int) -> float:
    """(b) The temporal-block sharded runner with the exchange kernel
    against the one with strip copies, over n steps from a seeded noisy
    state: they move the same values, so they must agree exactly."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(noisy_state(cfg, device), mesh)
    before = halo_rdma.launches
    a = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh, halo_impl="rdma")(s0),
                      device)
    launched = halo_rdma.launches - before
    b = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh)(s0), device)
    print(f"  rdma runner: {launched} halo_x_exchange launches in {n} steps", flush=True)
    if launched != n // tblock_sharded.K_STEPS:
        raise AssertionError("the rdma runner did not launch the exchange once per block")
    return check_close(f"tblock_sharded rdma vs ppermute, {n} steps, mesh "
                       f"{cfg.mesh_shape}", cfg, a.f, b.f, a.rho_lid, b.rho_lid, atol=0.0)


def ipc_probe(rank: int, device) -> None:
    """Does CUDA IPC map memory between the two processes?  Each offers a
    buffer, opens the other's, reads it and writes into it."""
    mine = torch.full((1 << 20,), float(rank + 1), device=device)
    offers = [None, None]
    dist.all_gather_object(offers, reduce_tensor(mine)[1])
    theirs = rebuild_cuda_tensor(*offers[1 - rank])
    seen = theirs.sum().item()
    theirs[:1] = -1.0
    torch.cuda.synchronize()
    dist.barrier()
    ok = seen == float(2 - rank) * (1 << 20) and mine[0].item() == -1.0
    del theirs
    torch.cuda.synchronize()
    dist.barrier()
    if not ok:
        raise AssertionError(f"rank {rank}: CUDA IPC read {seen}, own first value "
                             f"{mine[0].item()}")


def two_process_run(rank: int, out_path: str) -> None:
    """(c) In each of two processes on the card: the IPC probe; then both
    temporal-block runners on a (2, 1) mesh spanning the processes at
    1024^2 MRT, gathered on rank 0 against the same runner on a mesh of one
    process; then the x phase alone in both forms, with its host ordering.
    Rank 0 writes what it found to ``out_path``."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ipc_probe(rank, device)
    cfg = SimConfig(nx=IPC_N, ny=IPC_N, reynolds=5000.0, collision="mrt",
                    precision="float32", mesh_shape=IPC_MESH).validate()
    pod = multihost.make_pod_mesh(IPC_MESH, [device])
    s0 = noisy_state(cfg, device)
    if rank == 0:
        one = sharded_mesh(device, IPC_MESH)
        ref = unshard_state(tblock_sharded.make_sharded_runner(cfg, IPC_STEPS, one)(
            shard_state(s0, one)), device)
    found = {"rank_shards": pod.local_shards()}
    for impl in ("rdma", "ppermute"):
        before = (halo_rdma.launches, halo.sends, halo.staged)
        out = unshard_state(tblock_sharded.make_sharded_runner(
            cfg, IPC_STEPS, pod, halo_impl=impl)(shard_state(s0, pod)), device, pod)
        counts = [a - b for a, b in zip((halo_rdma.launches, halo.sends, halo.staged),
                                        before)]
        found[impl] = {"launches": counts[0], "sends": counts[1], "staged": counts[2]}
        if rank == 0:
            found[impl]["max_abs_err"] = max((out.f - ref.f).abs().max().item(),
                                             (out.rho_lid - ref.rho_lid).abs().max().item())
    k = tblock_sharded.K_STEPS
    lay = halo.Layout.tight(IPC_N // IPC_MESH[0], IPC_N // IPC_MESH[1], k)
    state = shard_state(s0, pod)
    carries, panels = halo.pad_blocks(state.f, lay), halo.pad_rows(state.rho_lid, k)
    forms = {"rdma": halo_rdma.make_x_halo_exchange(pod, carries, panels, lay),
             "ppermute": halo.Transfer(pod, halo_rdma.x_moves(carries, panels, lay))}
    for name in ("rdma", "ppermute", "ppermute", "rdma"):
        forms[name]()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(IPC_EXCHANGE_REPS):
            forms[name]()
        torch.cuda.synchronize()
        found.setdefault(f"{name}_exchange_ms", []).append(
            (time.perf_counter() - t0) * 1e3 / IPC_EXCHANGE_REPS)
    forms["rdma"].close()
    if rank == 0:
        with open(out_path, "w") as fh:
            json.dump(found, fh)


def run_two_processes() -> dict:
    """Spawn the two processes of (c) and return what rank 0 found."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = f"{tmp}/found.json"
        multihost.spawn(two_process_run, 2, f"{tmp}/store", args=(out_path,),
                        backend="gloo", timeout=300)
        with open(out_path) as fh:
            return json.load(fh)


def time_x_exchange(cfg: SimConfig, device, state, copy_bw: float) -> dict:
    """(d) Device ms of one exchange on the mesh at K=5 from ``state``'s
    carries: the kernel's one launch and the same strips by ``copy_pairs``
    (its plain version, and the library time), in turns; and its bound."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    k = tblock_sharded.K_STEPS
    lay = halo.Layout.tight(cfg.nx // cfg.mesh_shape[0], cfg.ny // cfg.mesh_shape[1], k)
    carries, panels = halo.pad_blocks(state.f, lay), halo.pad_rows(state.rho_lid, k)
    halo.copy_pairs(halo.halo_pairs(carries, lay) + halo.row_halo_pairs(panels, k))
    pairs = halo.move_pairs(halo_rdma.x_moves(carries, panels, lay))
    forms = {"kernel": halo_rdma.make_x_halo_exchange(mesh, carries, panels, lay),
             "copies": lambda: halo.copy_pairs(pairs)}
    ms = {name: [] for name in forms}
    for name in ("kernel", "copies", "copies", "kernel"):
        forms[name]()
        ms[name].append(cuda_time_ms(forms[name], EXCHANGE_REPS))
    strip_bytes = 2 * sum(src.numel() * src.element_size() for _, src in pairs)
    out = dict(ms=sum(ms["kernel"]) / 2, plain_ms=sum(ms["copies"]) / 2,
               bound_ms=strip_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
               copy_bound_ms=strip_bytes / copy_bw * 1e3, strips=len(pairs),
               strip_bytes=strip_bytes, turns=ms)
    out["library_ms"] = out["plain_ms"]
    return out


def sharded_bound(cfg: SimConfig, k_steps: int = 1) -> tuple[float, str]:
    """Least ms per step of a sharded kernel over the whole mesh, at the
    published peaks: each shard's carry with its halo ring (k_steps deep)
    and its lid densities read once and its cells written once per launch
    of k_steps steps, or the operations of one step on every cell."""
    mx, my = cfg.mesh_shape
    lx, ly = cfg.nx // mx, cfg.ny // my
    d = k_steps
    per_shard = (36 * (lx + 2 * d) * (ly + 2 * d) + 36 * lx * ly
                 + 2 * 4 * (lx + 2 * d))
    bytes_ms = mx * my * per_shard / k_steps / PEAK_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_CELL_MRT * cfg.nx * cfg.ny / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_sharded(cfg: SimConfig, device, state, k_steps: int | None) -> dict:
    """Device ms per step on the mesh of a sharded kernel's runner
    (``k_steps`` None: the one-step kernel; else the temporal-block one),
    from ``state``: the whole runner; then, on buffers with the runner's
    layout, views and launch arguments, the halo exchange alone and the
    kernel launches alone, these both from buffer to buffer as in the
    runner, so the flow moves on (``ms``), and again and again on the
    same input (``fixed_ms``); and the plain version."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    lx, ly = cfg.nx // cfg.mesh_shape[0], cfg.ny // cfg.mesh_shape[1]
    if k_steps is None:
        runner = pull_sharded.make_sharded_runner(cfg, SHARDED_STEPS, mesh)
        lay, per_launch = pull_sharded.layout(lx, ly), 1
    else:
        runner = tblock_sharded.make_sharded_runner(cfg, SHARDED_STEPS, mesh, k_steps)
        lay, per_launch = halo.Layout.tight(lx, ly, k_steps), k_steps
    runner(state)
    out = dict(full_ms=cuda_time_ms(lambda: runner(state), 1) / SHARDED_STEPS)
    n = SHARDED_STEPS // per_launch
    carries = [halo.pad_blocks(state.f, lay)]
    rows = [halo.pad_rows(state.rho_lid, 0 if k_steps is None else k_steps)]
    exchange = halo.halo_pairs(carries[0], lay)
    if k_steps is not None:
        exchange += halo.row_halo_pairs(rows[0], k_steps)
    halo.copy_pairs(exchange)
    # the second buffers start as copies, so their rings hold the flow's values
    carries.append(tuple(tuple(c.clone() for c in col) for col in carries[0]))
    rows.append(tuple(tuple(r.clone() for r in col) for col in rows[0]))
    calls = []
    for src in (0, 1):
        dst = 1 - src
        if k_steps is None:
            calls.append([(mesh.device(ix, iy), pull_sharded._shard_call(
                cfg, lay, carries[src][ix][iy], rows[src][ix][iy],
                halo.edge_flags(mesh.shape, ix, iy), None, carries[dst][ix][iy],
                rows[dst][ix][iy])) for ix, iy in mesh.shards()])
        else:
            calls.append([(mesh.device(ix, iy), tblock_sharded._block_call(
                cfg, carries[src][ix][iy], rows[src][ix][iy], (ix * lx, iy * ly),
                carries[dst][ix][iy], rows[dst][ix][iy], k_steps))
                for ix, iy in mesh.shards()])
    out["exchange_ms"] = cuda_time_ms(lambda: halo.copy_pairs(exchange), n) / per_launch
    out["fixed_ms"] = cuda_time_ms(lambda: pull_sharded.run_calls(calls[0]), n) / per_launch

    def both():
        pull_sharded.run_calls(calls[0])
        pull_sharded.run_calls(calls[1])

    out["ms"] = cuda_time_ms(both, n // 2) / (2 * per_launch)
    if k_steps is None:
        out["plain_ms"] = time_plain(make_sharded_fused_step(cfg, mesh), state, reps=3)
    else:
        out["plain_ms"] = cuda_time_ms(lambda: [
            tblock_sharded.plain_block(cfg, carries[0][ix][iy], rows[0][ix][iy],
                                       (ix * lx, iy * ly), k_steps)
            for ix, iy in mesh.shards()], 1) / k_steps
    return out


def reset_counters() -> None:
    for module in COUNTERS.values():
        module.launches = 0


def read_counters() -> dict:
    return {name: module.launches for name, module in COUNTERS.items()}


def run_main_path(cfg: SimConfig, device, out_dir: str, backend: str,
                  expect: str | None, gates: dict | None = None,
                  mlups: list | None = None) -> dict:
    """``simulate`` through ``backend``; checks the route (when ``expect``
    is given), the launches of the routed kernel against the steps, a
    finite field and the Ghia gates.  Returns the launch counts, and
    appends the run's MLUPS to ``mlups`` where given."""
    reset_counters()
    halo.copies = 0
    summary = simulate(cfg, SimOptions(out_dir=out_dir, verbose=False,
                                       backend=backend), device=device)
    torch.cuda.synchronize()
    counts = read_counters()
    copies = f" halo copies={halo.copies}" if halo.copies else ""
    print(f"  {cfg.describe()} backend={backend}: routed to {summary.backend}, "
          f"steps={summary.steps} launches={counts}{copies} "
          f"MLUPS={summary.mlups:.1f} r2_ux={summary.r2_ux} r2_uy={summary.r2_uy} "
          f"l2={summary.l2_combined}", flush=True)
    if expect is not None and summary.backend != expect:
        raise AssertionError(f"routed to {summary.backend!r}, not {expect!r}")
    if not math.isfinite(summary.mlups):
        raise AssertionError("non-finite MLUPS")
    if mlups is not None:
        mlups.append(summary.mlups)
    steps, chunks = summary.steps, summary.steps // cfg.report_interval
    blocks, rem = divmod(cfg.report_interval, tblock.K_STEPS)
    s_blocks, s_rem = divmod(cfg.report_interval, tblock_sharded.K_STEPS)
    shards = cfg.mesh_shape[0] * cfg.mesh_shape[1]
    want = {name: 0 for name in COUNTERS}
    want.update({
        "cuda-pull": {"pull_step": steps},
        "cuda-tblock": {"pull_step": chunks * rem, "tblock_step": chunks * blocks},
        "cuda-push": {"push_step": steps},
        "cuda-sharded": {"pull_sharded_step": shards * steps},
        "cuda-sharded-tblock": {"pull_sharded_step": shards * chunks * s_rem,
                                "tblock_sharded_step": shards * chunks * s_blocks},
    }.get(summary.backend, {}))
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

    with phase("exact constant division"):
        check_exact_division(device)

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
        # bit for bit against the one-step kernel at the sizes the main path
        # runs it (the large cavity, 4096^2 and the Re=100 Ghia run's 128^2)
        for cfg in (large_cfg, dataclasses.replace(bench_cfg, nx=4096, ny=4096),
                    SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt")):
            worst["tblock_step"] = max(worst["tblock_step"],
                                       compare_tblock_pull(cfg, device, 64))
        for name, kw in small:
            worst["push_step"] = max(worst["push_step"], compare_push(
                name, SimConfig(nx=128, ny=128, **kw), device))
        worst["push_step"] = max(worst["push_step"],
                                 compare_push("mrt", bench_cfg, device))

    with phase("kernel vs plain: sharded"):
        n = SHARDED_COMPARE_N
        for name, kw in small + [vd]:
            cfg = SimConfig(nx=n, ny=n, mesh_shape=SHARDED_MESH, **kw)
            worst["pull_sharded_step"] = max(worst["pull_sharded_step"],
                                             compare_sharded(name, cfg, device, pull_sharded))
            if name != vd[0]:
                worst["tblock_sharded_step"] = max(
                    worst["tblock_sharded_step"],
                    compare_sharded(name, cfg, device, tblock_sharded))
        sharded_cfg = dataclasses.replace(bench_cfg, nx=SHARDED_N, ny=SHARDED_N,
                                          mesh_shape=SHARDED_MESH)
        sharded_ghia = SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt",
                                 max_steps=16_000, report_interval=2_000,
                                 mesh_shape=SHARDED_MESH)
        # both kernels at the shapes the main path gives them
        for name, cfg in (("mrt", sharded_cfg), ("mrt re=100", sharded_ghia)):
            for module in (pull_sharded, tblock_sharded):
                key = module.__name__.rsplit(".", 1)[1] + "_step"
                worst[key] = max(worst[key], compare_sharded(name, cfg, device, module))
        for shape in (SHARDED_MESH, (1, 4)):
            compare_sharded_pull(dataclasses.replace(sharded_cfg, mesh_shape=shape),
                                 device, 64)
        for shape in RDMA_MESHES:
            worst["tblock_sharded_step"] = max(
                worst["tblock_sharded_step"], compare_tblock_sharded_pull(
                    dataclasses.replace(sharded_cfg, mesh_shape=shape), device, 64))

    with phase("kernel vs plain: x-ring exchange"):
        # at both shapes the main path gives the kernel: 4096^2 and the
        # Re=100 Ghia run's 128^2
        for shape, n in [(s, SHARDED_N) for s in RDMA_MESHES] + [
                (SHARDED_MESH, sharded_ghia.nx)]:
            worst["halo_x_exchange"] = max(worst["halo_x_exchange"],
                                           compare_x_exchange(device, shape, n))
        for cfg in [dataclasses.replace(sharded_cfg, mesh_shape=s) for s in RDMA_MESHES] + [
                sharded_ghia]:
            for n in RDMA_COMPARE_STEPS:
                worst["halo_x_exchange"] = max(worst["halo_x_exchange"],
                                               compare_rdma_runner(cfg, device, n))

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
    with phase("main path: sharded cavity"), tempfile.TemporaryDirectory() as tmp:
        mesh_devices = [device] * (SHARDED_MESH[0] * SHARDED_MESH[1])
        sharded_run = dataclasses.replace(sharded_cfg, max_steps=2_000,
                                          report_interval=500)
        # auto, then the sharded kernel auto did not take, in the order
        # auto, other, other, auto (the first run of a size is slower)
        sharded_mlups = {"auto": [], "other": []}
        counts = run_main_path(sharded_run, mesh_devices, tmp, "auto", None,
                               mlups=sharded_mlups["auto"])
        add_counts(main_launches, counts)
        other = ("cuda-sharded" if counts["pull_sharded_step"] == 0
                 else "cuda-sharded-tblock")
        for key, backend in (("other", other), ("other", other), ("auto", "auto")):
            add_counts(main_launches, run_main_path(
                sharded_run, mesh_devices, tmp, backend,
                None if backend == "auto" else other, mlups=sharded_mlups[key]))
        auto_name = "cuda-sharded-tblock" if other == "cuda-sharded" else "cuda-sharded"
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} simulate MLUPS, mean of two: "
              f"auto ({auto_name}) {sum(sharded_mlups['auto']) / 2:.1f}, {other} "
              f"{sum(sharded_mlups['other']) / 2:.1f}", flush=True)
        add_counts(main_launches, run_main_path(
            sharded_ghia, mesh_devices, tmp, "cuda-sharded", "cuda-sharded",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))

    with phase("main path: x-ring exchange"):
        # The runner with halo_impl="rdma" (simulate does not route to it, as
        # the JAX package's does not), in simulate's 500-step calls.
        reset_counters()
        halo.copies = 0
        mesh = sharded_mesh(device)
        interval = sharded_run.report_interval
        runner = tblock_sharded.make_sharded_runner(sharded_cfg, interval, mesh,
                                                    halo_impl="rdma")
        s = shard_state(engine.init_state(sharded_cfg, device), mesh)
        calls = sharded_run.max_steps // interval
        for _ in range(calls):
            s = runner(s)
        torch.cuda.synchronize()
        counts = read_counters()
        shards = SHARDED_MESH[0] * SHARDED_MESH[1]
        blocks = calls * (interval // tblock_sharded.K_STEPS)
        want = {name: 0 for name in COUNTERS}
        want.update(halo_x_exchange=blocks, tblock_sharded_step=shards * blocks)
        finite = all(bool(torch.isfinite(b).all()) for col in s.f for b in col)
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} rdma runner, {calls} calls of "
              f"{interval} steps: launches={counts} halo copies={halo.copies} "
              f"finite={finite}", flush=True)
        if counts != want or not finite:
            raise AssertionError(f"rdma runner: launches {counts}, expected {want}")
        add_counts(main_launches, counts)
        # the Re=100 Ghia gate through it, on the 2x2 mesh at 128^2
        reset_counters()
        chunk = sharded_ghia.report_interval
        runner = tblock_sharded.make_sharded_runner(sharded_ghia, chunk, mesh,
                                                    halo_impl="rdma")
        s = shard_state(engine.init_state(sharded_ghia, device), mesh)
        for _ in range(sharded_ghia.max_steps // chunk):
            s = runner(s)
        _, u = halo.sharded_observables(sharded_ghia, mesh)(s)
        ghia = compare_to_ghia(u.cpu().numpy(), sharded_ghia.u_lid, sharded_ghia.reynolds)
        counts = read_counters()
        add_counts(main_launches, counts)
        blocks = sharded_ghia.max_steps // tblock_sharded.K_STEPS   # chunk % K == 0
        want = {name: 0 for name in COUNTERS}
        want.update(halo_x_exchange=blocks, tblock_sharded_step=shards * blocks)
        print(f"  {sharded_ghia.describe()} rdma runner, {sharded_ghia.max_steps} steps: "
              f"launches={counts} r2_ux={ghia.r2_ux} r2_uy={ghia.r2_uy} "
              f"l2={ghia.l2_combined}", flush=True)
        if counts != want:
            raise AssertionError(f"rdma runner at 128^2: launches {counts}, expected {want}")
        if not (ghia.r2_ux > 0.99 and ghia.l2_combined < 0.05):
            raise AssertionError(f"Ghia gate failed through the rdma runner: {ghia}")
        del s, runner

    with phase("remote form: two processes on the card"):
        remote = run_two_processes()
        print(f"  {IPC_N}^2 mesh {IPC_MESH} across two processes, {IPC_STEPS} steps: "
              f"{json.dumps(remote)}", flush=True)
        for impl in ("rdma", "ppermute"):
            if remote[impl]["max_abs_err"] != 0.0:
                raise AssertionError(f"two processes, {impl}: differs from one process")
        if remote["rdma"]["launches"] == 0 or remote["ppermute"]["sends"] == 0:
            raise AssertionError("the two-process runs did not cross processes")

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
        # (pull, tblock, tblock, pull), from rest and from the state after
        # SWEEP_STEPS steps (a flow at rest has run slower: PERF.md, section
        # 7); it counts as ahead only where both readings put it ahead.
        ahead = []
        for n in AHEAD_N:
            cfg = dataclasses.replace(bench_cfg, nx=n, ny=n)
            runners = {"pull": pull.make_scan_runner(cfg, SWEEP_STEPS, device),
                       "tblock": tblock.make_scan_runner(cfg, SWEEP_STEPS, device)}
            s0 = engine.init_state(cfg, device)
            s1 = runners["pull"](s0)
            runners["tblock"](s1)
            ratios = []
            for label, s in (("rest", s0), ("further on", s1)):
                ms = {"pull": [], "tblock": []}
                for name in ("pull", "tblock", "tblock", "pull"):
                    ms[name].append(cuda_time_ms(lambda: runners[name](s), 1) / SWEEP_STEPS)
                p_ms, t_ms = sum(ms["pull"]) / 2, sum(ms["tblock"]) / 2
                ratios.append(p_ms / t_ms)
                print(f"  {n}^2 in turns from {label}: pull_step {ms['pull']} tblock_step "
                      f"K={tblock.K_STEPS} {ms['tblock']} ms/step; "
                      f"tblock/pull {p_ms / t_ms:.3f}x", flush=True)
            if min(ratios) > AHEAD_MARGIN:
                ahead.append(n)
            del s0, s1
        print(f"  tblock_step ahead of pull_step by more than {AHEAD_MARGIN - 1:.1%} "
              f"from rest and further on at {ahead}; sim.py routes auto to it from "
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

    with phase("timing: sharded"):
        mesh = sharded_mesh(device)
        cells = SHARDED_N * SHARDED_N
        # Both sharded runners from rest in simulate's calls of
        # report_interval steps over the main path's steps, and the one-step
        # runner's pad and unpad copies (made once per call).
        s0 = shard_state(engine.init_state(sharded_cfg, device), mesh)
        interval = sharded_run.report_interval
        rest_ms = {}
        for name, module in (("cuda-sharded", pull_sharded),
                             ("cuda-sharded-tblock", tblock_sharded)):
            chunk = module.make_sharded_runner(sharded_cfg, interval, mesh)

            def from_rest():
                s = s0
                for _ in range(sharded_run.max_steps // interval):
                    s = chunk(s)

            rest_ms[name] = cuda_time_ms(from_rest, 1) / sharded_run.max_steps
        lay = pull_sharded.layout(SHARDED_N // SHARDED_MESH[0], SHARDED_N // SHARDED_MESH[1])
        pad_ms = cuda_time_ms(lambda: halo.unpad_blocks(halo.pad_blocks(s0.f, lay), lay), 5)
        one = rest_ms["cuda-sharded"]
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} runners from rest in {interval}-step "
              f"calls: {rest_ms} ms/step ({cells * 1e-3 / one:.1f} MLUPS one-step); "
              f"tblock/one-step {one / rest_ms['cuda-sharded-tblock']:.3f}x; pad + unpad "
              f"{pad_ms:.4f} ms per call ({pad_ms / (one * interval):.4f} of a one-step "
              f"call)", flush=True)
        # The rest from the state after SHARDED_WARM_STEPS steps of the
        # one-step kernel.
        warm = pull_sharded.make_sharded_runner(sharded_cfg, SHARDED_STEPS, mesh)
        s1 = s0
        for _ in range(SHARDED_WARM_STEPS // SHARDED_STEPS):
            s1 = warm(s1)
        del s0, chunk, warm
        # pull_step on the same cells and state, launched alone as the
        # sharded kernels are below
        one_cfg = dataclasses.replace(sharded_cfg, mesh_shape=(1, 1))
        g1 = unshard_state(s1, device)
        out = engine.State(torch.empty_like(g1.f), torch.empty_like(g1.rho_lid))
        pull_ms = cuda_time_ms(lambda: pull.pull_step(one_cfg, g1.f, g1.rho_lid, out.f,
                                                      out.rho_lid), SHARDED_STEPS)
        del g1, out
        print(f"  {SHARDED_N}^2 pull_step on the same state, launched alone "
              f"{pull_ms:.5f} ms/step ({cells * 1e-3 / pull_ms:.1f} MLUPS)", flush=True)
        for name, k in (("pull_sharded_step", None),
                        ("tblock_sharded_step", tblock_sharded.K_STEPS)):
            t = time_sharded(sharded_cfg, device, s1, k)
            t["bound_ms"], t["bound_by"] = sharded_bound(sharded_cfg, k or 1)
            timing[name] = t
            print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} {name}"
                  f"{'' if k is None else f' K={k}'}: runner {t['full_ms']:.5f} "
                  f"ms/step ({cells * 1e-3 / t['full_ms']:.1f} MLUPS); kernel launches "
                  f"alone {t['ms']:.5f} ms/step (on one fixed input "
                  f"{t['fixed_ms']:.5f}); halo exchange alone "
                  f"{t['exchange_ms']:.5f} ms/step ({t['exchange_ms'] / t['full_ms']:.3f} "
                  f"of the runner); plain {t['plain_ms']:.4f} ms/step; bound "
                  f"{t['bound_ms']:.5f} ms/step by {t['bound_by']}", flush=True)

        # Is the temporal-block runner ahead of the one-step one?  In turns,
        # from the state after SHARDED_WARM_STEPS steps.
        runners = {
            "cuda-sharded": pull_sharded.make_sharded_runner(sharded_cfg, SHARDED_STEPS, mesh),
            "cuda-sharded-tblock": tblock_sharded.make_sharded_runner(
                sharded_cfg, SHARDED_STEPS, mesh)}
        ms = {name: [] for name in runners}
        for name in ("cuda-sharded", "cuda-sharded-tblock", "cuda-sharded-tblock",
                     "cuda-sharded") * 2:
            ms[name].append(cuda_time_ms(lambda: runners[name](s1), 1) / SHARDED_STEPS)
        one, blk = (sum(ms[n]) / len(ms[n]) for n in runners)
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} in turns: {ms} ms/step; "
              f"tblock/one-step {one / blk:.3f}x; ahead by more than "
              f"{AHEAD_MARGIN - 1:.1%}: {one / blk > AHEAD_MARGIN}; sim.py routes auto "
              f"to it for shards of {sim.SHARDED_TBLOCK_AUTO_MIN_CELLS} cells", flush=True)
        # (d) the x-ring exchange: the kernel alone against the same strips by
        # copy_pairs, and the temporal-block runner with each x phase, in
        # turns, from the same state
        t = time_x_exchange(sharded_cfg, device, s1, copy_bw)
        timing["halo_x_exchange"] = t
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} K={tblock_sharded.K_STEPS} x-ring "
              f"exchange of {t['strips']} strips, {t['strip_bytes']} B read + written: "
              f"halo_x_exchange {t['ms']:.5f} ms, copy_pairs {t['plain_ms']:.5f} ms "
              f"(turns {t['turns']}); bound {t['bound_ms']:.5f} ms at the published "
              f"rate, {t['copy_bound_ms']:.5f} ms at the measured copy rate", flush=True)
        runners = {impl: tblock_sharded.make_sharded_runner(
            sharded_cfg, SHARDED_STEPS, mesh, halo_impl=impl) for impl in ("rdma", "ppermute")}
        ms = {impl: [] for impl in runners}
        for impl in ("rdma", "ppermute", "ppermute", "rdma"):
            ms[impl].append(cuda_time_ms(lambda: runners[impl](s1), 1) / SHARDED_STEPS)
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} tblock_sharded runner in turns: "
              f"{ms} ms/step; rdma/ppermute speed "
              f"{sum(ms['ppermute']) / sum(ms['rdma']):.4f}x", flush=True)
        del s1, runners

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
        "library_ms": timing[name].get("library_ms"),
    } for name in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
