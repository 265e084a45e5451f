"""The CUDA sources of the port, built with ``g++`` as a serial emulation and
held to their plain versions on the CPU.

There is no ``nvcc`` and no card here, so this is the only CPU check of the
kernels' code.  The sources in ``latticeboltzmannsimulations_torch/csrc``
are read as they are, and a copy is rewritten for the host:

* a stub ``cuda_runtime.h`` turns the CUDA keywords into C++ (``__shared__``
  becomes ``static``, ``__syncthreads()`` does nothing) and keeps
  ``threadIdx``/``blockIdx``/``blockDim``/``gridDim`` in globals;
* every ``kThreads`` is set to 1, so a block is one thread, which runs the
  block's loops serially: a valid schedule for these kernels' barriers;
* every launch ``kernel<<<grid, block, smem, stream>>>(args)`` becomes a
  loop over the grid's blocks, in four passes by the parity of their x and
  y (a block that wrote a cell its neighbour owns would then show);
  dynamic shared memory, of any type, is a host buffer;
* ``float4`` is a 16-byte struct, and the
  runtime calls that enable peer access or set a kernel's shared memory do
  nothing.

The library is called through ``ctypes`` by each wrapper's own ``_launch``,
on CPU tensors.  It holds every kernel to its plain version at atol 2e-5
over 20 float32 steps (an independent float32 implementation; the
one-step kernel with either lid), and holds
these bit for bit on ragged shapes: ``tblock_step`` against ``pull_step``
(fields smaller than its window and than its halo included),
the sharded one-step kernel on a mesh against ``pull_step`` on the global
grid, and the sharded temporal-block kernel against the sharded one-step
kernel; and the halo exchange kernel byte for byte against the refresh's
definition (``halo.refresh_phases`` copied in order) on meshes (1, 1) to
(4, 1), ragged shards, K of 1, 4 and 5, tight carries with lid panels and
aligned ones without, its x-only table against the x-phase copies, and
rectangles of rows of every 16-byte phase and of both kinds of slot (one
float; a 16-byte line) with the grid sized for one SM and for 132.  The
kernels equal their plain versions bit for bit (the one-step kernel with
either lid, the push kernel, the sweep and the sharded one-step kernel;
the one-step kernel and the sweep under LES too).  A serial run cannot show a race; the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py`` stay for that.  Skips without
``g++``.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import (
    _build,
    pull,
    halo_rdma,
    pull_sharded,
    push,
    tblock,
    tblock_sharded,
)
from latticeboltzmannsimulations_torch.parallel import halo, make_mesh
from latticeboltzmannsimulations_torch.parallel.mesh import block_shape

ATOL = 2e-5
STEPS = 20

_STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim, gridDim;
inline void __syncthreads() {}
typedef void* cudaStream_t;
struct alignas(16) float4 { float x, y, z, w; };
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9,
                   cudaErrorPeerAccessAlreadyEnabled = 704 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaDeviceEnablePeerAccess(int, unsigned) { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
namespace emu {
inline std::vector<float> smem;
inline float* dynamic_smem() { return smem.data(); }
template <class F>
void launch(F body, dim3 grid, dim3 block, size_t smem_bytes = 0, void* = nullptr) {
  smem.assign(smem_bytes / sizeof(float) + 1, 0.0f);
  gridDim = grid;
  blockDim = block;
  // The blocks in four passes by the parity of x and y: a block that
  // writes a cell its neighbour owns then runs after that neighbour on one
  // side or the other, and the results differ.
  for (unsigned px = 0; px < 2; ++px)
    for (unsigned py = 0; py < 2; ++py)
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = py; y < grid.y; y += 2)
          for (unsigned x = px; x < grid.x; x += 2) {
            blockIdx = dim3(x, y, z);
            threadIdx = dim3(0, 0, 0);
            body();
          }
}
}  // namespace emu
"""


def _matching(text: str, start: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        depth += {open_: 1, close: -1}.get(text[i], 0)
        if depth == 0:
            return i + 1
    raise ValueError("unbalanced brackets")


def _emulate(source: str) -> str:
    """A CUDA source rewritten for the serial host build."""
    text = re.sub(r"constexpr int kThreads = [^;]+;", "constexpr int kThreads = 1;", source)
    text = re.sub(r"extern __shared__ (\w[\w ]*?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu::dynamic_smem());", text)
    while "<<<" in text:
        at = text.index("<<<")
        name = re.search(r"(\w+(?:<[^<>]*>)?)\s*$", text[:at]).group(1)
        head = at - len(name)
        end_cfg = text.index(">>>", at)
        config = text[at + 3:end_cfg]
        args_start = text.index("(", end_cfg)
        args_end = _matching(text, args_start, "(", ")")
        args = text[args_start:args_end]
        text = (text[:head] + f"emu::launch([&] {{ {name}{args}; }}, {config})"
                + text[args_end:])
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA sources as a host emulation")
    out = tmp_path_factory.mktemp("csrc_emulated")
    (out / "cuda_runtime.h").write_text(_STUB)
    for header in _build.HEADERS:
        (out / header.name).write_text(_emulate(header.read_text()))
    procs, objs = [], []
    for src in _build.SOURCES:
        cpp = out / f"{src.stem}.cpp"
        cpp.write_text(_emulate(src.read_text()))
        objs.append(out / f"{src.stem}.o")
        procs.append(subprocess.Popen(
            [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-I", str(out),
             "-c", "-o", str(objs[-1]), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for src, proc in zip(_build.SOURCES, procs):
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{src.name}:\n{log}"
    so = out / "lbm_emulated.so"
    subprocess.run([gxx, "-shared", "-o", str(so), *map(str, objs)], check=True,
                   timeout=120)
    return _build.declare(ctypes.CDLL(str(so)))


CASES = {
    "srt": dict(collision="srt"),
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
    "mrt_smagorinsky": dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    "srt_van_driest": dict(collision="srt", turbulence="smagorinsky",
                           van_driest=True, reynolds=5000.0),
}


def _cfg(nx, ny, case="mrt", **kw):
    return SimConfig(**{"nx": nx, "ny": ny, "reynolds": 400.0, **CASES[case], **kw})


def _start(cfg):
    """The start state with seeded noise, so that every population moves."""
    s = engine.init_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    return engine.State(s.f * (1.0 + 1e-3 * torch.randn(s.f.shape, generator=gen)),
                        s.rho_lid.clone())


def _plain(cfg, state, n):
    step = engine.make_fused_step(cfg)
    for _ in range(n):
        state = step(state)
    return state


def _pull_steps(lib, cfg, state, n):
    cs2 = pull._cs2_plane(cfg, torch.device("cpu"))
    bufs = [state, engine.State(torch.empty_like(state.f), torch.empty_like(state.rho_lid)),
            engine.State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))]
    src = bufs[0]
    for i in range(n):
        dst = bufs[1 + i % 2]
        pull._launch(lib, src.f.data_ptr(), src.rho_lid.data_ptr(),
                     None if cs2 is None else cs2.data_ptr(), dst.f.data_ptr(),
                     dst.rho_lid.data_ptr(), pull._scalars(cfg), None,
                     pull._lid_scalars(cfg))
        src = dst
    return src


# The sweep form: Reynolds numbers of the stacked cavities, and the cases
# (no Van Driest: its Cs^2 depends on Re, so the sweep form refuses it).
SWEEP_RE = (150.0, 900.0, 2500.0)
SWEEP_CASES = {"srt_smagorinsky": dict(collision="srt", turbulence="smagorinsky"),
               "trt": CASES["trt"], "mrt": CASES["mrt"]}


def _sweep_cfg(case):
    return SimConfig(nx=37, ny=29, **SWEEP_CASES[case])


def _omegas(cfg, n_cav):
    return np.array([dataclasses.replace(cfg, reynolds=r).omega
                     for r in SWEEP_RE[:n_cav]], dtype=np.float32)


def _stacked_start(cfg, n_cav):
    """n_cav cavities stacked along x, each from the start state with its
    own seeded noise."""
    s = engine.init_state(cfg, "cpu")
    gens = [torch.Generator().manual_seed(10 + c) for c in range(n_cav)]
    return engine.stack_cavities(engine.State(
        torch.stack([s.f * (1.0 + 1e-3 * torch.randn(s.f.shape, generator=g))
                     for g in gens]),
        torch.stack([s.rho_lid] * n_cav)))


def _sweep_steps(lib, cfg, state, omegas, n):
    """``pull.make_sweep_runner``'s loop, launching the emulated sweep entry
    through the wrapper's ``_launch_sweep`` and ``cavity_table``."""
    n_cav = len(omegas)
    table = torch.from_numpy(pull.cavity_table(cfg, omegas))
    src = state
    for _ in range(n):
        dst = engine.State(torch.empty_like(src.f), torch.empty_like(src.rho_lid))
        pull._launch_sweep(lib, src.f.data_ptr(), src.rho_lid.data_ptr(),
                           dst.f.data_ptr(), dst.rho_lid.data_ptr(), n_cav,
                           table.data_ptr(), pull._sweep_scalars(cfg), None)
        src = dst
    return src


def _cavity(state, cfg, c):
    return engine.State(state.f[:, c * cfg.nx:(c + 1) * cfg.nx].contiguous(),
                        state.rho_lid[c * cfg.nx:(c + 1) * cfg.nx].clone())


def _tblock_steps(lib, cfg, state, n_blocks, k):
    src = state
    for _ in range(n_blocks):
        dst = engine.State(torch.empty_like(src.f), torch.empty_like(src.rho_lid))
        tblock._launch(lib, (src.f.data_ptr(), src.rho_lid.data_ptr()),
                       (dst.f.data_ptr(), dst.rho_lid.data_ptr()),
                       pull._scalars(cfg), k, None)
        src = dst
    return src


def _pull_sharded_steps(lib, cfg, mesh, state, n):
    """``pull_sharded.make_sharded_runner``'s loop, launching the emulated
    kernel through the wrapper's ``_launch``."""
    cs2 = halo.cs2_blocks(cfg, mesh, torch.float32)
    lay = pull_sharded.layout(*block_shape(cfg.nx, cfg.ny, mesh.shape))
    carries = [halo.pad_blocks(state.f, lay)]
    carries.append(halo.empty_blocks(carries[0]))
    rows = [halo.pad_rows(state.rho_lid, 0)]
    rows.append(halo.empty_blocks(rows[0]))
    for i in range(n):
        src, dst = i % 2, (i + 1) % 2
        halo.copy_pairs(halo.halo_pairs(carries[src], lay))
        for ix, iy in mesh.shards():
            pull_sharded._launch(
                lib, carries[src][ix][iy].data_ptr(), rows[src][ix][iy].data_ptr(),
                None if cs2 is None else cs2[ix][iy].data_ptr(),
                carries[dst][ix][iy].data_ptr(), rows[dst][ix][iy].data_ptr(),
                lay, halo.edge_flags(mesh.shape, ix, iy), pull._scalars(cfg)[2:], None)
    halo.copy_pairs(halo.replicate_pairs(rows[n % 2]))
    return halo.ShardedState(halo.unpad_blocks(carries[n % 2], lay), rows[n % 2])


def _tblock_sharded_steps(lib, cfg, mesh, state, n_blocks, k):
    """``tblock_sharded.make_sharded_runner``'s loop (no remainder),
    launching the emulated kernel through the wrapper's ``_launch``."""
    lx, ly = block_shape(cfg.nx, cfg.ny, mesh.shape)
    lay = halo.Layout.tight(lx, ly, k)
    carries = [halo.pad_blocks(state.f, lay)]
    carries.append(halo.empty_blocks(carries[0]))
    panels = [halo.pad_rows(state.rho_lid, k)]
    panels.append(halo.empty_blocks(panels[0]))
    for i in range(n_blocks):
        src, dst = i % 2, (i + 1) % 2
        halo.copy_pairs(halo.halo_pairs(carries[src], lay)
                        + halo.row_halo_pairs(panels[src], k))
        for ix, iy in mesh.shards():
            tblock_sharded._launch(
                lib, carries[src][ix][iy].data_ptr(), panels[src][ix][iy].data_ptr(),
                carries[dst][ix][iy].data_ptr(), panels[dst][ix][iy].data_ptr(),
                lx, ly, (ix * lx, iy * ly), pull._scalars(cfg), k, None)
        halo.copy_pairs(halo.replicate_pairs(panels[dst]))
    return halo.ShardedState(halo.unpad_blocks(carries[n_blocks % 2], lay),
                             halo.unpad_rows(panels[n_blocks % 2], k))


def _global(sharded):
    return halo.unshard_state(sharded, torch.device("cpu"))


def _close(a, b):
    torch.testing.assert_close(a.f, b.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(a.rho_lid, b.rho_lid, rtol=0, atol=ATOL)


def _equal(a, b):
    assert torch.equal(a.f, b.f)
    assert torch.equal(a.rho_lid, b.rho_lid)


@pytest.mark.parametrize("case", list(CASES))
def test_pull_step_matches_plain(lib, case):
    cfg = _cfg(70, 46, case)
    s0 = _start(cfg)
    _close(_pull_steps(lib, cfg, s0, STEPS), _plain(cfg, s0, STEPS))


# Without LES every kernel does its plain version's float operations in the
# same order, none contracted into an FMA (the build's -fmad=false, here
# -ffp-contract=off): the two give the same bits over BIT_STEPS steps.  A
# density moment summed in another order rounded differently and moved the
# mass a long run carries.  Under LES too (LES_CASES), since the plain
# engine roots correctly rounded on the CPU as the kernels' sqrtf does
# (``ops.collision.correctly_rounded_sqrt``; torch's own float32 sqrt on the
# CPU is not always correctly rounded).
BIT_CASES = ("srt", "trt", "mrt")
LES_CASES = ("mrt_smagorinsky", "srt_van_driest")
BIT_STEPS = 50


@pytest.mark.parametrize("lid", ["nebb", "nebb_tangential"])
@pytest.mark.parametrize("case", BIT_CASES)
def test_pull_step_equals_plain_bit_for_bit(lib, case, lid):
    cfg = _cfg(70, 46, case, boundary=lid)
    s0 = _start(cfg)
    want = _plain(cfg, s0, BIT_STEPS)
    assert torch.isfinite(want.f).all()
    _equal(_pull_steps(lib, cfg, s0, BIT_STEPS), want)


# The push kernel's wall kinds: the full NEBB, and the two walls of the
# entry lbm_push_step_wall (nebb_west_eq: the lid corners move with the lid;
# bounce_back: the Bouzidi lid's u_lid / 6 and the static corner closure).
PUSH_WALLS = ("nebb", "nebb_west_eq", "bounce_back")


def _push_steps(lib, cfg, f, n):
    """``n`` launches of the emulated push kernel through the wrapper's
    ``_launch``, which picks the entry of ``cfg.boundary``."""
    for _ in range(n):
        out = torch.empty_like(f)
        push._launch(lib, cfg.boundary, f.data_ptr(), out.data_ptr(),
                     pull._scalars(cfg), None)
        f = out
    return f


def _push_oracle(cfg, f, n):
    oracle = engine.make_push_oracle_step(cfg)
    for _ in range(n):
        f = oracle(f)
    return f


@pytest.mark.parametrize("wall", PUSH_WALLS)
@pytest.mark.parametrize("case", BIT_CASES)
def test_push_step_equals_oracle_bit_for_bit(lib, case, wall):
    cfg = _cfg(70, 46, case, boundary=wall)
    f0 = _start(cfg).f
    want = _push_oracle(cfg, f0, BIT_STEPS)
    assert torch.isfinite(want).all()
    assert torch.equal(_push_steps(lib, cfg, f0, BIT_STEPS), want)


@pytest.mark.parametrize("case", ["trt", "mrt"])
def test_sweep_step_equals_plain_bit_for_bit(lib, case):
    cfg = _sweep_cfg(case)
    s0 = _stacked_start(cfg, 3)
    om = _omegas(cfg, 3)
    plain = engine.make_stacked_step_omega(cfg, 3)
    s_plain = s0
    for _ in range(BIT_STEPS):
        s_plain = plain(s_plain, torch.from_numpy(om))
    _equal(_sweep_steps(lib, cfg, s0, om, BIT_STEPS), s_plain)


@pytest.mark.parametrize("case", LES_CASES)
def test_pull_step_under_les_equals_plain_bit_for_bit(lib, case):
    cfg = _cfg(70, 46, case)
    s0 = _start(cfg)
    want = _plain(cfg, s0, BIT_STEPS)
    assert torch.isfinite(want.f).all()
    _equal(_pull_steps(lib, cfg, s0, BIT_STEPS), want)


def test_sweep_step_under_les_equals_plain_bit_for_bit(lib):
    """The sweep's own case, SRT + Smagorinsky, three cavities."""
    cfg = _sweep_cfg("srt_smagorinsky")
    s0 = _stacked_start(cfg, 3)
    om = _omegas(cfg, 3)
    plain = engine.make_stacked_step_omega(cfg, 3)
    s_plain = s0
    for _ in range(BIT_STEPS):
        s_plain = plain(s_plain, torch.from_numpy(om))
    _equal(_sweep_steps(lib, cfg, s0, om, BIT_STEPS), s_plain)


@pytest.mark.parametrize("case", BIT_CASES)
def test_pull_sharded_equals_plain_bit_for_bit(lib, case):
    cfg = _cfg(70, 46, case, mesh_shape=(2, 2))
    mesh = make_mesh(cfg.mesh_shape, ["cpu"] * 4)
    s0 = _start(cfg)
    out = _pull_sharded_steps(lib, cfg, mesh, halo.shard_state(s0, mesh), BIT_STEPS)
    _equal(_global(out), _plain(cfg, s0, BIT_STEPS))


@pytest.mark.parametrize("case", list(CASES))
def test_pull_step_tangential_matches_plain(lib, case):
    """The tangential entry against the plain tangential engine on a ragged
    field, where both lid corners and the wrap at them show."""
    cfg = _cfg(37, 29, case, boundary="nebb_tangential")
    s0 = _start(cfg)
    _close(_pull_steps(lib, cfg, s0, STEPS), _plain(cfg, s0, STEPS))


@pytest.mark.parametrize("n_cav", [1, 3])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_step_matches_plain(lib, case, n_cav):
    """The sweep entry against the plain stacked step, each cavity with its
    own omega, on a ragged shape."""
    cfg = _sweep_cfg(case)
    s0 = _stacked_start(cfg, n_cav)
    om = _omegas(cfg, n_cav)
    plain = engine.make_stacked_step_omega(cfg, n_cav)
    s_plain = s0
    for _ in range(STEPS):
        s_plain = plain(s_plain, torch.from_numpy(om))
    _close(_sweep_steps(lib, cfg, s0, om, STEPS), s_plain)


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_stack_equals_single_cavities(lib, case):
    """Three stacked cavities against each run alone through the one-cavity
    form (the same entry, n_cav = 1, the same table): bit for bit."""
    cfg = _sweep_cfg(case)
    s0 = _stacked_start(cfg, 3)
    om = _omegas(cfg, 3)
    out = _sweep_steps(lib, cfg, s0, om, STEPS)
    for c in range(3):
        _equal(_cavity(out, cfg, c), _sweep_steps(lib, cfg, _cavity(s0, cfg, c),
                                                  om[c:c + 1], STEPS))


def test_sweep_nan_cavity_leaks_into_no_other(lib):
    """A cavity filled with NaN: its neighbours on both sides stay finite
    and equal to their runs alone."""
    cfg = _sweep_cfg("mrt")
    s0 = _stacked_start(cfg, 3)
    s0.f[:, cfg.nx:2 * cfg.nx] = float("nan")
    om = _omegas(cfg, 3)
    out = _sweep_steps(lib, cfg, s0, om, STEPS)
    assert torch.isnan(_cavity(out, cfg, 1).f).all()
    for c in (0, 2):
        alone = _sweep_steps(lib, cfg, _cavity(s0, cfg, c), om[c:c + 1], STEPS)
        assert torch.isfinite(alone.f).all()
        _equal(_cavity(out, cfg, c), alone)


@pytest.mark.parametrize("case", ["srt", "trt", "mrt", "mrt_smagorinsky"])
def test_tblock_step_matches_plain(lib, case):
    cfg = _cfg(100, 70, case)
    s0 = _start(cfg)
    _close(_tblock_steps(lib, cfg, s0, STEPS // 5, 5), _plain(cfg, s0, STEPS))


@pytest.mark.parametrize("nx, ny, k", [
    (64, 64, 1),
    (100, 70, 5),     # ragged last tiles
    (70, 130, 10),
    (60, 50, 8),      # a field smaller than the window
    (109, 109, 5),    # one past a multiple of the 54 own cells
    (36, 20, 5),      # several lid images in one window
    (4, 6, 5),        # a field smaller than the halo
])
def test_tblock_step_equals_pull_step(lib, nx, ny, k):
    cfg = _cfg(nx, ny)
    s0 = _start(cfg)
    _equal(_tblock_steps(lib, cfg, s0, 2, k), _pull_steps(lib, cfg, s0, 2 * k))


@pytest.mark.parametrize("wall", PUSH_WALLS)
@pytest.mark.parametrize("case", ["srt", "trt", "mrt", "mrt_smagorinsky"])
def test_push_step_matches_oracle(lib, case, wall):
    cfg = _cfg(70, 46, case, boundary=wall)
    f0 = _start(cfg).f
    torch.testing.assert_close(_push_steps(lib, cfg, f0, STEPS),
                               _push_oracle(cfg, f0, STEPS), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_pull_sharded_matches_plain(lib, case):
    cfg = _cfg(70, 46, case, mesh_shape=(2, 2))
    mesh = make_mesh(cfg.mesh_shape, ["cpu"] * 4)
    s0 = _start(cfg)
    out = _pull_sharded_steps(lib, cfg, mesh, halo.shard_state(s0, mesh), STEPS)
    _close(_global(out), _plain(cfg, s0, STEPS))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (3, 1)])
def test_pull_sharded_equals_pull_step(lib, mesh_shape):
    cfg = _cfg(66, 46, mesh_shape=mesh_shape)
    mesh = make_mesh(mesh_shape, ["cpu"] * 4)
    s0 = _start(cfg)
    out = _pull_sharded_steps(lib, cfg, mesh, halo.shard_state(s0, mesh), STEPS)
    _equal(_global(out), _pull_steps(lib, cfg, s0, STEPS))


@pytest.mark.parametrize("case", ["srt", "trt", "mrt", "mrt_smagorinsky"])
def test_tblock_sharded_matches_plain(lib, case):
    cfg = _cfg(70, 46, case, mesh_shape=(2, 2))
    mesh = make_mesh(cfg.mesh_shape, ["cpu"] * 4)
    s0 = _start(cfg)
    out = _tblock_sharded_steps(lib, cfg, mesh, halo.shard_state(s0, mesh), STEPS // 5, 5)
    _close(_global(out), _plain(cfg, s0, STEPS))


@pytest.mark.parametrize("nx, ny, mesh_shape, k", [
    (70, 46, (2, 2), 5),     # shards narrower than the window
    (140, 96, (2, 1), 8),    # shards wider than one tile, ragged last tiles
    (64, 40, (1, 5), 8),     # ly == K: every shard sees a wall image
    (36, 28, (1, 1), 5),     # both lid images in one window
    (110, 218, (2, 2), 5),   # lx = 55, ly = 109: one past a multiple of 54
])
def test_tblock_sharded_equals_pull_sharded(lib, nx, ny, mesh_shape, k):
    cfg = _cfg(nx, ny, mesh_shape=mesh_shape)
    mesh = make_mesh(mesh_shape, ["cpu"] * 5)
    s0 = halo.shard_state(_start(cfg), mesh)
    _equal(_global(_tblock_sharded_steps(lib, cfg, mesh, s0, 2, k)),
           _global(_pull_sharded_steps(lib, cfg, mesh, s0, 2 * k)))


def _exchange(lib, pairs, sms=132):
    """One launch of the emulated exchange kernel on (destination, source)
    views, through the wrapper's table rows and ``_launch``, its grid sized
    for ``sms`` SMs (one SM: each thread strides over several slots)."""
    rows = halo_rdma.rect_rows(pairs)
    table = torch.tensor(rows, dtype=torch.int64)
    halo_rdma._launch(lib, table.data_ptr(), len(rows), halo_rdma.n_slots(rows), 0, sms,
                      None)


def _random_blocks(gen, mesh_shape, *size):
    mx, my = mesh_shape
    return tuple(tuple(torch.randn(size, generator=gen) for _ in range(my))
                 for _ in range(mx))


def _clone(blocks):
    return tuple(tuple(b.clone() for b in col) for col in blocks)


def _assert_same_bytes(got, want):
    for col_g, col_w in zip(got, want):
        for g, w in zip(col_g, col_w):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("mesh_shape, lx, ly, k", [
    ((1, 1), 7, 5, 3),       # the ring copies onto itself
    ((1, 2), 9, 6, 5),
    ((2, 1), 13, 11, 5),
    ((3, 2), 10, 7, 4),
    ((4, 1), 33, 70, 5),     # runs long enough for several float4 per thread
])
def test_x_exchange_equals_plain_copies(lib, mesh_shape, lx, ly, k):
    """``make_x_halo_exchange``'s table (the x phase, full ring height, and
    the panels' x halos) against the same moves copied in order."""
    gen = torch.Generator().manual_seed(1)
    lay = halo.Layout.tight(lx, ly, k)
    carries = _random_blocks(gen, mesh_shape, 9, lx + 2 * k, ly + 2 * k)
    panels = _random_blocks(gen, mesh_shape, lx + 2 * k)
    plain = [_clone(carries), _clone(panels)]
    halo.copy_pairs(halo.move_pairs(halo_rdma.x_moves(*plain, lay)))
    _exchange(lib, halo.move_pairs(halo_rdma.x_moves(carries, panels, lay)))
    _assert_same_bytes(carries, plain[0])
    _assert_same_bytes(panels, plain[1])


# Ragged shards per mesh, each at least 5 cells wide (the deepest K).
REFRESH_SHARDS = {(1, 1): (7, 5), (2, 1): (13, 11), (1, 2): (9, 6), (2, 2): (10, 7),
                  (3, 2): (6, 9), (4, 1): (33, 70)}


@pytest.mark.parametrize("kind", ["tight", "aligned"])
@pytest.mark.parametrize("k", [1, 4, 5])
@pytest.mark.parametrize("mesh_shape", list(REFRESH_SHARDS))
def test_halo_exchange_equals_plain_composition(lib, mesh_shape, k, kind):
    """The whole refresh in one launch (``halo.refresh_moves``: corners from
    the diagonal shard, panels from ``iy = 0``) against its definition,
    ``halo.refresh_phases`` copied phase after phase, byte for byte, the
    rest of every carry untouched.  Tight carries with panels, as the
    temporal-block runner has them; aligned ones without, as the one-step
    runner has them."""
    gen = torch.Generator().manual_seed(2)
    lx, ly = REFRESH_SHARDS[mesh_shape]
    lay = getattr(halo.Layout, kind)(lx, ly, k)
    carries = _random_blocks(gen, mesh_shape, 9, lx + 2 * k, lay.pitch)
    panels = _random_blocks(gen, mesh_shape, lx + 2 * k) if kind == "tight" else None
    plain = [_clone(carries), None if panels is None else _clone(panels)]
    for phase in halo.refresh_phases(*plain, lay):
        halo.copy_pairs(halo.move_pairs(phase))
    _exchange(lib, halo.move_pairs(halo.refresh_moves(carries, panels, lay)))
    _assert_same_bytes(carries, plain[0])
    if panels is not None:
        _assert_same_bytes(panels, plain[1])


@pytest.mark.parametrize("sms", [1, 132])
def test_halo_exchange_rectangles_of_every_phase(lib, sms):
    """Rectangles of 2 planes x 3 rows of short rows (one float a slot) and
    long ones (16-byte lines where both sides keep one phase: the float4
    body with its scalar head and tail), their rows starting at every
    4-byte phase of a 16-byte line on either side, with row strides that
    keep or shift the phase from row to row, in one launch."""
    src = torch.arange(1 << 18, dtype=torch.float32)
    dst = torch.full((1 << 18,), -1.0)
    want = dst.clone()
    pairs, at = [], 0
    for a in range(4):
        for b in range(4):
            for n in (1, 5, 9, 32, 33, 35, 38):
                for s_row, d_row in ((40, 40), (41, 41), (40, 42), (43, 40)):
                    def rect(t, off, row):
                        return t[at + off:at + off + 320].view(2, 160)[:, :3 * row].unflatten(
                            1, (3, row))[:, :, :n]
                    pairs.append((rect(dst, b, d_row), rect(src, a, s_row)))
                    rect(want, b, d_row).copy_(rect(src, a, s_row))
                    at += 384
    rows = halo_rdma.rect_rows(pairs)
    assert {r[9] for r in rows} == {0, 1}     # both kinds of slot
    _exchange(lib, pairs, sms)
    assert torch.equal(dst, want)


def test_x_exchange_runs_of_every_alignment(lib):
    """Runs of 1 to 13 floats from and to every 4-byte phase of a 16-byte
    line, in one launch: the float4 body, its scalar head and tail, and the
    scalar path where the phases differ."""
    src = torch.arange(8192, dtype=torch.float32)
    dst = torch.full((8192,), -1.0)
    want = dst.clone()
    pairs, at = [], 0
    for a in range(4):
        for b in range(4):
            for n in range(1, 14):
                pairs.append((dst[at + b:at + b + n], src[at + a:at + a + n]))
                want[at + b:at + b + n] = src[at + a:at + a + n]
                at += 32
    _exchange(lib, pairs)
    assert torch.equal(dst, want)
