"""The temporal-block kernel's module on the CPU, and the tiling argument of
its CUDA kernel.

* On CPU tensors the module runs its plain version, K fused steps per block;
  it is held to the JAX package's temporal-block Pallas kernel run in
  interpret mode (as ``tests/test_tblock.py`` runs it), at the ``(k, n)``
  cases of that file: the module itself in float32 to atol 2e-5 (an
  independent float32 implementation), its plain version in float64 to
  1e-12.
* The CUDA kernel advances each tile of the field K steps inside a window
  with a K-wide halo on all four sides, indexed modulo the field, with the
  wall masks and the lid density keyed to the wrapped global coordinates.
  ``_windowed_steps`` below does the same in float64 with PyTorch operations
  and must equal K fused steps exactly: the window is a periodic image of
  the domain, so its own cells are exact after K steps whatever the walls
  do.  It covers the tiles at both lid corners and fields that are no
  multiple of the tile.  (``torch.sum`` over the populations rounds
  differently for tensors of different shapes, so both sides take the
  density as the sequential sum f0 + f1 + ... + f8, the kernels' order.)
  The kernel itself is held to the plain version on the card
  (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.convert import state_from_numpy, state_to_numpy
from latticeboltzmannsimulations_torch.kernels import pull, tblock
from latticeboltzmannsimulations_torch.ops.equilibrium import (
    equilibrium,
    lid_row_density,
)
from latticeboltzmannsimulations_torch.ops.streaming import gather_pull
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels import pallas_pull_tblock

TOL = {"float64": 1e-12, "float32": 2e-5}


def _start(jc, seed=0):
    """The JAX start state with seeded noise, as numpy arrays."""
    s = j_eng.init_state(jc)
    f = np.asarray(s.f)
    rng = np.random.default_rng(seed)
    f = (f * (1.0 + 1e-3 * rng.standard_normal(f.shape))).astype(f.dtype)
    return f, np.asarray(s.rho_lid)


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("collision, k, n", [("srt", 4, 19), ("mrt", 8, 16)])
def test_tblock_module_matches_pallas_interpret(collision, k, n, precision):
    base = dict(nx=64, ny=64, reynolds=400.0, collision=collision,
                precision=precision)
    tc, jc = TConfig(**base), JConfig(**base)
    f0, lid0 = _start(jc)
    if precision == "float32":
        run = tblock.make_scan_runner(tc, n, device="cpu", k_steps=k)
    else:  # the wrapper refuses float64, as the kernel does: its plain version
        step = t_eng.make_fused_step(tc)

        def run(state):
            for _ in range(n):
                state = step(state)
            return state
    out = run(state_from_numpy(f0, lid0, device="cpu"))
    ref = pallas_pull_tblock.make_scan_runner(jc, n, k_steps=k, interpret=True)(
        j_eng.State(f=f0, rho_lid=lid0))
    f, lid = state_to_numpy(out)
    np.testing.assert_allclose(f, np.asarray(ref.f), rtol=0, atol=TOL[precision])
    np.testing.assert_allclose(lid, np.asarray(ref.rho_lid), rtol=0,
                               atol=TOL[precision])


def test_block_step_and_runner_on_cpu_equal_fused_steps():
    cfg = TConfig(nx=64, ny=70, reynolds=400.0, collision="trt")
    s0 = t_eng.init_state(cfg, device="cpu")
    step = t_eng.make_fused_step(cfg)
    s = s0
    for _ in range(7):
        s = step(s)
    out = tblock.make_scan_runner(cfg, 7, device="cpu", k_steps=3)(s0)
    assert torch.equal(out.f, s.f) and torch.equal(out.rho_lid, s.rho_lid)
    b = tblock.make_block_step(cfg, k_steps=7, device="cpu")(s0)
    assert torch.equal(b.f, s.f) and torch.equal(b.rho_lid, s.rho_lid)
    assert tblock.make_scan_runner(cfg, 0, device="cpu")(s0) is s0


@pytest.mark.parametrize("kw, k, reason", [
    (dict(precision="float64"), 8, "float32"),
    (dict(boundary="bounce_back"), 8, "NEBB"),
    (dict(boundary="nebb_tangential"), 8, "NEBB"),
    (dict(turbulence="smagorinsky", van_driest=True), 8, "Van Driest"),
    (dict(mesh_shape=(1, 2)), 8, "one device"),
    (dict(nx=63), 32, "64x64 window"),
    (dict(ny=40), 0, "64x64 window"),
    (dict(), 0, "k_steps"),
    (dict(), 32, "k_steps"),
])
def test_tblock_refusals(kw, k, reason):
    cfg = TConfig(**{"nx": 128, "ny": 96, **kw})
    assert reason in tblock.unsupported_reason(cfg, k)
    with pytest.raises(ValueError, match=reason):
        tblock.make_scan_runner(cfg, 16, device="cpu", k_steps=k)
    with pytest.raises(ValueError, match=reason):
        tblock.make_block_step(cfg, k_steps=k, device="cpu")


def test_small_fields_are_served():
    """The window keys every cell to its wrapped global cell and carries the
    lid density per cell, so a field smaller than the window, or than the
    halo, is served at every K that fits the window."""
    for nx, ny in ((63, 40), (48, 48), (5, 3)):
        cfg = TConfig(nx=nx, ny=ny)
        assert tblock.unsupported_reason(cfg, 31) is None
        assert "k_steps" in tblock.unsupported_reason(cfg, 32)
    assert "tiles" in tblock.unsupported_reason(TConfig(nx=8, ny=54 * 65_535 + 1), 5)


def test_tblock_step_takes_cuda_tensors_only():
    cfg = TConfig(nx=64, ny=64)
    s = t_eng.init_state(cfg, device="cpu")
    out = t_eng.State(torch.empty_like(s.f), torch.empty_like(s.rho_lid))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tblock.tblock_step(cfg, s.f, s.rho_lid, out.f, out.rho_lid)
    assert tblock.unsupported_reason(cfg) is None
    assert tblock.unsupported_reason(TConfig(nx=64, ny=64, turbulence="smagorinsky")) is None
    assert pull.unsupported_reason(TConfig(nx=64, ny=64, turbulence="smagorinsky",
                                           van_driest=True)) is None


# ---------------------------------------------------------------------------
# The wrap-consistent window of csrc/tblock_step.cu, emulated in float64
# ---------------------------------------------------------------------------

def _macros(f):
    """``ops.equilibrium.macroscopics`` with the density summed in order."""
    rho = f[0]
    for k in range(1, 9):
        rho = rho + f[k]
    jx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    jy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return rho, torch.stack([jx, jy]) / rho[None]


@pytest.fixture
def ordered_sum(monkeypatch):
    monkeypatch.setattr(t_eng, "macroscopics", _macros)


def _window_step(cfg, fw, rl, gx, gy):
    """One fused step on a window whose cell (i, j) is global cell
    (gx[i], gy[j]).  The gather wraps inside the window (so the window's
    edge cells go wrong, as in the kernel); the walls, the lid momentum with
    its zero at the corners, the overrides and the lid density follow the
    global coordinates."""
    nx, ny, u_lid = cfg.nx, cfg.ny, cfg.u_lid
    g = gather_pull(fw)
    left, right = (gx == 0)[:, None], (gx == nx - 1)[:, None]
    bottom, lid = (gy == ny - 1)[None, :], (gy == 0)[None, :]
    side = left | right

    def put(k, mask, value):
        g[k] = torch.where(mask, value, g[k])

    put(1, left, g[3]); put(5, left, g[7]); put(8, left, g[6])          # noqa: E702
    put(3, right, g[1]); put(6, right, g[8]); put(7, right, g[5])       # noqa: E702
    put(2, bottom, g[4]); put(5, bottom, g[7]); put(6, bottom, g[8])    # noqa: E702
    mom = torch.where(side[:, 0], 0.0, rl * (u_lid / 6.0))[:, None]
    put(4, lid, g[2]); put(7, lid, g[5] - mom); put(8, lid, g[6] + mom)  # noqa: E702

    rho, u = _macros(g)
    static = side | bottom
    lid_in = lid & ~side
    ux = torch.where(lid_in, u_lid, torch.where(static, 0.0, u[0]))
    uy = torch.where(lid_in | static, 0.0, u[1])
    rho = torch.where(lid_in, lid_row_density(g), rho)
    feq = equilibrium(rho, torch.stack([ux, uy]))
    f_new = t_eng._collide(cfg, g, feq, rho)
    rows = torch.nonzero(gy == 0)
    if rows.numel():
        rl = rho[:, rows[0, 0]].clone()
    return f_new, rl


def _windowed_steps(cfg, state, k, tile):
    """K fused steps, tile by tile: each tile's window of (tx + 2K) x
    (ty + 2K) cells is cut from the field by modulo indexing, advanced K
    steps on its own, and its own cells kept."""
    nx, ny = cfg.nx, cfg.ny
    tx, ty = tile
    f_out = torch.full_like(state.f, float("nan"))
    lid_out = torch.full_like(state.rho_lid, float("nan"))
    for x0 in range(0, nx, tx):
        for y0 in range(0, ny, ty):
            gx = torch.arange(x0 - k, x0 + tx + k) % nx
            gy = torch.arange(y0 - k, y0 + ty + k) % ny
            fw = state.f[:, gx][:, :, gy]
            rl = state.rho_lid[gx]
            for _ in range(k):
                fw, rl = _window_step(cfg, fw, rl, gx, gy)
            wx, wy = min(tx, nx - x0), min(ty, ny - y0)
            f_out[:, x0:x0 + wx, y0:y0 + wy] = fw[:, k:k + wx, k:k + wy]
            if y0 == 0:
                lid_out[x0:x0 + wx] = rl[k:k + wx]
    return t_eng.State(f_out, lid_out)


@pytest.mark.parametrize("kw, k, tile", [
    (dict(nx=40, ny=38, collision="mrt"), 4, (16, 12)),    # partial tiles in x and y
    (dict(nx=33, ny=29, collision="srt"), 3, (10, 7)),
    (dict(nx=30, ny=30, collision="mrt", turbulence="smagorinsky",
          reynolds=5000.0), 5, (10, 10)),                  # the field a whole number of tiles
], ids=["mrt_k4", "srt_k3", "mrt_les_k5"])
def test_wrap_consistent_window_equals_fused_steps(ordered_sum, kw, k, tile):
    """Two rounds of K in-window steps equal 2K fused steps bit for bit,
    including the tiles that hold the two lid corners, whose populations
    carry the wrap value from the bottom row."""
    cfg = TConfig(**{"reynolds": 1000.0, "precision": "float64", **kw})
    f0, lid0 = _start(JConfig(**{"reynolds": 1000.0, "precision": "float64", **kw}))
    s0 = state_from_numpy(f0, lid0, device="cpu")
    step = t_eng.make_fused_step(cfg)
    ref = s0
    for _ in range(2 * k):
        ref = step(ref)
    got = _windowed_steps(cfg, _windowed_steps(cfg, s0, k, tile), k, tile)
    assert torch.equal(got.f, ref.f)
    assert torch.equal(got.rho_lid, ref.rho_lid)


def test_window_without_wrap_consistency_goes_wrong(ordered_sum):
    """The control: keying the walls to window positions instead of the
    wrapped global ones (the TPU kernel's argument, with y tiled) breaks the
    own cells, so the test above has teeth."""
    cfg = TConfig(nx=40, ny=38, reynolds=1000.0, collision="mrt", precision="float64")
    f0, lid0 = _start(JConfig(nx=40, ny=38, reynolds=1000.0, collision="mrt",
                              precision="float64"))
    s0 = state_from_numpy(f0, lid0, device="cpu")
    step = t_eng.make_fused_step(cfg)
    ref = s0
    for _ in range(4):
        ref = step(ref)
    k, (tx, ty) = 4, (16, 12)
    got = torch.empty_like(s0.f)
    for x0 in range(0, cfg.nx, tx):
        for y0 in range(0, cfg.ny, ty):
            gx = torch.arange(x0 - k, x0 + tx + k) % cfg.nx
            gy = torch.arange(y0 - k, y0 + ty + k) % cfg.ny
            # wall masks from clamped coordinates: no wrap-around images
            cx = torch.arange(x0 - k, x0 + tx + k).clamp(-1, cfg.nx)
            cy = torch.arange(y0 - k, y0 + ty + k).clamp(-1, cfg.ny)
            fw, rl = s0.f[:, gx][:, :, gy], s0.rho_lid[gx]
            for _ in range(k):
                fw, rl = _window_step(cfg, fw, rl, cx, cy)
            wx, wy = min(tx, cfg.nx - x0), min(ty, cfg.ny - y0)
            got[:, x0:x0 + wx, y0:y0 + wy] = fw[:, k:k + wx, k:k + wy]
    assert not torch.equal(got, ref.f)
