"""The port's plain sharded engine (``parallel/``) against the JAX package's
sharded engine, run on the 8 virtual CPU devices that ``conftest.py`` sets
up, and against the port's own single-device fused engine.

The port drives a mesh from one process; here every shard sits on the CPU
(``devices=["cpu"] * n``).  Tolerances: float64 to 1e-12, float32 to atol
2e-5 over 20 steps (an independent implementation).  Against the port's
own engine the sharded run is exact, because the exchange only moves values
and the arithmetic is the same; there both sides take the density as the
sequential sum f0 + f1 + ... + f8, because ``torch.sum`` over the
populations rounds differently for tensors of different shapes.
"""

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.convert import state_from_numpy
from latticeboltzmannsimulations_torch.ops.collision import (
    van_driest_cs2,
    van_driest_cs2_block as t_vd_block,
)
from latticeboltzmannsimulations_torch.parallel import halo
from latticeboltzmannsimulations_torch.parallel import (
    exchange_halo,
    make_mesh,
    make_sharded_fused_step,
    make_sharded_scan_runner,
    shard_state,
    sharded_observables,
    unshard_state,
)
from latticeboltzmannsimulations_torch.parallel.mesh import (
    shard_lattice,
    shard_rows,
    unshard_lattice,
    unshard_rows,
)
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu import parallel as j_par
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.ops.collision import (
    van_driest_cs2_block as j_vd_block,
)

TOL = {"float64": 1e-12, "float32": 2e-5}
CPU = torch.device("cpu")
STEPS = 20


def _cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _jax_run(jc, n):
    mesh = j_par.make_mesh(jc.mesh_shape)
    runner = j_par.make_sharded_scan_runner(jc, n, mesh)
    out = runner(j_par.shard_state(j_eng.init_state(jc), mesh))
    return np.asarray(out.f), np.asarray(out.rho_lid)


def _torch_run(tc, n):
    mesh = _cpu_mesh(tc.mesh_shape)
    out = make_sharded_scan_runner(tc, n, mesh)(
        shard_state(t_eng.init_state(tc, CPU), mesh))
    return unshard_state(out, CPU)


@pytest.mark.parametrize("mesh_shape, collision, precision", [
    ((1, 1), "srt", "float64"),
    ((1, 1), "mrt", "float64"),
    ((2, 2), "srt", "float64"),
    ((2, 2), "mrt", "float64"),
    ((2, 4), "srt", "float64"),
    ((2, 4), "mrt", "float64"),
    ((2, 2), "srt", "float32"),
    ((2, 4), "mrt", "float32"),
])
def test_sharded_engine_matches_jax(mesh_shape, collision, precision):
    kw = dict(nx=64, ny=64, reynolds=400.0, collision=collision,
              precision=precision, mesh_shape=mesh_shape)
    f_j, lid_j = _jax_run(JConfig(**kw), STEPS)
    out = _torch_run(TConfig(**kw), STEPS)
    tol = TOL[precision]
    np.testing.assert_allclose(out.f.numpy(), f_j, rtol=0, atol=tol)
    np.testing.assert_allclose(out.rho_lid.numpy(), lid_j, rtol=0, atol=tol)


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
    monkeypatch.setattr(halo, "macroscopics", _macros)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (2, 4), (4, 1), (1, 3)])
@pytest.mark.parametrize("collision", ["srt", "trt", "mrt"])
def test_sharded_engine_equals_fused_engine(ordered_sum, mesh_shape, collision):
    cfg = TConfig(nx=48, ny=36, reynolds=400.0, collision=collision,
                  mesh_shape=mesh_shape)
    ref = t_eng.init_state(cfg, CPU)
    step = t_eng.make_fused_step(cfg)
    for _ in range(STEPS):
        ref = step(ref)
    out = _torch_run(cfg, STEPS)
    assert torch.equal(out.f, ref.f)
    assert torch.equal(out.rho_lid, ref.rho_lid)


def test_sharded_fused_step_equals_the_runner():
    cfg = TConfig(nx=32, ny=32, reynolds=400.0, collision="mrt", mesh_shape=(2, 2))
    mesh = _cpu_mesh(cfg.mesh_shape)
    s0 = shard_state(t_eng.init_state(cfg, CPU), mesh)
    step = make_sharded_fused_step(cfg, mesh)
    s = s0
    for _ in range(5):
        s = step(s)
    out = make_sharded_scan_runner(cfg, 5, mesh)(s0)
    assert torch.equal(unshard_state(s, CPU).f, unshard_state(out, CPU).f)
    # the lid density is replicated over the my axis
    for ix, iy in mesh.shards():
        assert torch.equal(s.rho_lid[ix][iy], s.rho_lid[ix][0])


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_sharded_van_driest_matches_jax(precision):
    kw = dict(nx=64, ny=64, reynolds=5000.0, collision="srt", precision=precision,
              turbulence="smagorinsky", van_driest=True, mesh_shape=(2, 4))
    f_j, lid_j = _jax_run(JConfig(**kw), STEPS)
    out = _torch_run(TConfig(**kw), STEPS)
    np.testing.assert_allclose(out.f.numpy(), f_j, rtol=0, atol=TOL[precision])
    np.testing.assert_allclose(out.rho_lid.numpy(), lid_j, rtol=0, atol=TOL[precision])


def test_van_driest_block_matches_jax_and_the_global_plane():
    nx, ny, visc_inv = 40, 24, 12.5
    full = van_driest_cs2(nx, ny, visc_inv, dtype=torch.float64)
    for x0, y0, lx, ly in [(0, 0, 20, 12), (20, 12, 20, 12), (10, 6, 10, 18)]:
        t = t_vd_block(nx, ny, x0, y0, lx, ly, visc_inv, dtype=torch.float64)
        j = np.asarray(j_vd_block(nx, ny, x0, y0, lx, ly, visc_inv,
                                  dtype=jax.numpy.float64))
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-15)
        assert torch.equal(t, full[x0:x0 + lx, y0:y0 + ly])


def test_sharded_observables_match_the_engine(ordered_sum):
    cfg = TConfig(nx=48, ny=40, reynolds=5000.0, collision="mrt",
                  turbulence="smagorinsky", precision="float64", mesh_shape=(2, 2))
    ref = t_eng.init_state(cfg, CPU)
    step = t_eng.make_fused_step(cfg)
    for _ in range(15):
        ref = step(ref)
    mesh = _cpu_mesh(cfg.mesh_shape)
    rho, u = sharded_observables(cfg, mesh)(shard_state(ref, mesh))
    rho_ref, u_ref = t_eng.observables(cfg, ref)
    assert torch.equal(rho, rho_ref) and torch.equal(u, u_ref)


@pytest.mark.parametrize("mesh_shape, depth", [((1, 1), 1), ((2, 2), 1), ((3, 2), 2),
                                               ((1, 4), 3)])
def test_exchange_halo_equals_a_wrap_padded_field(mesh_shape, depth):
    """Each padded block is the window of the globally wrap-padded field
    around the shard: the two phases bring the diagonal corners."""
    nx, ny = 12, 16
    field = torch.arange(3 * nx * ny, dtype=torch.float64).reshape(3, nx, ny)
    padded = torch.cat([field[:, -depth:], field, field[:, :depth]], dim=1)
    padded = torch.cat([padded[:, :, -depth:], padded, padded[:, :, :depth]], dim=2)
    mesh = _cpu_mesh(mesh_shape)
    out = exchange_halo(shard_lattice(field, mesh), depth)
    lx, ly = nx // mesh_shape[0], ny // mesh_shape[1]
    for ix, iy in mesh.shards():
        want = padded[:, ix * lx:ix * lx + lx + 2 * depth, iy * ly:iy * ly + ly + 2 * depth]
        assert torch.equal(out[ix][iy], want), (ix, iy)


def test_shard_and_unshard_round_trip():
    cfg = TConfig(nx=24, ny=18, mesh_shape=(3, 2))
    mesh = _cpu_mesh(cfg.mesh_shape)
    s = t_eng.init_state(cfg, CPU)
    f = torch.randn(s.f.shape, dtype=s.f.dtype)
    blocks = shard_lattice(f, mesh)
    assert blocks[2][1].shape == (9, 8, 9) and blocks[2][1].is_contiguous()
    assert torch.equal(unshard_lattice(blocks, CPU), f)
    rows = shard_rows(s.rho_lid, mesh)
    assert torch.equal(rows[1][0], rows[1][1])
    assert torch.equal(unshard_rows(rows, CPU), s.rho_lid)
    state = state_from_numpy(f.numpy(), s.rho_lid.numpy(), device="cpu")
    back = unshard_state(shard_state(state, mesh), CPU)
    assert torch.equal(back.f, state.f) and torch.equal(back.rho_lid, state.rho_lid)


def test_mesh_refusals():
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_mesh((2, 2), ["cpu"] * 3)
    cfg = TConfig(nx=30, ny=32, mesh_shape=(4, 2))
    with pytest.raises(ValueError, match="divide"):
        make_sharded_scan_runner(cfg, 2, _cpu_mesh((4, 2)))
    with pytest.raises(ValueError, match="divide"):
        shard_lattice(torch.zeros(9, 30, 32), _cpu_mesh((4, 2)))
    with pytest.raises(ValueError, match="mesh_shape"):
        make_sharded_scan_runner(TConfig(nx=32, ny=32, mesh_shape=(2, 2)), 2,
                                 _cpu_mesh((4, 1)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((2, 1))
    mesh = make_mesh((2, 2), ["cpu", "cpu", "cpu", "cpu", "cpu"])
    assert mesh.devices == ((CPU, CPU), (CPU, CPU)) and not mesh.on_cuda
    assert list(mesh.shards()) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_exchange_counts_its_copies():
    mesh = _cpu_mesh((2, 2))
    blocks = shard_lattice(torch.zeros(9, 8, 8), mesh)
    before = halo.copies
    exchange_halo(blocks)
    # one copy per block into its carry, then four strips per shard
    assert halo.copies - before == 4 + 4 * 4
