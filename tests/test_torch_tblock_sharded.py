"""The sharded temporal-block kernel's module on the CPU.

On CPU shards the module's runner does its K-deep exchanges and runs its
plain version (``tblock_sharded.plain_block``: K steps of the whole carry,
the walls and the lid density keyed to each cell's global cell) in place of
each launch.  It is held here to the JAX package's sharded temporal-block
Pallas kernel run in interpret mode (as ``tests/test_tblock_sharded.py``
runs it, K=8 at 128x64), at atol 2e-5 in float32; and, with the density
summed in the kernels' order (``torch.sum`` over the populations rounds
differently for tensors of different shapes), to the port's fused engine bit
for bit, on ragged shapes, on shards as thin as K and on a field short
enough that one window holds both images of the lid row.
"""

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch import sim as t_sim
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.kernels import pull_sharded, tblock_sharded
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu import parallel as j_par
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels.pallas_pull_tblock_sharded import (
    make_sharded_tblock_runner,
)

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)


def _cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("mesh_shape, collision, n", [
    ((2, 1), "mrt", 16),   # two blocks of K
    ((2, 2), "srt", 20),   # the remainder through the one-step sharded kernel
])
def test_matches_pallas_interpret(mesh_shape, collision, n):
    base = dict(nx=128, ny=64, reynolds=400.0, collision=collision,
                precision="float32", mesh_shape=mesh_shape)
    jc, tc = JConfig(**base), TConfig(**base)
    j_mesh = j_par.make_mesh(mesh_shape)
    j_out = make_sharded_tblock_runner(jc, n, j_mesh, k_steps=8, interpret=True)(
        j_par.shard_state(j_eng.init_state(jc), j_mesh))
    mesh = _cpu_mesh(mesh_shape)
    runner = tblock_sharded.make_sharded_runner(tc, n, mesh, k_steps=8)
    out = unshard_state(runner(shard_state(t_eng.init_state(tc, CPU), mesh)), CPU)
    np.testing.assert_allclose(out.f.numpy(), np.asarray(j_out.f), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out.rho_lid.numpy(), np.asarray(j_out.rho_lid),
                               rtol=0, atol=2e-5)


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


@pytest.mark.parametrize("nx, ny, mesh_shape, collision, k, n", [
    (70, 46, (2, 2), "mrt", 5, 10),    # shards narrower than the window
    (140, 96, (2, 1), "trt", 8, 16),   # ragged last tiles
    (64, 40, (1, 5), "srt", 8, 16),    # ly == K: wall images on every shard
    (36, 28, (1, 1), "mrt", 5, 10),    # both lid images in one window
    (66, 40, (3, 2), "srt", 5, 13),    # with a remainder
])
def test_equals_the_fused_engine(ordered_sum, nx, ny, mesh_shape, collision, k, n):
    cfg = TConfig(nx=nx, ny=ny, reynolds=400.0, collision=collision,
                  mesh_shape=mesh_shape)
    gen = torch.Generator().manual_seed(0)
    s0 = t_eng.init_state(cfg, CPU)
    s0 = t_eng.State(s0.f * (1.0 + 1e-3 * torch.randn(s0.f.shape, generator=gen)),
                     s0.rho_lid)
    ref = s0
    step = t_eng.make_fused_step(cfg)
    for _ in range(n):
        ref = step(ref)
    mesh = _cpu_mesh(mesh_shape)
    out = tblock_sharded.make_sharded_runner(cfg, n, mesh, k_steps=k)(shard_state(s0, mesh))
    for ix, iy in mesh.shards():
        assert torch.equal(out.rho_lid[ix][iy], out.rho_lid[ix][0])
    out = unshard_state(out, CPU)
    assert torch.equal(out.f, ref.f)
    assert torch.equal(out.rho_lid, ref.rho_lid)


def test_plain_block_in_float64(ordered_sum):
    """The plain version itself (the module refuses float64, as its kernel
    does): K steps of a K-padded carry equal K fused steps to 1e-12."""
    cfg = TConfig(nx=48, ny=40, reynolds=400.0, collision="mrt", precision="float64",
                  mesh_shape=(2, 2))
    k = 6
    ref = s0 = t_eng.init_state(cfg, CPU)
    step = t_eng.make_fused_step(cfg)
    for _ in range(k):
        ref = step(ref)
    mesh = _cpu_mesh(cfg.mesh_shape)
    sharded = shard_state(s0, mesh)
    carries = halo.exchange_halo(sharded.f, k)
    panels = halo.pad_rows(sharded.rho_lid, k)
    halo.copy_pairs(halo.row_halo_pairs(panels, k))
    for ix, iy in mesh.shards():
        fp, rl = tblock_sharded.plain_block(cfg, carries[ix][iy], panels[ix][iy],
                                            (ix * 24, iy * 20), k)
        want = ref.f[:, ix * 24:(ix + 1) * 24, iy * 20:(iy + 1) * 20]
        torch.testing.assert_close(fp[:, k:k + 24, k:k + 20], want, rtol=0, atol=1e-12)
        if iy == 0:
            torch.testing.assert_close(rl[k:k + 24, k], ref.rho_lid[ix * 24:(ix + 1) * 24],
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw, k, reason", [
    (dict(precision="float64"), 5, "float32"),
    (dict(turbulence="smagorinsky", van_driest=True), 5, "Van Driest"),
    (dict(), 32, "k_steps"),
    (dict(), 0, "k_steps"),
    (dict(ny=32, mesh_shape=(1, 8)), 5, "narrower than the K=5 halo"),
    (dict(nx=65), 5, "divide"),
])
def test_unsupported_configurations_raise(kw, k, reason):
    cfg = TConfig(**{"nx": 64, "ny": 64, "mesh_shape": (2, 2), **kw})
    assert reason in tblock_sharded.unsupported_reason(cfg, k)
    with pytest.raises(ValueError, match=reason):
        tblock_sharded.make_sharded_runner(cfg, 10, _cpu_mesh(cfg.mesh_shape), k_steps=k)


def test_default_k_and_launch_refusals():
    assert tblock_sharded.K_STEPS == 5
    cfg = TConfig(nx=32, ny=32, mesh_shape=(2, 2))
    fp = torch.zeros(9, 26, 26)
    panel = torch.ones(26)
    with pytest.raises(ValueError, match="in place"):
        tblock_sharded.block_step(cfg, fp, panel, (0, 0), fp, panel.clone())
    with pytest.raises(ValueError, match="shape"):
        tblock_sharded.block_step(cfg, fp, panel, (0, 0), fp.clone(), torch.ones(25))
    assert pull_sharded.unsupported_reason(cfg) is None


@pytest.mark.parametrize("kw, backend, devices, expect", [
    (dict(), "cuda-sharded-tblock", [CUDA] * 4, "cuda-sharded-tblock"),
    (dict(), "cuda-sharded-tblock", [CUDA], "cuda-sharded-tblock"),  # a 1x1 mesh
    (dict(), "auto", ["cpu"] * 4, "sharded"),
])
def test_routing(kw, backend, devices, expect):
    cfg = TConfig(**{"nx": 64, "ny": 64, "mesh_shape": (2, 2), **kw})
    if len(devices) == 1:
        cfg = TConfig(nx=64, ny=64)
    mesh = make_mesh(cfg.mesh_shape, devices)
    assert t_sim._select_backend(cfg, backend, mesh).name == expect


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_auto_takes_the_sharded_temporal_block_kernel_from_the_measured_size(n):
    """``auto`` on a mesh of cards takes cuda-sharded-tblock for shards of
    ``SHARDED_TBLOCK_AUTO_MIN_CELLS`` cells (None: never), cuda-sharded
    below it."""
    cfg = TConfig(nx=n, ny=n, reynolds=5000.0, collision="mrt", mesh_shape=(2, 2))
    threshold = t_sim.SHARDED_TBLOCK_AUTO_MIN_CELLS
    want = ("cuda-sharded-tblock"
            if threshold is not None and (n // 2) * (n // 2) >= threshold
            else "cuda-sharded")
    mesh = make_mesh(cfg.mesh_shape, [CUDA] * 4)
    assert t_sim._select_backend(cfg, "auto", mesh).name == want


@pytest.mark.parametrize("backend, n", [("cuda-sharded-tblock", 64), ("auto", 4096)])
def test_the_temporal_block_route_refreshes_through_the_exchange_kernel(
        monkeypatch, backend, n):
    """On a one-process mesh of CUDA devices the ``cuda-sharded-tblock``
    route builds its runner with ``halo_impl="rdma"`` (the exchange kernel's
    one launch per card, ahead of the strip copies in every reading of
    chip_smoke.py; the same bits): the selection alone, no card needed."""
    asked = []
    monkeypatch.setattr(tblock_sharded, "make_sharded_runner",
                        lambda cfg, n_steps, mesh, **kw: asked.append(kw))
    cfg = TConfig(nx=n, ny=n, reynolds=5000.0, collision="mrt", mesh_shape=(2, 2))
    mesh = make_mesh(cfg.mesh_shape, [CUDA] * 4)
    assert not mesh.spans_processes
    routed = t_sim._select_backend(cfg, backend, mesh)
    assert routed.name == "cuda-sharded-tblock"
    routed.make_runner(10)
    assert t_sim.SHARDED_TBLOCK_HALO_IMPL == "rdma"
    assert asked == [{"halo_impl": "rdma"}]


def test_explicit_kernel_off_the_card_raises(tmp_path):
    cfg = TConfig(nx=64, ny=64, reynolds=100.0, max_steps=20, report_interval=10,
                  mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="CUDA devices"):
        t_sim.simulate(cfg, t_sim.SimOptions(out_dir=str(tmp_path), verbose=False,
                                             backend="cuda-sharded-tblock"),
                       device=["cpu"] * 4)
    with pytest.raises(ValueError, match="Van Driest"):
        t_sim._select_backend(
            TConfig(nx=64, ny=64, turbulence="smagorinsky", van_driest=True,
                    mesh_shape=(2, 2)),
            "cuda-sharded-tblock", make_mesh((2, 2), [CUDA] * 4))
