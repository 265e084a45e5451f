"""The sharded one-step kernel's module on the CPU.

On CPU shards the module's runner does its exchanges and runs its plain
version (``parallel.halo.local_step``) in place of each launch; it is held
here to the JAX package's sharded Pallas kernel run in interpret mode (as
``tests/test_pallas_sharded.py`` runs it), on the 8 virtual CPU devices of
``conftest.py``: the module itself in float32 to atol 2e-5 over 12 steps, the
plain sharded engine in float64 to 1e-12 (the module refuses float64, as its
kernel does).  The kernel is held to the plain version by
``test_torch_csrc_emulated.py`` and, on the card, by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch import sim as t_sim
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.kernels import pull_sharded
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    make_sharded_scan_runner,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu import parallel as j_par
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels.pallas_pull_sharded import (
    make_sharded_pallas_runner,
)

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)
STEPS = 12


def _cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("mesh_shape, kw, precision, tol", [
    ((2, 2), dict(collision="srt"), "float32", 2e-5),
    ((2, 4), dict(collision="mrt", turbulence="smagorinsky", van_driest=True,
                  reynolds=10000.0), "float32", 2e-5),
    ((2, 2), dict(collision="mrt"), "float64", 1e-12),
], ids=["srt_2x2_f32", "mrt_van_driest_2x4_f32", "mrt_2x2_f64"])
def test_matches_pallas_interpret(mesh_shape, kw, precision, tol):
    base = {"nx": 64, "ny": 64, "reynolds": 400.0, "precision": precision,
            "mesh_shape": mesh_shape, **kw}
    jc, tc = JConfig(**base), TConfig(**base)
    j_mesh = j_par.make_mesh(mesh_shape)
    j_out = make_sharded_pallas_runner(jc, STEPS, j_mesh, interpret=True)(
        j_par.shard_state(j_eng.init_state(jc), j_mesh))
    mesh = _cpu_mesh(mesh_shape)
    if precision == "float32":
        runner = pull_sharded.make_sharded_runner(tc, STEPS, mesh)
    else:
        runner = make_sharded_scan_runner(tc, STEPS, mesh)
    out = unshard_state(runner(shard_state(t_eng.init_state(tc, CPU), mesh)), CPU)
    np.testing.assert_allclose(out.f.numpy(), np.asarray(j_out.f), rtol=0, atol=tol)
    np.testing.assert_allclose(out.rho_lid.numpy(), np.asarray(j_out.rho_lid),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("n_steps", [0, 1, 6, 7])
def test_runner_equals_the_plain_engine_and_leaves_its_input(n_steps):
    """Both parities of the two-buffer ping-pong; the runner's copies are
    counted; the input is never written."""
    cfg = TConfig(nx=40, ny=24, reynolds=400.0, collision="mrt", mesh_shape=(2, 2))
    mesh = _cpu_mesh(cfg.mesh_shape)
    s0 = shard_state(t_eng.init_state(cfg, CPU), mesh)
    f0 = [[b.clone() for b in col] for col in s0.f]
    before = halo.copies
    out = pull_sharded.make_sharded_runner(cfg, n_steps, mesh)(s0)
    if n_steps:
        # pad f and copy rho_lid, 4 strips per shard per step, replicate
        # the lid density, unpad f
        assert halo.copies - before == 8 + 16 * n_steps + 2 + 4
    ref = make_sharded_scan_runner(cfg, n_steps, mesh)(s0)
    a, b = unshard_state(out, CPU), unshard_state(ref, CPU)
    assert torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)
    for ix, iy in mesh.shards():
        assert torch.equal(s0.f[ix][iy], f0[ix][iy])
        assert torch.equal(out.rho_lid[ix][iy], out.rho_lid[ix][0])


def test_the_carry_rows_start_on_a_line():
    """The kernel's carry puts the first cell of every row on a 128-byte
    line (y0 and the pitch multiples of 32 float32s), one halo row before
    it and one after."""
    for lx, ly in [(8, 12), (2048, 2048), (5, 1), (3, 31)]:
        lay = pull_sharded.layout(lx, ly)
        assert lay.y0 == 32 and lay.pitch % 32 == 0 and lay.pitch >= 32 + ly + 1
        assert lay.new(torch.zeros(9, lx, ly)).shape == (9, lx + 2, lay.pitch)


def test_shard_step_refuses_what_the_kernel_does_not_take():
    cfg = TConfig(nx=16, ny=12, reynolds=400.0, mesh_shape=(2, 1))
    lay = pull_sharded.layout(8, 12)
    fp = torch.zeros(9, 10, lay.pitch)
    rho = torch.ones(8)
    flags = (True, False, True, True)
    with pytest.raises(ValueError, match="in place"):
        pull_sharded.shard_step(cfg, lay, fp, rho, flags, None, fp, torch.ones(8))
    with pytest.raises(ValueError, match="float64"):
        pull_sharded.shard_step(cfg, lay, fp.double(), rho, flags, None, fp.clone(),
                                rho.clone())
    with pytest.raises(ValueError, match="shape"):
        pull_sharded.shard_step(cfg, lay, fp, torch.ones(7), flags, None, fp.clone(),
                                rho.clone())
    with pytest.raises(ValueError, match="shape"):
        pull_sharded.shard_step(cfg, lay, torch.zeros(9, 10, 14), rho, flags, None,
                                torch.zeros(9, 10, 14), rho.clone())
    with pytest.raises(ValueError, match="one-cell halo"):
        pull_sharded.shard_step(cfg, halo.Layout.tight(8, 12, 2), fp, rho, flags, None,
                                fp.clone(), rho.clone())
    vd = TConfig(nx=16, ny=12, turbulence="smagorinsky", van_driest=True,
                 mesh_shape=(2, 1))
    with pytest.raises(ValueError, match="Van Driest"):
        pull_sharded.shard_step(vd, lay, fp, rho, flags, None, fp.clone(), rho.clone())
    for kw, reason in [(dict(precision="float64"), "float32"),
                       (dict(boundary="nebb_tangential"), "NEBB"),
                       (dict(nx=15), "divide")]:
        bad = TConfig(**{"nx": 16, "ny": 12, "mesh_shape": (2, 1), **kw})
        assert reason in pull_sharded.unsupported_reason(bad)
        with pytest.raises(ValueError, match=reason):
            pull_sharded.make_sharded_runner(bad, 2, _cpu_mesh((2, 1)))


@pytest.mark.parametrize("kw, backend, devices, expect", [
    (dict(), "auto", ["cpu"] * 4, "sharded"),
    (dict(precision="float64"), "auto", ["cpu"] * 4, "sharded"),
    (dict(), "sharded", ["cpu"] * 4, "sharded"),
    # Routing only names the runner; it touches no device.
    (dict(), "auto", [CUDA] * 4, "cuda-sharded"),
    (dict(turbulence="smagorinsky", van_driest=True), "auto", [CUDA] * 4, "cuda-sharded"),
    (dict(precision="float64"), "auto", [CUDA] * 4, "sharded"),
    (dict(), "cuda-sharded", [CUDA] * 4, "cuda-sharded"),
    (dict(), "sharded", [CUDA] * 4, "sharded"),
])
def test_routing(kw, backend, devices, expect):
    cfg = TConfig(**{"nx": 32, "ny": 32, "mesh_shape": (2, 2), **kw})
    mesh = make_mesh(cfg.mesh_shape, devices)
    assert t_sim._select_backend(cfg, backend, mesh).name == expect


@pytest.mark.parametrize("kw, backend, devices, match", [
    (dict(), "cuda-sharded", ["cpu"] * 4, "CUDA devices"),
    (dict(precision="float64"), "cuda-sharded", [CUDA] * 4, "float32"),
    (dict(nx=33), "cuda-sharded", [CUDA] * 4, "divide"),
    (dict(boundary="bounce_back"), "cuda-sharded", [CUDA] * 4, "single-device"),
    (dict(), "cuda-pull", [CUDA] * 4, "single-device"),
    (dict(), "torch", ["cpu"] * 4, "single-device"),
])
def test_routing_refuses(kw, backend, devices, match):
    cfg = TConfig(**{"nx": 32, "ny": 32, "mesh_shape": (2, 2), **kw})
    with pytest.raises(ValueError, match=match):
        t_sim._select_backend(cfg, backend, make_mesh(cfg.mesh_shape, devices))


def test_explicit_kernel_off_the_card_raises(tmp_path):
    cfg = TConfig(nx=32, ny=32, reynolds=100.0, max_steps=20, report_interval=10,
                  mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="CUDA devices"):
        t_sim.simulate(cfg, t_sim.SimOptions(out_dir=str(tmp_path), verbose=False,
                                             backend="cuda-sharded"),
                       device=["cpu"] * 4)
    with pytest.raises(ValueError, match="CUDA devices"):
        t_sim.run_to_convergence(cfg, device=["cpu"] * 4, backend="cuda-sharded")
