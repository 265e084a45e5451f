"""Per-function parity of the port's ops with the JAX package's, in float64
on random fields (tolerance 1e-12: the same formulas, summed in possibly
different orders)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _mod(pkg, name):
    # ``ops/__init__`` re-exports functions that shadow some module names
    return importlib.import_module(f"{pkg}.ops.{name}")


t_bc, t_coll, t_eq, t_st = (_mod("latticeboltzmannsimulations_torch", m)
                            for m in ("boundary", "collision", "equilibrium", "streaming"))
j_bc, j_coll, j_eq, j_st = (_mod("latticeboltzmannsimulations_tpu", m)
                            for m in ("boundary", "collision", "equilibrium", "streaming"))

TOL = 1e-12
NX, NY = 12, 9


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    f = 1.0 / 9.0 + 0.01 * rng.standard_normal((9, NX, NY))
    feq = 1.0 / 9.0 + 0.01 * rng.standard_normal((9, NX, NY))
    rho = 1.0 + 0.05 * rng.standard_normal((NX, NY))
    u = 0.05 * rng.standard_normal((2, NX, NY))
    omega = 1.2 + 0.3 * rng.random((NX, NY))
    return f, feq, rho, u, omega


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def _j(a):
    return jnp.asarray(a, dtype=jnp.float64)


def _close(t_out, j_out):
    t_out = t_out if isinstance(t_out, (tuple, list)) else (t_out,)
    j_out = j_out if isinstance(j_out, (tuple, list)) else (j_out,)
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


def test_equilibrium_and_moments():
    f, feq, rho, u, _ = _fields()
    _close(t_eq.equilibrium(_t(rho), _t(u)), j_eq.equilibrium(_j(rho), _j(u)))
    _close(t_eq.macroscopics(_t(f)), j_eq.macroscopics(_j(f)))
    _close(t_eq.lid_row_density(_t(f[:, :, 0])), j_eq.lid_row_density(_j(f[:, :, 0])))
    _close(t_eq.momentum_flux_xy(_t(f), _t(feq)), j_eq.momentum_flux_xy(_j(f), _j(feq)))


@pytest.mark.parametrize("fn", ["gather_pull", "stream_push", "stream_pull"])
def test_streaming_matches(fn):
    f = _fields(1)[0]
    np.testing.assert_array_equal(getattr(t_st, fn)(_t(f)).numpy(),
                                  np.asarray(getattr(j_st, fn)(_j(f))))


def test_gather_pull_wraps_at_every_edge():
    """out[k](x, y) = f[k](x - cx_k, y + cy_k) with indices taken modulo the
    grid: the far edge's value arrives at the near edge, in both axes."""
    f = np.arange(9 * NX * NY, dtype=np.float64).reshape(9, NX, NY)
    out = t_st.gather_pull(_t(f)).numpy()
    cx = [0, 1, 0, -1, 0, 1, -1, -1, 1]
    cy = [0, 0, 1, 0, -1, 1, 1, -1, -1]
    for k in range(9):
        for x in (0, NX - 1):
            for y in range(NY):
                assert out[k, x, y] == f[k, (x - cx[k]) % NX, (y + cy[k]) % NY]
        for y in (0, NY - 1):
            for x in range(NX):
                assert out[k, x, y] == f[k, (x - cx[k]) % NX, (y + cy[k]) % NY]
    # a clamped shift would repeat the edge value instead of wrapping
    assert out[1, 0, 3] == f[1, NX - 1, 3]
    assert out[2, 4, NY - 1] == f[2, 4, 0]


@pytest.mark.parametrize("field_omega", [False, True])
def test_collisions_match(field_omega):
    f, feq, _, _, omega_f = _fields(2)
    om = omega_f if field_omega else 1.37
    t_om = _t(om) if field_omega else om
    j_om = _j(om) if field_omega else om
    _close(t_coll.srt_collide(_t(f), _t(feq), t_om),
           j_coll.srt_collide(_j(f), _j(feq), j_om))
    _close(t_coll.trt_collide(_t(f), _t(feq), t_om, 1.1),
           j_coll.trt_collide(_j(f), _j(feq), j_om, 1.1))
    _close(t_coll.mrt_collide(_t(f), t_om, 1.05, 0.95, 1.2),
           j_coll.mrt_collide(_j(f), j_om, 1.05, 0.95, 1.2))


def test_mrt_transforms_match():
    f, _, rho, u, _ = _fields(3)
    m_t, m_j = t_coll.mrt_moments(_t(f)), j_coll.mrt_moments(_j(f))
    _close(m_t, m_j)
    _close(t_coll.mrt_from_moments(m_t), j_coll.mrt_from_moments(m_j))
    _close(t_coll.mrt_from_moments(m_t), _t(f))  # exact inverse
    _close(t_coll.mrt_moment_equilibrium(_t(rho), _t(u[0]), _t(u[1])),
           j_coll.mrt_moment_equilibrium(_j(rho), _j(u[0]), _j(u[1])))


def test_smagorinsky_and_van_driest_match():
    f, feq, rho, _, _ = _fields(4)
    _close(t_coll.smagorinsky_tau(_t(f), _t(feq), _t(rho), 0.53, 0.025),
           j_coll.smagorinsky_tau(_j(f), _j(feq), _j(rho), 0.53, 0.025))
    cs2_t = t_coll.van_driest_cs2(NX, NY, 0.7, dtype=torch.float64)
    cs2_j = j_coll.van_driest_cs2(NX, NY, 0.7, dtype=jnp.float64)
    _close(cs2_t, cs2_j)
    _close(t_coll.smagorinsky_tau(_t(f), _t(feq), _t(rho), 0.53, cs2_t),
           j_coll.smagorinsky_tau(_j(f), _j(feq), _j(rho), 0.53, cs2_j))


@pytest.mark.parametrize("lid_corners", ["wall", "lid"])
def test_override_wall_velocity_matches(lid_corners):
    f, _, rho, u, _ = _fields(5)
    u_in, rho_in = _t(u), _t(rho)
    out_t = t_bc.override_wall_velocity(u_in, rho_in, _t(f), 0.08, lid_corners)
    out_j = j_bc.override_wall_velocity(_j(u), _j(rho), _j(f), 0.08, lid_corners)
    _close(out_t, out_j)
    # the inputs are left alone, as JAX's immutable arrays are
    np.testing.assert_array_equal(u_in.numpy(), u)
    np.testing.assert_array_equal(rho_in.numpy(), rho)


def test_population_sum_adds_in_lattice_order_for_every_shape():
    """The density is f0 + f1 + ... + f8 added one by one, in float32 the
    same bits for a field alone and inside a wider stack (torch.sum's order
    depends on the shape), and the order the CUDA kernels add in."""
    rng = np.random.default_rng(5)
    f = torch.from_numpy((rng.random((9, NX, NY)) * np.logspace(-3, 0, 9)[:, None, None])
                         .astype(np.float32))
    want = f[0]
    for k in range(1, 9):
        want = want + f[k]
    assert torch.equal(t_eq.population_sum(f), want)
    assert torch.equal(t_eq.macroscopics(f)[0], want)
    wide = torch.cat([f, torch.from_numpy(rng.random((9, 3 * NX, NY)).astype(np.float32))], 1)
    assert torch.equal(t_eq.population_sum(wide)[:NX], want)
    tail = f[1]
    for k in range(2, 9):
        tail = tail + f[k]
    assert torch.equal(t_eq.population_sum(f, 1), tail)
