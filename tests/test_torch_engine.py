"""The port's fused engine against the JAX package's, step for step.

Tolerances: float64 to 1e-12 (the same formulas; only the order of a few
sums differs); float32 to atol 2e-5 over 20 steps, the convention for an
independent float32 implementation (as for the native engine)."""

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.convert import state_from_numpy, state_to_numpy
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig

TOL = {"float64": 1e-12, "float32": 2e-5}
STEPS = 20

CASES = {
    "srt": dict(collision="srt"),
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
    "mrt_smagorinsky": dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    "trt_smagorinsky": dict(collision="trt", turbulence="smagorinsky", reynolds=5000.0),
    "srt_van_driest": dict(collision="srt", turbulence="smagorinsky",
                           van_driest=True, reynolds=5000.0),
    "mrt_nebb_tangential": dict(collision="mrt", boundary="nebb_tangential"),
}


def _configs(precision, **kw):
    base = dict(nx=32, ny=24, reynolds=400.0, precision=precision)
    base.update(kw)
    return TConfig(**base), JConfig(**base)


def _start(jc, seed=0):
    """The JAX start state with seeded noise, as numpy arrays for both."""
    s = j_eng.init_state(jc)
    dtype = np.asarray(s.f).dtype
    rng = np.random.default_rng(seed)
    f = np.asarray(s.f) * (1.0 + 1e-3 * rng.standard_normal(s.f.shape))
    return f.astype(dtype), np.asarray(s.rho_lid)


def _assert_states_close(t_state, j_state, tol):
    f, lid = state_to_numpy(t_state)
    np.testing.assert_allclose(f, np.asarray(j_state.f), rtol=0, atol=tol)
    np.testing.assert_allclose(lid, np.asarray(j_state.rho_lid), rtol=0, atol=tol)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_matches_jax(case, precision):
    tc, jc = _configs(precision, **CASES[case])
    f0, lid0 = _start(jc)
    t_state = state_from_numpy(f0, lid0, device="cpu")
    j_state = j_eng.State(f=jax.numpy.asarray(f0), rho_lid=jax.numpy.asarray(lid0))
    t_step = t_eng.make_fused_step(tc)
    j_step = jax.jit(j_eng.make_fused_step(jc))
    for _ in range(STEPS):
        t_state = t_step(t_state)
        j_state = j_step(j_state)
    assert t_state.f.dtype == tc.dtype
    _assert_states_close(t_state, j_state, TOL[precision])


def test_init_state_matches_jax():
    for precision in ("float64", "float32"):
        tc, jc = _configs(precision)
        _assert_states_close(t_eng.init_state(tc, device="cpu"),
                             j_eng.init_state(jc), 0.0)


def test_fused_step_omega_matches_jax():
    tc, jc = _configs("float64", collision="trt", turbulence="smagorinsky")
    f0, lid0 = _start(jc, seed=1)
    t_state = state_from_numpy(f0, lid0, device="cpu")
    j_state = j_eng.State(f=jax.numpy.asarray(f0), rho_lid=jax.numpy.asarray(lid0))
    t_step = t_eng.make_fused_step_omega(tc)
    j_step = jax.jit(j_eng.make_fused_step_omega(jc))
    for _ in range(10):
        t_state = t_step(t_state, 1.63)
        j_state = j_step(j_state, 1.63)
    _assert_states_close(t_state, j_state, TOL["float64"])


@pytest.mark.parametrize("boundary", ["nebb", "nebb_tangential"])
def test_observables_match_jax(boundary):
    tc, jc = _configs("float64", collision="mrt", boundary=boundary)
    f0, lid0 = _start(jc, seed=2)
    rho_t, u_t = t_eng.observables(tc, state_from_numpy(f0, lid0, device="cpu"))
    rho_j, u_j = j_eng.observables(
        jc, j_eng.State(f=jax.numpy.asarray(f0), rho_lid=jax.numpy.asarray(lid0)))
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-12)


def test_scan_runner_equals_stepping():
    tc, _ = _configs("float32", collision="mrt")
    s0 = t_eng.init_state(tc, device="cpu")
    out = t_eng.make_scan_runner(tc, 5, device="cpu")(s0)
    s = s0
    step = t_eng.make_fused_step(tc)
    for _ in range(5):
        s = step(s)
    assert torch.equal(out.f, s.f) and torch.equal(out.rho_lid, s.rho_lid)


def test_run_to_convergence_matches_jax():
    kw = dict(nx=32, ny=32, reynolds=10.0, precision="float64",
              max_steps=8000, report_interval=100, convergence_tol=1e-5)
    t_res = t_eng.run_to_convergence(TConfig(**kw), device="cpu")
    j_res = j_eng.run_to_convergence(JConfig(**kw))
    assert j_res.converged and t_res.converged
    assert t_res.steps == j_res.steps
    np.testing.assert_allclose(t_res.mean_u_history, j_res.mean_u_history,
                               rtol=0, atol=1e-10)
    _assert_states_close(t_res.state, j_res.state, 1e-10)


def test_run_to_convergence_callback_and_divergence():
    seen = []
    cfg = TConfig(nx=16, ny=16, reynolds=100.0, max_steps=40, report_interval=20)
    res = t_eng.run_to_convergence(
        cfg, callback=lambda step, s, rho, u: seen.append((step, tuple(u.shape))),
        device="cpu")
    assert res.steps == 40 and seen == [(20, (2, 16, 16)), (40, (2, 16, 16))]
    # omega close to 2: diverges within a few hundred steps
    bad = TConfig(nx=16, ny=16, reynolds=200000.0, collision="srt",
                  max_steps=2000, report_interval=100, convergence_tol=0.0)
    with pytest.raises(FloatingPointError):
        t_eng.run_to_convergence(bad, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TConfig(nx=16, ny=16)
    for call in (lambda: t_eng.init_state(cfg),
                 lambda: t_eng.make_scan_runner(cfg, 2),
                 lambda: t_eng.run_to_convergence(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_state_conversion_round_trip_and_checks():
    rng = np.random.default_rng(3)
    f = rng.random((9, 8, 6)).astype(np.float32)
    lid = rng.random(8).astype(np.float32)
    s = state_from_numpy(f, lid, device="cpu")
    assert s.f.dtype == torch.float32 and s.f.is_contiguous()
    f2, lid2 = state_to_numpy(s)
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_array_equal(lid2, lid)
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(f[:8], lid, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(f, lid[:7], device="cpu")
    with pytest.raises(ValueError, match="float32"):
        state_from_numpy(f, lid.astype(np.float64), device="cpu")
