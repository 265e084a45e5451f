"""The port's push and pull oracles, and the push kernel's module on the CPU,
against the JAX package on the same start states (made with numpy from a
seed).

Tolerances: float64 to 1e-12 over 10 steps (the same formulas; only the
order of a few sums differs); float32 to atol 2e-5 over 20 steps, the
convention for an independent float32 implementation.  The push kernel's
module is held to the JAX Pallas push kernel run in interpret mode, as that
package's own tests run it on the CPU (``tests/test_pallas_push.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.kernels import push
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels import pallas_push

TOL = {"float64": 1e-12, "float32": 2e-5}
STEPS = {"float64": 10, "float32": 20}

CASES = {
    "nebb_srt": dict(collision="srt"),
    "nebb_trt": dict(collision="trt"),
    "nebb_mrt": dict(collision="mrt"),
    "nebb_mrt_smagorinsky": dict(collision="mrt", turbulence="smagorinsky",
                                 reynolds=5000.0),
    "nebb_srt_van_driest": dict(collision="srt", turbulence="smagorinsky",
                                van_driest=True, reynolds=5000.0),
    "nebb_west_eq_mrt": dict(collision="mrt", boundary="nebb_west_eq"),
    "nebb_west_eq_trt": dict(collision="trt", boundary="nebb_west_eq"),
    "bounce_back_srt": dict(collision="srt", boundary="bounce_back"),
    "bounce_back_trt": dict(collision="trt", boundary="bounce_back"),
    "bounce_back_mrt": dict(collision="mrt", boundary="bounce_back"),
    "nebb_tangential_mrt": dict(collision="mrt", boundary="nebb_tangential"),
}


def _configs(precision, **kw):
    base = dict(nx=32, ny=24, reynolds=400.0, precision=precision)
    base.update(kw)
    return TConfig(**base), JConfig(**base)


def _start_f(jc, seed=0):
    """The JAX start field with seeded noise, as a numpy array."""
    f = np.asarray(j_eng.init_state(jc).f)
    rng = np.random.default_rng(seed)
    return (f * (1.0 + 1e-3 * rng.standard_normal(f.shape))).astype(f.dtype)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_push_oracle_matches_jax(case, precision):
    tc, jc = _configs(precision, **CASES[case])
    f0 = _start_f(jc)
    t_step = t_eng.make_push_oracle_step(tc)
    j_step = jax.jit(j_eng.make_push_oracle_step(jc))
    f_t, f_j = torch.tensor(f0), jnp.asarray(f0)
    for _ in range(STEPS[precision]):
        f_t, f_j = t_step(f_t), j_step(f_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=TOL[precision])


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("case", ["nebb_srt", "nebb_mrt", "nebb_mrt_smagorinsky"])
def test_pull_oracle_matches_jax(case, precision):
    tc, jc = _configs(precision, **CASES[case])
    f0 = _start_f(jc, seed=1)
    j_state = j_eng.init_pull_oracle_state(jc)._replace(f=jnp.asarray(f0))
    t_state = t_eng.init_pull_oracle_state(tc, device="cpu")._replace(f=torch.tensor(f0))
    np.testing.assert_array_equal(t_state.feq.numpy(), np.asarray(j_state.feq))
    t_step = t_eng.make_pull_oracle_step(tc)
    j_step = jax.jit(j_eng.make_pull_oracle_step(jc))
    for _ in range(STEPS[precision]):
        t_state, j_state = t_step(t_state), j_step(j_state)
    for got, want in zip(t_state, j_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL[precision])


def test_pull_oracle_and_fused_step_agree():
    """The fused step is the pull oracle with the equilibrium reduced away:
    both give the same populations (float64, 1e-12 over 10 steps)."""
    tc, _ = _configs("float64", collision="mrt")
    o_state = t_eng.init_pull_oracle_state(tc, device="cpu")
    f_state = t_eng.init_state(tc, device="cpu")
    o_step, f_step = t_eng.make_pull_oracle_step(tc), t_eng.make_fused_step(tc)
    for _ in range(10):
        o_state, f_state = o_step(o_state), f_step(f_state)
    torch.testing.assert_close(o_state.f, f_state.f, rtol=0, atol=1e-12)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("case", ["nebb_srt", "nebb_trt", "nebb_mrt",
                                  "nebb_mrt_smagorinsky"])
def test_push_module_matches_pallas_interpret(case, precision):
    """Against the Pallas push kernel (interpret mode): in float64 the
    module's plain version (the push oracle) to 1e-12 over 10 steps; in
    float32 the module itself, whose wrapper runs that plain version on CPU
    tensors, to atol 2e-5 over 20 steps.  (The wrapper refuses float64, as
    the kernel does.)"""
    base = dict(nx=64, ny=64, reynolds=400.0, precision=precision)
    base.update(CASES[case])
    tc, jc = TConfig(**base), JConfig(**base)
    f0 = _start_f(jc, seed=2)
    if precision == "float64":
        t_step = t_eng.make_push_oracle_step(tc)
    else:
        t_step = push.make_push_step(tc, device="cpu")
    j_step = jax.jit(pallas_push.make_push_step(jc, interpret=True))
    f_t, f_j = torch.tensor(f0), jnp.asarray(f0)
    for _ in range(STEPS[precision]):
        f_t, f_j = t_step(f_t), j_step(f_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=TOL[precision])


@pytest.mark.parametrize("case", ["nebb_west_eq_mrt", "nebb_west_eq_trt",
                                  "bounce_back_srt", "bounce_back_trt",
                                  "bounce_back_mrt"])
def test_push_module_matches_jax_oracle(case):
    """The module for the walls that the Pallas push kernel refuses
    (``nebb_west_eq``, ``bounce_back``; the JAX package runs them on its push
    oracle) against the JAX push oracle: float32, atol 2e-5 over 20 steps,
    the step and the scan runner, whose wrappers run the plain version on
    CPU tensors."""
    tc, jc = _configs("float32", **CASES[case])
    f0 = _start_f(jc, seed=3)
    j_step = jax.jit(j_eng.make_push_oracle_step(jc))
    f_j = jnp.asarray(f0)
    for _ in range(STEPS["float32"]):
        f_j = j_step(f_j)
    step = push.make_push_step(tc, device="cpu")
    f_t = torch.tensor(f0)
    for _ in range(STEPS["float32"]):
        f_t = step(f_t)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=TOL["float32"])
    f_run = push.make_push_scan_runner(tc, STEPS["float32"], device="cpu")(torch.tensor(f0))
    assert torch.equal(f_run, f_t)


def test_push_runners_on_cpu_equal_stepping():
    cfg = TConfig(nx=20, ny=16, reynolds=400.0, collision="mrt")
    f0 = t_eng.init_state(cfg, device="cpu").f
    step = push.make_push_step(cfg, device="cpu")
    f = f0
    for _ in range(3):
        f = step(f)
    assert torch.equal(push.make_push_scan_runner(cfg, 3, device="cpu")(f0), f)
    state = push.make_scan_runner(cfg, 3, device="cpu")(t_eng.init_state(cfg, device="cpu"))
    assert torch.equal(state.f, f) and torch.equal(state.rho_lid, f[0, :, 0])
    oracle = t_eng.make_push_scan_runner(cfg, 3, device="cpu")(t_eng.init_state(cfg, device="cpu"))
    assert torch.equal(oracle.f, f)


@pytest.mark.parametrize("kw, reason", [
    (dict(precision="float64"), "float32"),
    (dict(boundary="bounce_back", turbulence="smagorinsky", van_driest=True),
     "Van Driest"),
    (dict(boundary="nebb_tangential"), "NEBB"),
    (dict(turbulence="smagorinsky", van_driest=True), "Van Driest"),
    (dict(mesh_shape=(2, 1)), "one device"),
])
def test_push_kernel_refusals(kw, reason):
    cfg = TConfig(nx=16, ny=16, **kw)
    assert reason in push.unsupported_reason(cfg)
    with pytest.raises(ValueError, match=reason):
        push.make_push_step(cfg, device="cpu")
    with pytest.raises(ValueError, match=reason):
        push.make_push_scan_runner(cfg, 2, device="cpu")


def test_push_step_takes_cuda_tensors_only():
    cfg = TConfig(nx=16, ny=16)
    f = t_eng.init_state(cfg, device="cpu").f
    with pytest.raises(ValueError, match="CUDA tensors"):
        push.push_step(cfg, f, torch.empty_like(f))
    with pytest.raises(ValueError, match="float64"):
        push.push_step(cfg, f.double(), torch.empty_like(f))
    assert push.unsupported_reason(TConfig(nx=16, ny=16, collision="trt",
                                           turbulence="smagorinsky")) is None
    for wall in ("nebb_west_eq", "bounce_back"):
        assert push.unsupported_reason(TConfig(nx=16, ny=16, boundary=wall)) is None
