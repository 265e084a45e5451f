"""The port's native C++ engine against the JAX package's (the same source,
built with the same flags: within 1e-6) and against the port's plain fused
engine (atol 2e-5 over 20 float32 steps: independent implementations, a
different order of operations)."""

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch import native
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.native import engine as native_engine
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.native import is_available as j_is_available
from latticeboltzmannsimulations_tpu.native import native_run as j_native_run

STEPS = 20


@pytest.fixture(scope="module")
def built():
    """The library, built from the port's source at first use."""
    if not native.is_available():
        pytest.skip(f"the native engine does not build here: {native.build_error()}")
    return native_engine.library_path()


@pytest.mark.parametrize("kw", [
    dict(collision="srt"),
    dict(collision="trt"),
    dict(collision="mrt"),
    dict(collision="trt", turbulence="smagorinsky", reynolds=5000.0),
], ids=["srt", "trt", "mrt", "trt_smagorinsky"])
def test_native_run_matches_jax_native_and_the_plain_engine(built, kw):
    kw = {"nx": 48, "ny": 40, "reynolds": 400.0, "precision": "float32", **kw}
    cfg = SimConfig(**kw)
    st = engine.init_state(cfg, "cpu")
    f, lid = native.native_run(cfg, st.f, st.rho_lid, STEPS)
    assert f.dtype == torch.float32 and f.device.type == "cpu" and f.shape == st.f.shape

    assert j_is_available()
    f_j, lid_j = j_native_run(JConfig(**kw), st.f.numpy(), st.rho_lid.numpy(), STEPS)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lid.numpy(), lid_j, rtol=0, atol=1e-6)

    step = engine.make_fused_step(cfg)
    ref = st
    for _ in range(STEPS):
        ref = step(ref)
    torch.testing.assert_close(f, ref.f, rtol=0, atol=2e-5)
    torch.testing.assert_close(lid, ref.rho_lid, rtol=0, atol=2e-5)


def test_native_multistep_equals_stepwise(built):
    cfg = SimConfig(nx=32, ny=32, reynolds=100.0, precision="float32")
    st = engine.init_state(cfg, "cpu")
    f_a, l_a = native.native_run(cfg, st.f, st.rho_lid, 7)
    f_b, l_b = st.f, st.rho_lid
    for _ in range(7):
        f_b, l_b = native.native_run(cfg, f_b, l_b, 1)
    assert torch.equal(f_a, f_b) and torch.equal(l_a, l_b)
    f_0, l_0 = native.native_run(cfg, st.f, st.rho_lid, 0)
    assert torch.equal(f_0, st.f) and torch.equal(l_0, st.rho_lid)


def test_native_engine_wrapper(built):
    cfg = SimConfig(nx=48, ny=48, reynolds=100.0, precision="float32")
    eng = native.NativeEngine(cfg).run(100)
    rho, u = eng.observables()
    assert rho.shape == (48, 48) and u.shape == (2, 48, 48)
    assert bool(torch.isfinite(rho).all()) and abs(float(rho.mean()) - 1.0) < 1e-3
    ref_rho, ref_u = engine.observables(cfg, engine.State(eng.f, eng.rho_lid))
    assert torch.equal(rho, ref_rho) and torch.equal(u, ref_u)
    assert native.num_threads() >= 1


def test_native_run_refuses_tensors_off_the_cpu_or_of_another_dtype(built):
    cfg = SimConfig(nx=16, ny=16, reynolds=100.0, precision="float32")
    st = engine.init_state(cfg, "cpu")
    with pytest.raises(ValueError, match="runs on the CPU"):
        native.native_run(cfg, st.f.to("meta"), st.rho_lid, 1)
    with pytest.raises(ValueError, match="not float32"):
        native.native_run(cfg, st.f.double(), st.rho_lid, 1)


def test_native_library_is_built_into_the_ignored_build_directory(built):
    pkg = native_engine.BUILD_DIR.parent
    assert built.exists() and built.parent == pkg / "_build"
    assert not list((pkg / "native").glob("*.so"))
    assert "latticeboltzmannsimulations_torch/_build/" in (
        pkg.parent / ".gitignore").read_text().splitlines()
