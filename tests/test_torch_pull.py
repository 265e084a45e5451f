"""The CUDA kernel's module: on CPU tensors its wrapper runs the plain
version, held here to the JAX package's Pallas kernel run in interpret mode
(as that package's own tests run it on the CPU), at atol 2e-5 over 10 float32
steps.  The kernel itself is held to the plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.convert import state_from_numpy, state_to_numpy
from latticeboltzmannsimulations_torch.kernels import _build, pull, tblock
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels import pallas_pull

ATOL = 2e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kw", [
    dict(collision="srt"),
    dict(collision="trt"),
    dict(collision="mrt"),
    dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    dict(collision="srt", turbulence="smagorinsky", van_driest=True, reynolds=5000.0),
], ids=["srt", "trt", "mrt", "mrt_smagorinsky", "srt_van_driest"])
def test_make_step_matches_pallas_interpret(kw):
    base = dict(nx=64, ny=64, reynolds=400.0, precision="float32")
    base.update(kw)
    tc, jc = TConfig(**base), JConfig(**base)
    j_state = j_eng.init_state(jc)
    t_state = state_from_numpy(np.asarray(j_state.f), np.asarray(j_state.rho_lid),
                               device="cpu")
    t_step = pull.make_step(tc, device="cpu")
    j_step = jax.jit(pallas_pull.make_step(jc, interpret=True))
    for _ in range(10):
        t_state = t_step(t_state)
        j_state = j_step(j_state)
    f, lid = state_to_numpy(t_state)
    np.testing.assert_allclose(f, np.asarray(j_state.f), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lid, np.asarray(j_state.rho_lid), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(collision="srt"),
    dict(collision="trt"),
    dict(collision="mrt"),
    dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    dict(collision="srt", turbulence="smagorinsky", van_driest=True, reynolds=5000.0),
], ids=["srt", "trt", "mrt", "mrt_smagorinsky", "srt_van_driest"])
def test_tangential_lid_matches_the_jax_fused_runner(kw):
    """With the tangential lid the module's runner on the CPU holds to the
    JAX driver's engine for that wall, its XLA-fused scan runner, on a
    ragged field (both lid corners and the wrap at them)."""
    base = dict(nx=37, ny=29, reynolds=400.0, precision="float32",
                boundary="nebb_tangential")
    base.update(kw)
    tc, jc = TConfig(**base), JConfig(**base)
    j_state = j_eng.init_state(jc)
    t_state = state_from_numpy(np.asarray(j_state.f), np.asarray(j_state.rho_lid),
                               device="cpu")
    t_state = pull.make_scan_runner(tc, 10, device="cpu")(t_state)
    j_state = jax.jit(j_eng.make_scan_runner(jc, 10))(j_state)
    f, lid = state_to_numpy(t_state)
    np.testing.assert_allclose(f, np.asarray(j_state.f), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lid, np.asarray(j_state.rho_lid), rtol=0, atol=ATOL)


def test_tangential_lid_takes_the_one_step_kernel_only():
    """The one-step kernel takes the tangential lid; the sweep form (a
    traced omega, stacked cavities) and the temporal-block kernel, which
    compute the NEBB lid, refuse it."""
    cfg = TConfig(nx=16, ny=16, boundary="nebb_tangential")
    assert pull.unsupported_reason(cfg) is None
    assert "NEBB" in pull.unsupported_reason(cfg, traced_omega=True)
    assert "NEBB" in pull.unsupported_reason(cfg, traced_omega=True, n_cav=3)
    assert "NEBB" in pull.unsupported_reason(cfg, n_cav=3)
    assert "NEBB" in tblock.unsupported_reason(TConfig(nx=64, ny=64,
                                                       boundary="nebb_tangential"))
    with pytest.raises(ValueError, match="NEBB"):
        pull.make_sweep_runner(cfg, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="NEBB"):
        pull.make_step_omega(cfg, device="cpu")
    assert pull._lid_scalars(TConfig(nx=16, ny=16)) is None
    u = cfg.u_lid
    assert pull._lid_scalars(cfg) == (0.5 * u, (2.0 / 3.0) * u, (1.0 / 6.0) * u,
                                      u / 12.0)


def test_scan_runner_on_cpu_equals_stepping():
    cfg = TConfig(nx=24, ny=16, reynolds=400.0, collision="mrt")
    s0 = t_eng.init_state(cfg, device="cpu")
    out = pull.make_scan_runner(cfg, 3, device="cpu")(s0)
    s = s0
    step = pull.make_step(cfg, device="cpu")
    for _ in range(3):
        s = step(s)
    assert torch.equal(out.f, s.f) and torch.equal(out.rho_lid, s.rho_lid)
    assert pull.make_scan_runner(cfg, 0, device="cpu")(s0) is s0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cfg = TConfig(nx=16, ny=12, reynolds=400.0)
    s = t_eng.init_state(cfg, device="cpu")
    step = pull.make_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        step(t_eng.State(s.f.double(), s.rho_lid.double()))
    f_nc = s.f.transpose(1, 2).contiguous().transpose(1, 2)
    assert not f_nc.is_contiguous()
    with pytest.raises(ValueError, match="not contiguous"):
        step(t_eng.State(f_nc, s.rho_lid))
    with pytest.raises(ValueError, match="shape"):
        step(t_eng.State(s.f[:, :8], s.rho_lid))
    out = t_eng.State(torch.empty_like(s.f), torch.empty_like(s.rho_lid))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pull.pull_step(cfg, s.f, s.rho_lid, out.f, out.rho_lid)
    with pytest.raises(ValueError, match="float64"):
        pull.pull_step(cfg, s.f.double(), s.rho_lid, out.f, out.rho_lid)


@pytest.mark.parametrize("kw, reason", [
    (dict(precision="float64"), "float32"),
    (dict(boundary="nebb_west_eq"), "NEBB"),
    (dict(boundary="bounce_back"), "NEBB"),
    (dict(mesh_shape=(2, 1)), "one device"),
])
def test_unsupported_configurations_raise(kw, reason):
    cfg = TConfig(nx=16, ny=16, **kw)
    assert reason in pull.unsupported_reason(cfg)
    with pytest.raises(ValueError, match=reason):
        pull.make_step(cfg, device="cpu")
    with pytest.raises(ValueError, match=reason):
        pull.make_scan_runner(cfg, 4, device="cpu")


def test_supported_configuration_and_launch_arguments():
    cfg = TConfig(nx=16, ny=16, collision="trt", turbulence="smagorinsky")
    assert pull.unsupported_reason(cfg) is None
    assert pull.unsupported_reason(TConfig(nx=70000, ny=16)) is None
    scalars = pull._scalars(cfg)
    assert scalars[:2] == (16, 16)
    assert scalars[7] == cfg.trt_omega_minus        # from the base tau
    assert scalars[11:13] == (1, 1)                 # TRT, scalar Cs^2
    vd = TConfig(nx=16, ny=16, turbulence="smagorinsky", van_driest=True)
    assert pull._scalars(vd)[12] == 2               # staged Cs^2 plane
    plane = pull._cs2_plane(vd, torch.device("cpu"))
    assert plane.shape == (16, 16) and plane.dtype == torch.float32


def test_build_goes_to_an_ignored_directory_keyed_by_the_source():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r"lbm_kernels_[0-9a-f]{16}\.so", path.name)
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix()
    assert f"{rel}/" in (REPO / ".gitignore").read_text().splitlines()
    flags = " ".join(_build.COMPILE_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in _build.LINK_FLAGS
    names = {p.name for p in _build.SOURCES + _build.HEADERS}
    assert {"pull_step.cu", "tblock_step.cu", "push_step.cu", "lbm_cell.cuh"} <= names
    src = "".join(p.read_text() for p in _build.SOURCES)
    for fn in ("lbm_pull_step", "lbm_tblock_step", "lbm_push_step"):
        assert f'extern "C" int {fn}(' in src
