"""The CUDA kernel against its plain PyTorch version, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with the
card, which has no JAX; there, skip this directory's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance atol 2e-5 over 20 float32 steps: an independent float32
implementation, whose order of operations and FMA contraction differ."""

import pytest
import torch

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import pull

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(collision="srt"),
    dict(collision="trt"),
    dict(collision="mrt"),
    dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    dict(collision="trt", turbulence="smagorinsky", reynolds=5000.0),
    dict(collision="srt", turbulence="smagorinsky", van_driest=True, reynolds=5000.0),
], ids=["srt", "trt", "mrt", "mrt_smagorinsky", "trt_smagorinsky", "srt_van_driest"])
def test_kernel_matches_plain(cuda, kw):
    cfg = SimConfig(**{"nx": 128, "ny": 96, "reynolds": 400.0, **kw})
    plain = engine.make_fused_step(cfg)
    kernel = pull.make_step(cfg, device=cuda)
    before = pull.launches
    s_p = s_k = engine.init_state(cfg, device=cuda)
    for _ in range(20):
        s_p, s_k = plain(s_p), kernel(s_k)
    torch.cuda.synchronize()
    assert pull.launches - before == 20
    torch.testing.assert_close(s_k.f, s_p.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(s_k.rho_lid, s_p.rho_lid, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 6, 7])
def test_scan_runner_equals_stepping(cuda, n_steps):
    """Both parities of the two-buffer ping-pong; the input is not written."""
    cfg = SimConfig(nx=64, ny=64, reynolds=400.0, collision="mrt")
    s0 = engine.init_state(cfg, device=cuda)
    f0 = s0.f.clone()
    out = pull.make_scan_runner(cfg, n_steps, device=cuda)(s0)
    step = pull.make_step(cfg, device=cuda)
    s = s0
    for _ in range(n_steps):
        s = step(s)
    torch.cuda.synchronize()
    assert torch.equal(out.f, s.f) and torch.equal(out.rho_lid, s.rho_lid)
    assert torch.equal(s0.f, f0)


@pytest.mark.cuda
def test_wrapper_refuses_in_place_and_other_devices(cuda):
    cfg = SimConfig(nx=32, ny=32, reynolds=400.0)
    s = engine.init_state(cfg, device=cuda)
    with pytest.raises(ValueError, match="in place"):
        pull.pull_step(cfg, s.f, s.rho_lid, s.f, s.rho_lid)
    with pytest.raises(ValueError, match="lies on"):
        pull.make_step(cfg, device=cuda)(engine.init_state(cfg, device="cpu"))


@pytest.mark.cuda
def test_run_to_convergence_steps_through_the_kernel(cuda):
    """The package-level driver on the card launches the kernel once per
    step, and its mean-u history matches the plain engine's run of the same
    chunks (atol 1e-7 on mean u, lid speed 0.08: the two float32 runs differ
    per cell by at most a few 1e-5 in f over these steps, and the mean
    averages that down)."""
    cfg = SimConfig(nx=128, ny=128, reynolds=400.0, collision="mrt",
                    max_steps=600, report_interval=200)
    before = pull.launches
    res = lbt.run_to_convergence(cfg, device=cuda)
    assert pull.launches - before == res.steps == 600
    ref = engine.run_to_convergence(cfg, device=cuda)   # plain runner
    assert pull.launches - before == 600
    assert (res.steps, res.converged) == (ref.steps, ref.converged)
    assert res.mean_u_history == pytest.approx(ref.mean_u_history, rel=0, abs=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("nx, ny", [(65_600, 8), (4, 65_535 * 128 + 200)],
                         ids=["nx_past_65535", "ny_past_the_y_grid"])
def test_kernel_reaches_every_cell_of_long_fields(cuda, nx, ny):
    """More x columns than a grid's y dimension holds, and more y-blocks
    than it holds (the stride loop): every cell is updated, as the plain
    version updates it (5 steps, atol 2e-5 as above)."""
    cfg = SimConfig(nx=nx, ny=ny, reynolds=400.0, collision="mrt")
    assert pull.unsupported_reason(cfg) is None
    plain = engine.make_fused_step(cfg)
    kernel = pull.make_step(cfg, device=cuda)
    s_p = s_k = engine.init_state(cfg, device=cuda)
    for _ in range(5):
        s_p, s_k = plain(s_p), kernel(s_k)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k.f, s_p.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(s_k.rho_lid, s_p.rho_lid, rtol=0, atol=ATOL)
