"""The CUDA kernels against their plain PyTorch versions, on the card.

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
from latticeboltzmannsimulations_torch.kernels import pull, push, tblock
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate

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


CASES = {
    "srt": dict(collision="srt"),
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
    "mrt_smagorinsky": dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_tblock_matches_plain(cuda, case):
    """20 steps at K=8 (two launches and four one-step remainder launches) on
    a field that is no multiple of the 48-cell tile, against 20 plain steps."""
    cfg = SimConfig(**{"nx": 130, "ny": 100, "reynolds": 400.0, **CASES[case]})
    plain = engine.make_fused_step(cfg)
    s_p = s0 = engine.init_state(cfg, device=cuda)
    for _ in range(20):
        s_p = plain(s_p)
    before = (tblock.launches, pull.launches)
    s_k = tblock.make_scan_runner(cfg, 20, device=cuda, k_steps=8)(s0)
    torch.cuda.synchronize()
    assert (tblock.launches - before[0], pull.launches - before[1]) == (2, 4)
    torch.testing.assert_close(s_k.f, s_p.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(s_k.rho_lid, s_p.rho_lid, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k_steps, n_steps", [(4, 19), (8, 16), (16, 33)])
def test_tblock_equals_pull_step(cuda, k_steps, n_steps):
    """The same arithmetic in both kernels: K-step blocks plus the
    remainder through the one-step kernel agree with n one-step launches to
    1e-6 (the serial emulation of both agrees exactly)."""
    cfg = SimConfig(nx=200, ny=150, reynolds=1000.0, collision="mrt")
    s0 = engine.init_state(cfg, device=cuda)
    before = tblock.launches
    a = tblock.make_scan_runner(cfg, n_steps, device=cuda, k_steps=k_steps)(s0)
    b = pull.make_scan_runner(cfg, n_steps, device=cuda)(s0)
    torch.cuda.synchronize()
    assert tblock.launches - before == n_steps // k_steps
    torch.testing.assert_close(a.f, b.f, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.rho_lid, b.rho_lid, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_tblock_refusals(cuda):
    cfg = SimConfig(nx=64, ny=64, reynolds=400.0)
    s = engine.init_state(cfg, device=cuda)
    with pytest.raises(ValueError, match="in place"):
        tblock.tblock_step(cfg, s.f, s.rho_lid, s.f, s.rho_lid)
    with pytest.raises(ValueError, match="float32"):
        tblock.make_block_step(SimConfig(nx=64, ny=64, precision="float64"), device=cuda)
    with pytest.raises(ValueError, match="Van Driest"):
        tblock.make_block_step(SimConfig(nx=64, ny=64, turbulence="smagorinsky",
                                         van_driest=True), device=cuda)
    with pytest.raises(ValueError, match="window"):
        tblock.make_scan_runner(SimConfig(nx=63, ny=128), 8, device=cuda)
    with pytest.raises(ValueError, match="window"):
        tblock.make_scan_runner(SimConfig(nx=128, ny=40), 8, device=cuda)


@pytest.mark.cuda
def test_simulate_and_run_to_convergence_through_tblock(cuda, tmp_path):
    """The driver's explicit cuda-tblock route launches K-step blocks: 609
    steps in chunks of 203 are, per chunk, 203 // K blocks and 203 % K
    one-step launches; run_to_convergence through it matches the plain
    engine's mean-u history (atol 1e-7, as for the one-step kernel above)."""
    cfg = SimConfig(nx=128, ny=128, reynolds=400.0, collision="mrt",
                    max_steps=609, report_interval=203)
    blocks, rem = divmod(203, tblock.K_STEPS)
    before = (tblock.launches, pull.launches)
    summary = simulate(cfg, SimOptions(out_dir=str(tmp_path), verbose=False,
                                       backend="cuda-tblock"), device=cuda)
    assert summary.backend == "cuda-tblock" and summary.steps == 609
    assert (tblock.launches - before[0], pull.launches - before[1]) == (3 * blocks, 3 * rem)
    res = lbt.run_to_convergence(cfg, device=cuda, backend="cuda-tblock")
    ref = engine.run_to_convergence(cfg, device=cuda)
    assert tblock.launches - before[0] == 6 * blocks
    assert res.mean_u_history == pytest.approx(ref.mean_u_history, rel=0, abs=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_push_kernel_matches_oracle(cuda, case):
    """20 push steps on a field that is no multiple of the 16 x 32 tile."""
    cfg = SimConfig(**{"nx": 70, "ny": 90, "reynolds": 400.0, **CASES[case]})
    plain = engine.make_push_oracle_step(cfg)
    kernel = push.make_push_step(cfg, device=cuda)
    before = push.launches
    f_p = f_k = engine.init_state(cfg, device=cuda).f
    for _ in range(20):
        f_p, f_k = plain(f_p), kernel(f_k)
    torch.cuda.synchronize()
    assert push.launches - before == 20
    torch.testing.assert_close(f_k, f_p, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 6, 7])
def test_push_scan_runner_equals_stepping(cuda, n_steps):
    cfg = SimConfig(nx=64, ny=64, reynolds=400.0, collision="mrt")
    f0 = engine.init_state(cfg, device=cuda).f
    kept = f0.clone()
    out = push.make_push_scan_runner(cfg, n_steps, device=cuda)(f0)
    step = push.make_push_step(cfg, device=cuda)
    f = f0
    for _ in range(n_steps):
        f = step(f)
    torch.cuda.synchronize()
    assert torch.equal(out, f) and torch.equal(f0, kept)


@pytest.mark.cuda
def test_push_refusals(cuda):
    cfg = SimConfig(nx=32, ny=32, reynolds=400.0)
    f = engine.init_state(cfg, device=cuda).f
    with pytest.raises(ValueError, match="in place"):
        push.push_step(cfg, f, f)
    with pytest.raises(ValueError, match="NEBB"):
        push.make_push_step(SimConfig(nx=32, ny=32, boundary="bounce_back"), device=cuda)
    with pytest.raises(ValueError, match="Van Driest"):
        push.make_push_step(SimConfig(nx=32, ny=32, turbulence="smagorinsky",
                                      van_driest=True), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", ["bounce_back", "nebb_west_eq"])
def test_push_oracle_route_on_the_card(cuda, tmp_path, boundary):
    cfg = SimConfig(nx=48, ny=48, reynolds=100.0, boundary=boundary,
                    max_steps=200, report_interval=100)
    s = simulate(cfg, SimOptions(out_dir=str(tmp_path), verbose=False), device=cuda)
    assert s.backend == "push-oracle" and s.steps == 200
    assert s.r2_ux is not None and torch.isfinite(torch.tensor(s.r2_ux))
