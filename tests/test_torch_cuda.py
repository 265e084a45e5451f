"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with the
card, which has no JAX; there, skip this directory's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance atol 2e-5 over 20 float32 steps: an independent float32
implementation, whose order of operations and FMA contraction differ.  The
halo exchange kernel and the runners it drives are held to their copies
exactly (``torch.equal``): it only moves values."""

import dataclasses
import json

import pytest
import torch

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import (
    halo_rdma,
    pull,
    pull_sharded,
    push,
    tblock,
    tblock_sharded,
)
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    make_sharded_scan_runner,
    multihost,
    shard_state,
    unshard_state,
)
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
@pytest.mark.parametrize("kw", [
    dict(collision="srt"),
    dict(collision="trt"),
    dict(collision="mrt"),
    dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    dict(collision="srt", turbulence="smagorinsky", van_driest=True, reynolds=5000.0),
], ids=["srt", "trt", "mrt", "mrt_smagorinsky", "srt_van_driest"])
def test_tangential_kernel_matches_plain(cuda, kw):
    """The tangential entry against the plain tangential engine on a ragged
    field, its launches counted apart from the NEBB kernel's."""
    cfg = SimConfig(**{"nx": 137, "ny": 93, "reynolds": 400.0,
                       "boundary": "nebb_tangential", **kw})
    plain = engine.make_fused_step(cfg)
    kernel = pull.make_scan_runner(cfg, 20, device=cuda)
    before, nebb = pull.tangential_launches, pull.launches
    s0 = engine.init_state(cfg, device=cuda)
    s_k, s_p = kernel(s0), s0
    for _ in range(20):
        s_p = plain(s_p)
    torch.cuda.synchronize()
    assert (pull.tangential_launches - before, pull.launches - nebb) == (20, 0)
    torch.testing.assert_close(s_k.f, s_p.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(s_k.rho_lid, s_p.rho_lid, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_auto_routes_the_tangential_lid_through_the_kernel(cuda, tmp_path):
    """``simulate`` with ``auto`` takes the tangential entry at a size where
    NEBB would take the temporal-block kernel."""
    cfg = SimConfig(nx=2048, ny=2048, reynolds=1000.0, collision="mrt",
                    boundary="nebb_tangential", max_steps=200, report_interval=100)
    before = (pull.tangential_launches, tblock.launches)
    summary = simulate(cfg, SimOptions(out_dir=str(tmp_path), verbose=False),
                       device=cuda)
    assert summary.backend == "cuda-pull" and summary.steps == 200
    assert (pull.tangential_launches - before[0], tblock.launches - before[1]) == (200, 0)


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
def test_scan_runner_with_van_driest_matches_plain(cuda):
    """The runner keeps its Van Driest Cs^2 plane alive: built and then
    called (its buffers allocated after the plane's last other reference is
    gone), 20 steps against the plain step (atol 2e-5 as above)."""
    cfg = SimConfig(nx=128, ny=128, reynolds=5000.0, collision="srt",
                    turbulence="smagorinsky", van_driest=True)
    s0 = engine.init_state(cfg, device=cuda)
    out = pull.make_scan_runner(cfg, 20, device=cuda)(s0)
    plain = engine.make_fused_step(cfg)
    s = s0
    for _ in range(20):
        s = plain(s)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.f, s.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(out.rho_lid, s.rho_lid, rtol=0, atol=ATOL)


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


SWEEP_CASES = {
    "srt_smagorinsky": dict(collision="srt", turbulence="smagorinsky"),
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
}
SWEEP_RE = (100.0, 150.0, 900.0, 2500.0, 5000.0)


def _sweep_start(cfg, n_cav, device, seed=0):
    """n_cav cavities stacked along x, each from rest with its own noise,
    and their float32 omegas."""
    s = engine.init_state(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = 1.0 + 1e-3 * torch.randn((n_cav, *s.f.shape), generator=gen, device=device)
    state = engine.stack_cavities(engine.State(
        s.f * noise, s.rho_lid.expand(n_cav, *s.rho_lid.shape)))
    omegas = [dataclasses.replace(cfg, reynolds=r).omega for r in SWEEP_RE[:n_cav]]
    return state, omegas


def _cavity(state, nx, c):
    return engine.State(state.f[:, c * nx:(c + 1) * nx].contiguous(),
                        state.rho_lid[c * nx:(c + 1) * nx].clone())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cav", [1, 4])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_kernel_matches_plain(cuda, case, n_cav):
    """The sweep form against the plain stacked step, each cavity with its
    own omega, 20 steps (atol 2e-5 as above), one launch per step."""
    cfg = SimConfig(nx=100, ny=70, **SWEEP_CASES[case])
    s0, omegas = _sweep_start(cfg, n_cav, cuda)
    plain = engine.make_stacked_step_omega(cfg, n_cav)
    om = torch.tensor(omegas, dtype=torch.float32, device=cuda)
    s_p = s0
    for _ in range(20):
        s_p = plain(s_p, om)
    before = pull.sweep_launches
    s_k = pull.make_sweep_runner(cfg, n_cav, 20, device=cuda)(s0, omegas)
    torch.cuda.synchronize()
    assert pull.sweep_launches - before == 20
    torch.testing.assert_close(s_k.f, s_p.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(s_k.rho_lid, s_p.rho_lid, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_stack_equals_single_cavities(cuda, case):
    """Five stacked cavities against each alone through the one-cavity form
    (``make_scan_runner_omega``: the same entry and table), 60 steps in two
    calls of the cached table: bit for bit."""
    cfg = SimConfig(nx=64, ny=48, **SWEEP_CASES[case])
    s0, omegas = _sweep_start(cfg, 5, cuda)
    sweep = pull.make_sweep_runner(cfg, 5, 30, device=cuda)
    out = sweep(sweep(s0, omegas), omegas)
    single = pull.make_scan_runner_omega(cfg, 60, device=cuda)
    for c, om in enumerate(omegas):
        alone = single(_cavity(s0, cfg.nx, c), om)
        got = _cavity(out, cfg.nx, c)
        assert torch.equal(got.f, alone.f) and torch.equal(got.rho_lid, alone.rho_lid)


@pytest.mark.cuda
def test_sweep_nan_cavity_leaks_into_no_other(cuda):
    cfg = SimConfig(nx=64, ny=48, collision="mrt")
    s0, omegas = _sweep_start(cfg, 3, cuda)
    s0.f[:, cfg.nx:2 * cfg.nx] = float("nan")
    out = pull.make_sweep_runner(cfg, 3, 40, device=cuda)(s0, omegas)
    single = pull.make_scan_runner_omega(cfg, 40, device=cuda)
    assert torch.isnan(_cavity(out, cfg.nx, 1).f).all()
    for c in (0, 2):
        alone = single(_cavity(s0, cfg.nx, c), omegas[c])
        assert torch.isfinite(alone.f).all()
        assert torch.equal(_cavity(out, cfg.nx, c).f, alone.f)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_size", [1, 2])
def test_generate_dataset_takes_the_sweep_kernel(cuda, batch_size):
    """On the card the sweep launches once per step for a batch (padded
    short batch included) or per cavity, and the dataset agrees with the
    CPU's plain batched route after 20 steps (atol 2e-5 as above)."""
    from latticeboltzmannsimulations_torch.ml import datagen

    cfg = SimConfig(nx=64, ny=64, collision="srt", turbulence="smagorinsky",
                    max_steps=20, report_interval=20)
    res = [100.0, 400.0, 1600.0]
    before = pull.sweep_launches
    ds = datagen.generate_dataset(cfg, re_values=res, batch_size=batch_size, device=cuda)
    batches = len(res) if batch_size == 1 else 2
    assert pull.sweep_launches - before == 20 * batches
    want = datagen.generate_dataset(cfg, re_values=res, batch_size=batch_size, device="cpu")
    assert not ds.failed.any()
    for name in ("f_final", "u_final"):
        torch.testing.assert_close(torch.from_numpy(getattr(ds, name)),
                                   torch.from_numpy(getattr(want, name)), rtol=0, atol=ATOL)


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
@pytest.mark.parametrize("nx, ny, k", [
    (63, 40, 5),      # a field smaller than the window: several lid images
    (300, 109, 5),    # one past a multiple of the 54 own cells
    (150, 200, 15),
])
def test_tblock_equals_pull_step_on_small_and_ragged_fields(cuda, nx, ny, k):
    """On fields the window did not serve before (smaller than it) and on
    ragged ones, the kernel agrees with the one-step kernel bit for bit."""
    cfg = SimConfig(nx=nx, ny=ny, reynolds=1000.0, collision="mrt")
    s0 = engine.init_state(cfg, device=cuda)
    a = tblock.make_scan_runner(cfg, 2 * k, device=cuda, k_steps=k)(s0)
    b = pull.make_scan_runner(cfg, 2 * k, device=cuda)(s0)
    torch.cuda.synchronize()
    assert torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)


@pytest.mark.cuda
@pytest.mark.parametrize("lid", ["nebb", "nebb_tangential"])
@pytest.mark.parametrize("kw", [
    dict(collision="srt"),
    dict(collision="trt"),
    dict(collision="mrt"),
    dict(collision="mrt", turbulence="smagorinsky", reynolds=5000.0),
    dict(collision="srt", turbulence="smagorinsky", van_driest=True, reynolds=5000.0),
], ids=["srt", "trt", "mrt", "mrt_smagorinsky", "srt_van_driest"])
def test_kernel_equals_plain_bit_for_bit(cuda, kw, lid):
    """On the card the kernel rounds as the plain engine does, LES too: the
    same float operations in the same order, no FMA contraction, x / b as
    x * (1 / b), correctly rounded division and square root on both."""
    cfg = SimConfig(**{"nx": 137, "ny": 93, "reynolds": 400.0, "boundary": lid, **kw})
    plain = engine.make_fused_step(cfg)
    s0 = engine.init_state(cfg, device=cuda)
    s_k, s_p = pull.make_scan_runner(cfg, 20, device=cuda)(s0), s0
    for _ in range(20):
        s_p = plain(s_p)
    torch.cuda.synchronize()
    assert torch.isfinite(s_p.f).all()
    assert torch.equal(s_k.f, s_p.f) and torch.equal(s_k.rho_lid, s_p.rho_lid)


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
    with pytest.raises(ValueError, match="64x64 window"):
        tblock.make_scan_runner(SimConfig(nx=63, ny=128), 8, device=cuda, k_steps=32)
    with pytest.raises(ValueError, match="64x64 window"):
        tblock.make_scan_runner(SimConfig(nx=128, ny=40), 8, device=cuda, k_steps=0)


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


# The push kernel's walls and each one's launch counter.
PUSH_COUNTERS = {"nebb": "launches", "nebb_west_eq": "west_eq_launches",
                 "bounce_back": "bounce_back_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("wall", list(PUSH_COUNTERS))
@pytest.mark.parametrize("case", list(CASES))
def test_push_kernel_matches_oracle(cuda, case, wall):
    """20 push steps on a field that is no multiple of the 16 x 32 tile,
    each launch counted on its wall's entry."""
    cfg = SimConfig(**{"nx": 70, "ny": 90, "reynolds": 400.0, "boundary": wall,
                       **CASES[case]})
    plain = engine.make_push_oracle_step(cfg)
    kernel = push.make_push_step(cfg, device=cuda)
    before = {name: getattr(push, name) for name in PUSH_COUNTERS.values()}
    f_p = f_k = engine.init_state(cfg, device=cuda).f
    for _ in range(20):
        f_p, f_k = plain(f_p), kernel(f_k)
    torch.cuda.synchronize()
    assert {name: getattr(push, name) - n for name, n in before.items()} == {
        name: 20 if name == PUSH_COUNTERS[wall] else 0 for name in before}
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
    # bounce_back, once refused, runs: one step equals the push oracle's
    bb = SimConfig(nx=32, ny=32, boundary="bounce_back")
    f_bb = engine.init_state(bb, device=cuda).f
    out = push.make_push_step(bb, device=cuda)(f_bb)
    torch.testing.assert_close(out, engine.make_push_oracle_step(bb)(f_bb), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="NEBB"):
        push.make_push_step(SimConfig(nx=32, ny=32, boundary="nebb_tangential"),
                            device=cuda)
    with pytest.raises(ValueError, match="Van Driest"):
        push.make_push_step(SimConfig(nx=32, ny=32, turbulence="smagorinsky",
                                      van_driest=True), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", ["bounce_back", "nebb_west_eq"])
def test_push_oracle_route_on_the_card(cuda, tmp_path, boundary):
    """The push oracle on the card when asked for, and for these walls
    where the push kernel does not serve them (Van Driest); ``auto`` takes
    the push kernel otherwise."""
    cfg = SimConfig(nx=48, ny=48, reynolds=100.0, boundary=boundary,
                    max_steps=200, report_interval=100)
    s = simulate(cfg, SimOptions(out_dir=str(tmp_path / "oracle"), verbose=False,
                                 backend="push-oracle"), device=cuda)
    assert s.backend == "push-oracle" and s.steps == 200
    assert s.r2_ux is not None and torch.isfinite(torch.tensor(s.r2_ux))
    vd = dataclasses.replace(cfg, turbulence="smagorinsky", van_driest=True,
                             max_steps=100)
    s = simulate(vd, SimOptions(out_dir=str(tmp_path / "vd"), verbose=False), device=cuda)
    assert s.backend == "push-oracle" and s.steps == 100


def _metrics(path):
    """A run's metrics records without their wall times, MLUPS and route."""
    drop = ("t", "mlups", "backend")
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in path.read_text().splitlines()]


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", list(PUSH_COUNTERS))
def test_cuda_push_simulate_equals_push_oracle(cuda, tmp_path, boundary):
    """``simulate`` through ``cuda-push`` (``auto``'s route for the walls
    only the push engines implement, asked for with NEBB) over four report
    intervals, with the mass correction, equals ``backend="push-oracle"``
    bit for bit: the kernel does the oracle's operations in its order.
    Mean u and the Ghia scores of every interval, and the final scores."""
    cfg = SimConfig(nx=64, ny=64, reynolds=100.0, collision="mrt", boundary=boundary,
                    max_steps=400, report_interval=100)
    backend = "cuda-push" if boundary == "nebb" else "auto"
    counter = PUSH_COUNTERS[boundary]
    before = getattr(push, counter)
    k = simulate(cfg, SimOptions(out_dir=str(tmp_path / "kernel"), verbose=False,
                                 backend=backend), device=cuda)
    torch.cuda.synchronize()
    assert k.backend == "cuda-push" and getattr(push, counter) - before == 400
    o = simulate(cfg, SimOptions(out_dir=str(tmp_path / "oracle"), verbose=False,
                                 backend="push-oracle"), device=cuda)
    assert o.backend == "push-oracle" and k.steps == o.steps == 400
    assert (k.r2_ux, k.r2_uy, k.l2_combined) == (o.r2_ux, o.r2_uy, o.l2_combined)
    assert (_metrics(tmp_path / "kernel" / "ldc_metrics.jsonl")
            == _metrics(tmp_path / "oracle" / "ldc_metrics.jsonl"))


# The sharded kernels, on meshes of one card: each shard runs its kernel with
# its real wall flags and its real halo strips.
SHARDED_CASES = {
    **CASES,
    "srt_van_driest": dict(collision="srt", turbulence="smagorinsky",
                           van_driest=True, reynolds=5000.0),
}


def _mesh(cuda, shape):
    return make_mesh(shape, [cuda] * (shape[0] * shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_pull_sharded_matches_plain(cuda, case):
    """20 steps on a 2x2 mesh of ragged 65x49 shards against 20 steps of the
    plain sharded engine; one launch per shard per step."""
    cfg = SimConfig(**{"nx": 130, "ny": 98, "reynolds": 400.0, "mesh_shape": (2, 2),
                       **SHARDED_CASES[case]})
    mesh = _mesh(cuda, cfg.mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device=cuda), mesh)
    before = pull_sharded.launches
    out = pull_sharded.make_sharded_runner(cfg, 20, mesh)(s0)
    torch.cuda.synchronize()
    assert pull_sharded.launches - before == 4 * 20
    ref = make_sharded_scan_runner(cfg, 20, mesh)(s0)
    a, b = unshard_state(out, cuda), unshard_state(ref, cuda)
    torch.testing.assert_close(a.f, b.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(a.rho_lid, b.rho_lid, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (3, 1), (1, 1)])
def test_pull_sharded_equals_pull_step(cuda, mesh_shape):
    """The same arithmetic as the one-device kernel, the wrap supplied by
    the halo: equal bit for bit over 33 steps."""
    cfg = SimConfig(nx=150, ny=100, reynolds=1000.0, collision="mrt",
                    mesh_shape=mesh_shape)
    mesh = _mesh(cuda, mesh_shape)
    s0 = engine.init_state(cfg, device=cuda)
    a = unshard_state(pull_sharded.make_sharded_runner(cfg, 33, mesh)(
        shard_state(s0, mesh)), cuda)
    b = pull.make_scan_runner(dataclasses.replace(cfg, mesh_shape=(1, 1)), 33,
                              device=cuda)(s0)
    torch.cuda.synchronize()
    assert torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_tblock_sharded_matches_plain(cuda, case):
    """20 steps at K=5 (four launches per shard) on a 2x2 mesh of ragged
    shards against 20 steps of the plain sharded engine."""
    cfg = SimConfig(**{"nx": 130, "ny": 98, "reynolds": 400.0, "mesh_shape": (2, 2),
                       **CASES[case]})
    mesh = _mesh(cuda, cfg.mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device=cuda), mesh)
    before = (tblock_sharded.launches, pull_sharded.launches)
    out = tblock_sharded.make_sharded_runner(cfg, 20, mesh)(s0)
    torch.cuda.synchronize()
    assert (tblock_sharded.launches - before[0], pull_sharded.launches - before[1]) == (16, 0)
    ref = make_sharded_scan_runner(cfg, 20, mesh)(s0)
    a, b = unshard_state(out, cuda), unshard_state(ref, cuda)
    torch.testing.assert_close(a.f, b.f, rtol=0, atol=ATOL)
    torch.testing.assert_close(a.rho_lid, b.rho_lid, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nx, ny, mesh_shape, k, n", [
    (200, 150, (2, 2), 5, 23),   # with a remainder through the one-step kernel
    (256, 64, (2, 8), 8, 16),    # ly == K
    (48, 40, (1, 1), 5, 20),     # both lid images in one window
])
def test_tblock_sharded_equals_pull_sharded(cuda, nx, ny, mesh_shape, k, n):
    cfg = SimConfig(nx=nx, ny=ny, reynolds=1000.0, collision="mrt",
                    mesh_shape=mesh_shape)
    mesh = _mesh(cuda, mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device=cuda), mesh)
    a = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh, k_steps=k)(s0), cuda)
    b = unshard_state(pull_sharded.make_sharded_runner(cfg, n, mesh)(s0), cuda)
    torch.cuda.synchronize()
    assert torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)


@pytest.mark.cuda
def test_sharded_refusals(cuda):
    cfg = SimConfig(nx=32, ny=32, mesh_shape=(2, 1))
    lay = pull_sharded.layout(16, 32)
    fp = torch.zeros(9, 18, lay.pitch, device=cuda)
    rho = torch.ones(16, device=cuda)
    flags = (True, False, True, True)
    with pytest.raises(ValueError, match="in place"):
        pull_sharded.shard_step(cfg, lay, fp, rho, flags, None, fp, rho.clone())
    with pytest.raises(ValueError, match="lies on"):
        pull_sharded.shard_step(cfg, lay, fp, rho.cpu(), flags, None, fp.clone(),
                                rho.clone())
    with pytest.raises(ValueError, match="float32"):
        pull_sharded.make_sharded_runner(SimConfig(nx=32, ny=32, precision="float64",
                                                   mesh_shape=(2, 1)), 4, _mesh(cuda, (2, 1)))
    with pytest.raises(ValueError, match="lies on|expected"):
        pull_sharded.make_sharded_runner(cfg, 4, _mesh(cuda, (2, 1)))(
            shard_state(engine.init_state(cfg, device="cpu"), make_mesh((2, 1), ["cpu"] * 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("backend, kernel", [("auto", "pull_sharded"),
                                             ("cuda-sharded-tblock", "tblock_sharded")])
def test_simulate_on_a_mesh_of_one_card(cuda, tmp_path, backend, kernel):
    """The driver on a 2x2 mesh of one card launches the routed kernel once
    per shard per step (per K steps for the temporal-block kernel, with the
    remainder through the one-step kernel), and follows the single-device
    kernel's run (atol 1e-7 on the metrics' mean u)."""
    cfg = SimConfig(nx=128, ny=128, reynolds=400.0, collision="mrt",
                    max_steps=606, report_interval=202, mesh_shape=(2, 2))
    blocks, rem = divmod(202, tblock_sharded.K_STEPS)
    before = (pull_sharded.launches, tblock_sharded.launches)
    summary = simulate(cfg, SimOptions(out_dir=str(tmp_path / "mesh"), verbose=False,
                                       backend=backend), device=[cuda] * 4)
    counts = (pull_sharded.launches - before[0], tblock_sharded.launches - before[1])
    if kernel == "pull_sharded":
        assert summary.backend == "cuda-sharded" and counts == (4 * 606, 0)
    else:
        assert summary.backend == "cuda-sharded-tblock"
        assert counts == (4 * 3 * rem, 4 * 3 * blocks)
    one = simulate(dataclasses.replace(cfg, mesh_shape=(1, 1)),
                   SimOptions(out_dir=str(tmp_path / "one"), verbose=False), device=cuda)
    assert summary.steps == one.steps == 606
    assert summary.r2_ux == pytest.approx(one.r2_ux, abs=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape, nx, ny, k", [
    ((2, 2), 130, 98, 5),
    ((4, 1), 200, 150, 5),
    ((1, 1), 48, 40, 5),     # the ring copies onto itself
    ((3, 2), 66, 46, 4),
])
def test_x_exchange_equals_plain_copies(cuda, mesh_shape, nx, ny, k):
    """The exchange kernel on random carries of the tight layout: one
    launch for the mesh of this card, equal to the plain x-phase copies
    bit for bit, the rest of every carry untouched."""
    mx, my = mesh_shape
    lx, ly = nx // mx, ny // my
    lay = halo.Layout.tight(lx, ly, k)
    gen = torch.Generator(device=cuda).manual_seed(3)

    def blocks(*size):
        return tuple(tuple(torch.rand(size, generator=gen, device=cuda) for _ in range(my))
                     for _ in range(mx))

    carries, panels = blocks(9, lx + 2 * k, ly + 2 * k), blocks(lx + 2 * k)
    plain = [tuple(tuple(b.clone() for b in col) for col in bl) for bl in (carries, panels)]
    mesh = _mesh(cuda, mesh_shape)
    before = halo_rdma.launches
    halo_rdma.make_x_halo_exchange(mesh, carries, panels, lay)()
    assert halo_rdma.launches - before == 1
    halo.Transfer(mesh, halo.halo_moves(plain[0], lay)[1]
                  + halo.row_halo_moves(plain[1], k))()
    torch.cuda.synchronize()
    for got, want in zip((carries, panels), plain):
        for ix, iy in mesh.shards():
            assert torch.equal(got[ix][iy], want[ix][iy])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize("n", [20, 23])
def test_rdma_runner_equals_ppermute(cuda, mesh_shape, n):
    """``halo_impl="rdma"`` against ``"ppermute"``: the same values move,
    so the runners agree bit for bit, through the remainder too; one
    exchange launch per block (and one per remainder step, through the
    one-step runner) and no halo copy in the loop."""
    cfg = SimConfig(nx=200 - 200 % mesh_shape[0], ny=160, reynolds=1000.0,
                    collision="mrt", mesh_shape=mesh_shape)
    mesh = _mesh(cuda, mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device=cuda), mesh)
    blocks, rem = divmod(n, tblock_sharded.K_STEPS)
    before = (halo_rdma.launches, halo.copies)
    a = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh, halo_impl="rdma")(s0),
                      cuda)
    assert halo_rdma.launches - before[0] == blocks + rem
    # per call: pad and unpad the blocks and panels, and one copy of the
    # panels over their columns after the last block
    # (the remainder's runner, which keeps its lid rows, pads and unpads the
    # blocks and the lid density and copies it over the columns)
    shards, mx = mesh_shape[0] * mesh_shape[1], mesh_shape[0]
    assert halo.copies - before[1] == 5 * shards - mx + (5 * shards - mx if rem else 0)
    b = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh)(s0), cuda)
    torch.cuda.synchronize()
    assert torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)


@pytest.mark.cuda
def test_x_exchange_refuses_what_it_cannot_copy(cuda):
    mesh = _mesh(cuda, (2, 1))
    lay = halo.Layout.tight(16, 32, 5)
    carries = tuple((torch.zeros(9, 26, 42, device=cuda, dtype=torch.float64),)
                    for _ in range(2))
    panels = tuple((torch.zeros(26, device=cuda),) for _ in range(2))
    with pytest.raises(ValueError, match="float32"):
        halo_rdma.make_x_halo_exchange(mesh, carries, panels, lay)
    with pytest.raises(ValueError, match="a rectangle of"):
        halo_rdma.rect_rows([(torch.zeros(3, device=cuda), torch.zeros(4, device=cuda))])


def _random_blocks(gen, device, mesh_shape, *size):
    mx, my = mesh_shape
    return tuple(tuple(torch.rand(size, generator=gen, device=device) for _ in range(my))
                 for _ in range(mx))


def _check_refresh(mesh, carries, panels, lay, launches):
    """One ``make_halo_exchange`` call against ``halo.refresh_phases``
    copied in order on a copy: equal bit for bit, in ``launches``
    launches."""
    plain = [halo.empty_blocks(carries), None if panels is None else halo.empty_blocks(panels)]
    for want, got in zip(plain, (carries, panels)):
        if want is not None:
            for ix, iy in mesh.shards():
                want[ix][iy].copy_(got[ix][iy])
    exchange = halo_rdma.make_halo_exchange(mesh, carries, panels, lay)
    before = halo_rdma.launches
    exchange()
    assert halo_rdma.launches - before == launches
    for phase in halo.refresh_phases(*plain, lay):
        halo.copy_pairs(halo.move_pairs(phase))
    torch.cuda.synchronize()
    for got, want in zip((carries, panels), plain):
        if want is not None:
            for ix, iy in mesh.shards():
                assert torch.equal(got[ix][iy], want[ix][iy])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tight", "aligned"])
@pytest.mark.parametrize("mesh_shape, nx, ny, k", [
    ((2, 2), 130, 98, 5),
    ((4, 1), 200, 150, 5),
    ((1, 1), 48, 40, 5),     # every neighbour is the shard itself
    ((3, 2), 66, 46, 4),
    ((1, 2), 64, 70, 1),
    ((2, 1), 70, 64, 1),
])
def test_halo_exchange_equals_plain_composition(cuda, mesh_shape, nx, ny, k, kind):
    """The whole refresh in one launch for the mesh of this card (y and x
    strips, corners from the diagonal shard; with panels on the tight
    layout, their x halos and their copy from ``iy = 0``) against its
    definition copied in order, bit for bit."""
    lay = getattr(halo.Layout, kind)(nx // mesh_shape[0], ny // mesh_shape[1], k)
    gen = torch.Generator(device=cuda).manual_seed(5)
    carries = _random_blocks(gen, cuda, mesh_shape, 9, lay.lx + 2 * k, lay.pitch)
    panels = (_random_blocks(gen, cuda, mesh_shape, lay.lx + 2 * k)
              if kind == "tight" else None)
    _check_refresh(_mesh(cuda, mesh_shape), carries, panels, lay, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n, steps", [(130, 20), (200, 7)])
def test_pull_sharded_runner_equals_copy_driven_steps(cuda, n, steps):
    """The one-step runner, whose refresh is one exchange launch per step,
    against the same launches driven by the two-phase strip copies: equal
    bit for bit, with no halo copy inside the loop."""
    cfg = SimConfig(nx=n, ny=n, reynolds=1000.0, collision="mrt", mesh_shape=(2, 2))
    mesh = _mesh(cuda, (2, 2))
    s0 = shard_state(engine.init_state(cfg, device=cuda), mesh)
    before = (halo_rdma.launches, halo.copies)
    a = unshard_state(pull_sharded.make_sharded_runner(cfg, steps, mesh)(s0), cuda)
    assert halo_rdma.launches - before[0] == steps
    # pad and unpad the blocks and the lid density (the runner keeps its
    # rows), and copy it over the columns
    assert halo.copies - before[1] == 4 * 4 + 2
    lay = pull_sharded.layout(n // 2, n // 2)
    carries = [halo.pad_blocks(s0.f, lay)]
    carries.append(halo.empty_blocks(carries[0]))
    rows = [halo.pad_rows(s0.rho_lid, 0)]
    rows.append(halo.empty_blocks(rows[0]))
    for i in range(steps):
        src, dst = i % 2, 1 - i % 2
        halo.copy_pairs(halo.halo_pairs(carries[src], lay))
        pull_sharded.run_calls([(cuda, pull_sharded._shard_call(
            cfg, lay, carries[src][ix][iy], rows[src][ix][iy],
            halo.edge_flags(mesh.shape, ix, iy), None, carries[dst][ix][iy],
            rows[dst][ix][iy])) for ix, iy in mesh.shards()])
    halo.copy_pairs(halo.replicate_pairs(rows[steps % 2]))
    b = unshard_state(halo.ShardedState(halo.unpad_blocks(carries[steps % 2], lay),
                                        rows[steps % 2]), cuda)
    torch.cuda.synchronize()
    assert torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)


# Meshes that span cards (skipped with fewer cards): the exchange kernel's
# peer writes with their event ordering, and ranks of a process group.

def _needs_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (2, 1)])
def test_rdma_across_the_cards_of_one_process(cuda, mesh_shape):
    """A shard per card: one exchange launch per card, each writing into
    its neighbours' carries on the peer cards; the runner equals the
    ``"ppermute"`` runner and the same mesh on one card bit for bit over 23
    steps."""
    n_cards = mesh_shape[0] * mesh_shape[1]
    _needs_cards(n_cards)
    cfg = SimConfig(nx=200, ny=160, reynolds=1000.0, collision="mrt",
                    mesh_shape=mesh_shape)
    s0 = engine.init_state(cfg, device=cuda)
    outs = []
    for mesh, impl, cards in ((make_mesh(mesh_shape), "rdma", n_cards),
                              (make_mesh(mesh_shape), "ppermute", n_cards),
                              (_mesh(cuda, mesh_shape), "ppermute", 1)):
        before = halo_rdma.launches
        outs.append(unshard_state(tblock_sharded.make_sharded_runner(
            cfg, 23, mesh, halo_impl=impl)(shard_state(s0, mesh)), cuda))
        # one launch per card per block under rdma, per remainder step always
        assert halo_rdma.launches - before == (4 * (impl == "rdma") + 3) * cards
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(outs[0].f, out.f) and torch.equal(outs[0].rho_lid, out.rho_lid)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape, kind, k", [((2, 1), "tight", 5), ((1, 2), "tight", 5),
                                                 ((2, 1), "aligned", 1)])
def test_halo_exchange_across_two_cards(cuda, mesh_shape, kind, k):
    """A shard per card: one launch per card, each writing its rectangles
    into the other card's carry and panel (peer writes, event-ordered),
    equal bit for bit to the refresh copied in order."""
    _needs_cards(2)
    mesh = make_mesh(mesh_shape)
    lay = getattr(halo.Layout, kind)(96 // mesh_shape[0], 80 // mesh_shape[1], k)
    torch.manual_seed(5)

    def blocks(*size):
        return tuple(tuple(torch.rand(size, device=mesh.device(ix, iy))
                           for iy in range(mesh_shape[1])) for ix in range(mesh_shape[0]))

    carries = blocks(9, lay.lx + 2 * k, lay.pitch)
    panels = blocks(lay.lx + 2 * k) if kind == "tight" else None
    _check_refresh(mesh, carries, panels, lay, 2)


def _ranks_on_cards(rank, shape):
    """In each process of a group with one card per rank: the sharded
    runners on a mesh that spans the processes, gathered on rank 0, equal
    the same runners on a mesh of rank 0's card."""
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    cfg = SimConfig(nx=200, ny=160, reynolds=1000.0, collision="mrt", mesh_shape=shape)
    pod = multihost.make_pod_mesh(shape, [device])
    s0 = engine.init_state(cfg, device=device)
    one = _mesh(device, shape)
    for make in (lambda m: pull_sharded.make_sharded_runner(cfg, 7, m),
                 lambda m: tblock_sharded.make_sharded_runner(cfg, 23, m),
                 lambda m: tblock_sharded.make_sharded_runner(cfg, 23, m, halo_impl="rdma")):
        out = unshard_state(make(pod)(shard_state(s0, pod)), device, pod)
        if rank == 0:
            ref = unshard_state(make(one)(shard_state(s0, one)), device)
            assert torch.equal(out.f, ref.f) and torch.equal(out.rho_lid, ref.rho_lid)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_processes_one_per_card(cuda, tmp_path, backend):
    """Four processes, one card each, a 2x2 mesh: strips between processes
    over NCCL (or host-staged gloo), and under ``"rdma"`` written through
    CUDA IPC into carries on the other cards."""
    _needs_cards(4)
    multihost.spawn(_ranks_on_cards, 4, str(tmp_path / "store"), args=((2, 2),),
                    backend=backend, timeout=300)


# --- the training path, datagen over a mesh, checkpoints ------------------------

def _train_data(res=48, n=10, seed=5):
    import numpy as np

    from latticeboltzmannsimulations_torch.ml import datagen, models, train

    rng = np.random.default_rng(seed)
    ds = datagen.DatasetArrays(
        re_range=np.linspace(100.0, 2000.0, n),
        feq_initial=rng.uniform(0.0, 0.5, (9, res, res)).astype(np.float32),
        f_final=np.zeros((n, 9, res, res), np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, res, res))).astype(np.float32))
    return train.prepare_inputs(ds, models.PRESETS["cnn_eight" if res % 192 == 0 else "cnn_one"])


# Per tensor, max |g_card - g_cpu| <= GRAD_RTOL * max |g_cpu|: float32 sums
# of up to ~7e4 products (a weight gradient over batch x pixels) reordered,
# about sqrt(7e4) * 2^-24 of the terms' size; TF32 rounds each product's
# inputs to 10 bits (2^-11), some hundred times more.
GRAD_RTOL = 1e-4


def _grad_errors(model_cpu, model_card):
    """Per tensor, max |g_card - g_cpu| / max |g_cpu|."""
    return {name: float((q.grad.cpu() - p.grad).abs().max()) / (float(p.grad.abs().max()) or 1.0)
            for (name, p), q in zip(model_cpu.named_parameters(), model_card.parameters())}


@pytest.mark.cuda
def test_training_backward_runs_without_tf32(cuda):
    """One float32 step of ``cnn_eight`` at 192^2: the gradients of
    ``train.loss_and_grads`` on the card equal the CPU's to GRAD_RTOL, the
    backward under the model's TF32 switch.  The same backward under
    cuDNN's global default (TF32 on), as a backward outside the switch
    would take it, misses that tolerance."""
    from latticeboltzmannsimulations_torch.ml import models, train

    data = _train_data(res=192, n=4)
    xb = torch.from_numpy(data.fnet[:2])
    auxb = torch.from_numpy(data.aux[:2])
    yb = torch.from_numpy(data.targets["x"][:2].copy())
    cpu_model = models.make_model("cnn_eight", seed=3)
    card_model = models.make_model("cnn_eight", seed=3).to(cuda)
    args = [t.to(cuda) for t in (xb, auxb, yb)]
    loss_cpu = train.loss_and_grads([cpu_model], xb, auxb, yb)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss_card = train.loss_and_grads([card_model], *args)
        assert torch.backends.cudnn.allow_tf32  # the switch is restored
        errs = _grad_errors(cpu_model, card_model)
        card_model.zero_grad(set_to_none=True)
        train._mse(card_model, *args).backward()  # outside the switch: TF32
        tf32_errs = _grad_errors(cpu_model, card_model)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert float(loss_card) == pytest.approx(float(loss_cpu), rel=1e-5)
    assert max(errs.values()) <= GRAD_RTOL, errs
    assert max(tf32_errs.values()) > GRAD_RTOL, tf32_errs


@pytest.mark.cuda
def test_training_resume_equals_the_uninterrupted_run_on_the_card(cuda, tmp_path):
    from latticeboltzmannsimulations_torch.ml import train

    data = _train_data()
    kw = dict(component="x", batch_size=2, schedule="inverse", optimizer="adam", device=cuda)
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full = train.train("cnn_one", data, epochs=3, **kw)
        ckpt = str(tmp_path / "leg.ckpt")
        train.train("cnn_one", data, epochs=2, checkpoint_path=ckpt, checkpoint_every=1, **kw)
        resumed = train.train("cnn_one", data, epochs=3, checkpoint_path=ckpt, **kw)
    finally:
        torch.backends.cudnn.deterministic = before
    assert resumed.history == full.history
    for name, w in full.params.items():
        assert torch.equal(resumed.params[name], w), name


@pytest.mark.cuda
def test_generate_dataset_on_a_mesh_of_the_card_equals_one_stack(cuda):
    """Eight cavities in one batch split over a (2, 1) mesh of the card: two
    stacks of four, one sweep launch per stack per step, the result equal
    to the single stack's bit for bit."""
    import numpy as np

    from latticeboltzmannsimulations_torch.ml import datagen

    cfg = SimConfig(nx=64, ny=64, collision="srt", turbulence="smagorinsky",
                    max_steps=20, report_interval=10)
    res = np.arange(100.0, 900.0, 100.0)
    before = pull.sweep_launches
    one = datagen.generate_dataset(cfg, re_values=res, batch_size=8, device=cuda)
    assert pull.sweep_launches - before == 20
    before = pull.sweep_launches
    two = datagen.generate_dataset(cfg, re_values=res, batch_size=8,
                                   mesh=make_mesh((2, 1), [cuda] * 2))
    assert pull.sweep_launches - before == 2 * 20
    for name in ("f_final", "u_final", "failed"):
        assert np.array_equal(getattr(two, name), getattr(one, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape, backend", [((1, 1), "cuda-pull"),
                                                  ((2, 2), "cuda-sharded")])
def test_simulate_resumes_on_the_card(cuda, tmp_path, mesh_shape, backend):
    """A run resumed from its middle checkpoint writes the uninterrupted
    run's final checkpoint bit for bit, through the kernel."""
    import numpy as np

    cfg = SimConfig(nx=64, ny=64, reynolds=100.0, collision="mrt", max_steps=600,
                    report_interval=100, convergence_tol=0.0, mesh_shape=mesh_shape)
    device = cuda if mesh_shape == (1, 1) else [cuda] * 4

    def run(out, **kw):
        return simulate(cfg, SimOptions(out_dir=str(tmp_path / out), verbose=False,
                                        checkpoint_every=200, **kw), device=device)

    assert run("full").backend == backend
    before = pull.launches
    resumed = run("resumed", resume_from=str(tmp_path / "full" / "ckpt" / "ckpt_00000400.npz"))
    if backend == "cuda-pull":
        assert pull.launches - before == 200
    assert resumed.steps == 600
    with np.load(tmp_path / "full" / "ckpt" / "ckpt_00000600.npz") as a, \
            np.load(tmp_path / "resumed" / "ckpt" / "ckpt_00000600.npz") as b:
        assert np.array_equal(a["f"], b["f"]) and np.array_equal(a["rho_lid"], b["rho_lid"])


@pytest.mark.cuda
def test_simulate_profile_trace_holds_the_kernel_launches(cuda, tmp_path):
    """``profile_dir`` traces the first chunk on the card: its Chrome trace
    holds one ``pull_step`` kernel event per step of that chunk, inside the
    chunk's span."""
    import json

    from latticeboltzmannsimulations_torch.sim import CHUNK_SPAN

    cfg = SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt", max_steps=600,
                    report_interval=200)
    prof = tmp_path / "prof"
    summary = simulate(cfg, SimOptions(out_dir=str(tmp_path), verbose=False,
                                       profile_dir=str(prof)), device=cuda)
    assert summary.backend == "cuda-pull" and summary.steps == 600
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "pull_step_kernel(" in e["name"]]
    (chunk,) = [e for e in events if e.get("name") == CHUNK_SPAN
                and e.get("cat") == "user_annotation"]
    assert len(kernels) == 200
    assert sum(e["dur"] for e in kernels) < chunk["dur"]


@pytest.mark.cuda
def test_cli_run_writes_vtk_on_the_card(cuda, tmp_path, capsys):
    import json
    import os

    from latticeboltzmannsimulations_torch import cli

    assert cli.main(["run", "--nx", "96", "--re", "100", "--max-steps", "400",
                     "--interval", "200", "--vtk", "--out", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["backend"] == "cuda-pull" and summary["steps"] == 400
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".vtr")) == [
        "ldc.0.vtr", "ldc.1.vtr"]


# The CUDA-graph runners (kernels/graphs.py) against their eager forms, the
# same launches issued one by one from the host: equal bit for bit, the
# input untouched, a returned state not overwritten by the next call, every
# counter at the eager count.

def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [] if x is None else [t for item in x for t in _tensors(item)]


def _same(a, b):
    """Bit for bit (a NaN equals itself)."""
    a, b = _tensors(a), _tensors(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def _counted(fn):
    """``fn()`` and what it added to each counter (``halo.copies`` last)."""
    from latticeboltzmannsimulations_torch.kernels import graphs

    keys = graphs._counters()
    before = [getattr(*key) for key in keys]
    out = fn()
    torch.cuda.synchronize()
    return out, [getattr(*key) - b for key, b in zip(keys, before)]


def _holds_to_eager(graphed, eager, *args, rows_out=0):
    """``graphed(*args)`` (built, not yet called) against ``eager(*args)``,
    twice; ``rows_out``: the copies of the lid densities out of the rows a
    graphed sharded runner keeps, beyond the eager runner's copies."""
    kept = [t.clone() for t in _tensors(args)]
    want, eager_counts = _counted(lambda: eager(*args))
    assert all(bool(torch.isfinite(t).all()) for t in _tensors(want))
    want_counts = eager_counts[:-1] + [eager_counts[-1] + rows_out]
    got, counts = _counted(lambda: graphed(*args))
    assert _same(got, want) and counts == want_counts
    assert _same(args, kept)
    first = [t.clone() for t in _tensors(got)]
    again, counts = _counted(lambda: graphed(*args))
    assert _same(got, first) and _same(again, want) and counts == want_counts


# (at Re=400: each stays finite over the 4 001 steps)
GRAPH_CASES = {
    "mrt": dict(collision="mrt"),
    "srt_van_driest": dict(collision="srt", turbulence="smagorinsky", van_driest=True),
    "tangential": dict(collision="mrt", boundary="nebb_tangential"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 2, 7, 2000, 4001])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_scan_runner_equals_eager(cuda, case, n_steps):
    """Up to the body's 2 000 launches in one graph; 4 001 replays the body
    twice and the odd remainder once."""
    cfg = SimConfig(**{"nx": 64, "ny": 48, "reynolds": 400.0, **GRAPH_CASES[case]})
    s0 = _noisy(cfg, cuda)
    _holds_to_eager(pull.make_scan_runner(cfg, n_steps, device=cuda),
                    pull._eager_scan_runner(cfg, n_steps, device=cuda), s0)


def _noisy(cfg, cuda, seed=3):
    s = engine.init_state(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    noise = torch.randn(s.f.shape, generator=gen, device=cuda)
    return engine.State(s.f * (1.0 + 1e-3 * noise), s.rho_lid)


@pytest.mark.cuda
def test_graphed_scan_runner_keeps_the_van_driest_plane(cuda):
    """The graphs read the runner's Cs^2 plane on every replay: with the
    memory a freed plane would have had refilled between calls, the replays
    still equal the eager runner."""
    import gc

    cfg = SimConfig(nx=128, ny=128, reynolds=5000.0, collision="srt",
                    turbulence="smagorinsky", van_driest=True)
    run = pull.make_scan_runner(cfg, 20, device=cuda)
    s0 = engine.init_state(cfg, device=cuda)
    first = run(s0)
    gc.collect()
    junk = [torch.full((cfg.nx, cfg.ny), float("nan"), device=cuda) for _ in range(64)]
    again = run(s0)
    want = pull._eager_scan_runner(cfg, 20, device=cuda)(s0)
    torch.cuda.synchronize()
    del junk
    assert _same(first, want) and _same(again, want)


@pytest.mark.cuda
def test_graphed_sweep_runner_takes_new_omegas(cuda):
    """One runner, called with one set of omegas, another, then the first
    again: its graphs read the table copied in before each replay, so each
    call equals the eager runner with the same omegas."""
    cfg = SimConfig(nx=64, ny=64, reynolds=100.0, collision="srt", turbulence="smagorinsky")
    n_cav, steps = 4, 30
    s = _noisy(SimConfig(nx=n_cav * 64, ny=64, reynolds=100.0), cuda)
    graphed = pull.make_sweep_runner(cfg, n_cav, steps, device=cuda)
    eager = pull._eager_sweep_runner(cfg, n_cav, steps, device=cuda)
    for omegas in ([1.2, 1.4, 1.6, 1.8], [1.9, 1.1, 1.5, 1.3], [1.2, 1.4, 1.6, 1.8]):
        got, counts = _counted(lambda: graphed(s, omegas))
        want, want_counts = _counted(lambda: eager(s, omegas))
        assert _same(got, want) and counts == want_counts
    one = pull.make_scan_runner_omega(cfg, steps, device=cuda)
    one_eager = pull._eager_sweep_runner(cfg, 1, steps, device=cuda)
    s1 = _noisy(cfg, cuda)
    for omega in (1.3, 1.7):
        assert _same(one(s1, omega), one_eager(s1, [omega]))


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [7, 23, 2003])
def test_graphed_tblock_runner_equals_eager(cuda, n_steps):
    """K=5 blocks, then the n mod K one-step launches, in one graph."""
    cfg = SimConfig(nx=130, ny=100, reynolds=1000.0, collision="mrt")
    _holds_to_eager(tblock.make_scan_runner(cfg, n_steps, device=cuda),
                    tblock._eager_scan_runner(cfg, n_steps, device=cuda), _noisy(cfg, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 7, 2001])
def test_graphed_push_runner_equals_eager(cuda, n_steps):
    cfg = SimConfig(nx=64, ny=48, reynolds=400.0, collision="mrt")
    _holds_to_eager(push.make_push_scan_runner(cfg, n_steps, device=cuda),
                    push._eager_push_scan_runner(cfg, n_steps, device=cuda),
                    _noisy(cfg, cuda).f)


@pytest.mark.cuda
@pytest.mark.parametrize("runner, n_steps", [
    ("pull", 7), ("pull", 20), ("rdma", 23), ("ppermute", 23), ("rdma", 20),
])
def test_graphed_sharded_runners_equal_eager(cuda, runner, n_steps):
    """On a 2x2 mesh of the card: each step's (block's) refresh and shard
    launches in the graphs, the remainder through the one-step runner's."""
    cfg = SimConfig(nx=130, ny=98, reynolds=1000.0, collision="mrt", mesh_shape=(2, 2))
    mesh = _mesh(cuda, (2, 2))
    s0 = shard_state(_noisy(dataclasses.replace(cfg, mesh_shape=(1, 1)), cuda), mesh)
    if runner == "pull":
        graphed = pull_sharded.make_sharded_runner(cfg, n_steps, mesh)
        eager = pull_sharded._eager_sharded_runner(cfg, n_steps, mesh)
        rows_out = 4
    else:
        graphed = tblock_sharded.make_sharded_runner(cfg, n_steps, mesh, halo_impl=runner)
        eager = tblock_sharded._eager_sharded_runner(cfg, n_steps, mesh, halo_impl=runner)
        rows_out = 4 if n_steps % tblock_sharded.K_STEPS else 0
    _holds_to_eager(graphed, eager, s0, rows_out=rows_out)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A launch that fails inside the capture raises out of the runner's
    first call; the stream is usable afterwards."""
    from latticeboltzmannsimulations_torch.kernels import graphs

    def launch(one):
        if one.src == 1:
            raise RuntimeError("a launch failed")
        torch.cuda._sleep(10)

    with pytest.raises(RuntimeError, match="a launch failed"):
        graphs.Graphs(cuda, graphs.plan(3), launch).replay()
    x = torch.ones(4, device=cuda)
    assert (x + 1).sum().item() == 8.0
