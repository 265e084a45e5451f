"""The port's driver against the JAX package's, and its routing."""

import json

import numpy as np
import pytest
import torch

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch import sim as t_sim
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.parallel import halo
from latticeboltzmannsimulations_torch.sim import SimOptions as TOptions
from latticeboltzmannsimulations_torch.sim import _select_backend
from latticeboltzmannsimulations_torch.sim import run_to_convergence as t_run
from latticeboltzmannsimulations_torch.sim import simulate as t_simulate
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.sim import SimOptions as JOptions
from latticeboltzmannsimulations_tpu.sim import simulate as j_simulate

CPU = torch.device("cpu")


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("mass_correction", [True, False])
def test_simulate_matches_jax(tmp_path, mass_correction):
    kw = dict(nx=32, ny=32, reynolds=100.0, collision="mrt", precision="float64",
              max_steps=600, report_interval=200)
    t_dir, j_dir = tmp_path / "torch", tmp_path / "jax"
    t_sum = t_simulate(TConfig(**kw), TOptions(out_dir=str(t_dir), verbose=False,
                                               mass_correction=mass_correction),
                       device="cpu")
    j_sum = j_simulate(JConfig(**kw), JOptions(out_dir=str(j_dir), verbose=False,
                                               backend="jit",
                                               mass_correction=mass_correction))
    assert t_sum.backend == "torch"
    assert (t_sum.steps, t_sum.converged) == (j_sum.steps, j_sum.converged)
    assert t_sum.r2_ux == pytest.approx(j_sum.r2_ux, abs=1e-10)
    assert t_sum.l2_combined == pytest.approx(j_sum.l2_combined, abs=1e-10)
    assert t_sum.out_dir == str(t_dir) and np.isfinite(t_sum.mlups)
    t_rec = _records(t_dir / "ldc_metrics.jsonl")
    j_rec = _records(j_dir / "ldc_metrics.jsonl")
    assert [sorted(r) for r in t_rec] == [sorted(r) for r in j_rec]
    for a, b in zip(t_rec, j_rec):
        assert a["step"] == b["step"]
        for key in ("mean_u", "r2_ux", "l2"):
            if key in b:
                assert a[key] == pytest.approx(b[key], abs=1e-10), key


def test_cuda_pull_route_on_cpu_raises(tmp_path):
    """The kernel runs only on the card: an explicit ``cuda-pull`` on the CPU
    raises rather than run the plain version under the kernel's name."""
    cfg = TConfig(nx=24, ny=24, reynolds=100.0, max_steps=60, report_interval=30)
    with pytest.raises(ValueError, match="CUDA device"):
        t_simulate(cfg, TOptions(out_dir=str(tmp_path / "run"), verbose=False,
                                 backend="cuda-pull"), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        t_run(cfg, device="cpu", backend="cuda-pull")
    assert not (tmp_path / "run").exists()


def test_package_run_to_convergence_routes_like_simulate():
    """On the CPU the package-level driver takes the plain engine, the same
    run as ``engine.run_to_convergence``."""
    cfg = TConfig(nx=24, ny=24, reynolds=100.0, max_steps=90, report_interval=30)
    a = lbt.run_to_convergence(cfg, device="cpu")
    b = t_eng.run_to_convergence(cfg, device="cpu")
    assert (a.steps, a.converged) == (b.steps, b.converged) == (90, False)
    assert a.mean_u_history == b.mean_u_history
    assert torch.equal(a.state.f, b.state.f)


CUDA = torch.device("cuda", 0)


@pytest.mark.parametrize("kw, backend, device, expect", [
    (dict(), "auto", CPU, "torch"),                  # no card: the plain engine
    (dict(precision="float64"), "auto", CPU, "torch"),
    (dict(boundary="nebb_tangential"), "auto", CPU, "torch"),
    (dict(), "torch", CPU, "torch"),
    # Routing only names the runner; it touches no device, so the card's
    # routes are checked here too.
    (dict(), "auto", CUDA, "cuda-pull"),
    (dict(nx=70000), "auto", CUDA, "cuda-pull"),     # no grid limit on nx
    (dict(precision="float64"), "auto", CUDA, "torch"),
    (dict(boundary="nebb_tangential", precision="float64"), "auto", CUDA, "torch"),
    (dict(), "cuda-pull", CUDA, "cuda-pull"),
    (dict(), "torch", CUDA, "torch"),
    # The push scheme: the walls only the push engines implement go to the
    # push kernel on the card where it serves them (float32, no Van
    # Driest), to the push oracle otherwise; for NEBB the push kernel only
    # when asked for.
    (dict(boundary="bounce_back"), "auto", CPU, "push-oracle"),
    (dict(boundary="nebb_west_eq"), "auto", CPU, "push-oracle"),
    (dict(boundary="bounce_back"), "auto", CUDA, "cuda-push"),
    (dict(boundary="nebb_west_eq"), "auto", CUDA, "cuda-push"),
    (dict(boundary="bounce_back", turbulence="smagorinsky"), "auto", CUDA, "cuda-push"),
    (dict(boundary="bounce_back", turbulence="smagorinsky", van_driest=True), "auto",
     CUDA, "push-oracle"),
    (dict(boundary="nebb_west_eq", turbulence="smagorinsky", van_driest=True), "auto",
     CUDA, "push-oracle"),
    (dict(boundary="bounce_back", precision="float64"), "auto", CUDA, "push-oracle"),
    (dict(boundary="nebb_west_eq", precision="float64"), "auto", CUDA, "push-oracle"),
    (dict(boundary="bounce_back"), "push-oracle", CUDA, "push-oracle"),
    (dict(boundary="nebb_west_eq"), "cuda-push", CUDA, "cuda-push"),
    (dict(boundary="nebb_west_eq"), "push-oracle", CPU, "push-oracle"),
    (dict(), "push-oracle", CUDA, "push-oracle"),
    (dict(), "cuda-push", CUDA, "cuda-push"),
    (dict(nx=64, ny=64), "cuda-tblock", CUDA, "cuda-tblock"),
    (dict(nx=64, ny=64, turbulence="smagorinsky", van_driest=True), "auto", CUDA,
     "cuda-pull"),
])
def test_backend_routing(kw, backend, device, expect):
    cfg = TConfig(**{"nx": 16, "ny": 16, **kw})
    assert _select_backend(cfg, backend, device).name == expect


@pytest.mark.parametrize("kw, backend, exc", [
    (dict(precision="float64"), "cuda-pull", ValueError),
    (dict(boundary="nebb_tangential"), "cuda-pull", ValueError),
    (dict(), "cuda-pull", ValueError),               # CPU: the kernel needs the card
    (dict(), "pallas", ValueError),
    (dict(), "cuda-push", ValueError),               # CPU
    (dict(boundary="bounce_back"), "cuda-push", ValueError),   # CPU
    (dict(boundary="nebb_west_eq"), "cuda-push", ValueError),  # CPU
    (dict(nx=64, ny=64), "cuda-tblock", ValueError),  # CPU
    (dict(boundary="bounce_back"), "torch", ValueError),
    # The push oracle runs these walls on one device only, as in the JAX driver.
    (dict(boundary="bounce_back", mesh_shape=(2, 1)), "auto", ValueError),
    (dict(boundary="nebb_west_eq", mesh_shape=(1, 2)), "auto", ValueError),
    (dict(mesh_shape=(2, 2)), "auto", ValueError),   # one device, a 2x2 mesh
])
def test_backend_routing_refuses(kw, backend, exc):
    cfg = TConfig(**{"nx": 16, "ny": 16, **kw})
    with pytest.raises(exc):
        _select_backend(cfg, backend, CPU)


@pytest.mark.parametrize("kw, backend, match", [
    (dict(boundary="bounce_back", turbulence="smagorinsky", van_driest=True),
     "cuda-push", "Van Driest"),
    (dict(boundary="nebb_west_eq"), "cuda-pull", "NEBB"),
    (dict(boundary="bounce_back"), "cuda-tblock", "NEBB"),
    (dict(precision="float64"), "cuda-push", "float32"),
    (dict(precision="float64", nx=64, ny=64), "cuda-tblock", "float32"),
    (dict(turbulence="smagorinsky", van_driest=True), "cuda-push", "Van Driest"),
    (dict(nx=64, ny=64, turbulence="smagorinsky", van_driest=True), "cuda-tblock",
     "Van Driest"),
    (dict(nx=48, ny=48, boundary="nebb_tangential"), "cuda-tblock", "NEBB"),
    (dict(boundary="bounce_back", mesh_shape=(1, 2)), "push-oracle", "single-device"),
])
def test_explicit_kernel_backends_refuse_on_the_card(kw, backend, match):
    """An explicit kernel backend that cannot serve a configuration raises,
    rather than run another engine under its name (routing touches no
    device, so the card's routes are checked here)."""
    cfg = TConfig(**{"nx": 16, "ny": 16, **kw})
    with pytest.raises(ValueError, match=match):
        _select_backend(cfg, backend, CUDA)


@pytest.mark.parametrize("precision, want", [("float32", "cuda-pull"),
                                              ("float64", "torch")])
@pytest.mark.parametrize("n", [128, 4096])
def test_auto_routes_the_tangential_lid_to_the_one_step_kernel(n, precision, want):
    """``auto`` on the card sends the float32 tangential lid to the one-step
    kernel at every size (the temporal-block kernel computes the NEBB lid),
    and float64 to the plain engine.  Routing builds no runner."""
    cfg = TConfig(nx=n, ny=n, reynolds=1000.0, collision="mrt",
                  boundary="nebb_tangential", precision=precision)
    assert _select_backend(cfg, "auto", CUDA).name == want
    if precision == "float32":
        assert _select_backend(cfg, "cuda-pull", CUDA).name == "cuda-pull"
        with pytest.raises(ValueError, match="NEBB"):
            _select_backend(cfg, "cuda-tblock", CUDA)
    assert _select_backend(cfg, "torch", CUDA).name == "torch"
    assert _select_backend(cfg, "auto", CPU).name == "torch"


@pytest.mark.parametrize("n", [64, 1024, 2048, 4096])
def test_auto_takes_the_temporal_block_kernel_from_the_measured_size(n):
    """``auto`` on the card takes cuda-tblock for float32 NEBB fields of at
    least ``TBLOCK_AUTO_MIN_CELLS`` cells (set from chip_smoke.py's timing;
    None: never), cuda-pull below it."""
    cfg = TConfig(nx=n, ny=n, reynolds=5000.0, collision="mrt")
    threshold = t_sim.TBLOCK_AUTO_MIN_CELLS
    want = ("cuda-tblock" if threshold is not None and n * n >= threshold
            else "cuda-pull")
    assert _select_backend(cfg, "auto", CUDA).name == want
    assert _select_backend(cfg, "auto", CPU).name == "torch"


@pytest.mark.parametrize("precision, tol", [("float64", 1e-12), ("float32", 1e-6)])
@pytest.mark.parametrize("boundary", ["bounce_back", "nebb_west_eq"])
def test_push_path_simulate_matches_jax(tmp_path, boundary, precision, tol):
    """The push-oracle route of ``simulate`` against the JAX driver's
    (which also routes these walls to its push oracle), 48^2, 200 steps:
    mean u at each interval (float32: the two independent float32 runs
    differ per cell by ~1e-6 at most, and the mean averages that down)."""
    kw = dict(nx=48, ny=48, reynolds=100.0, boundary=boundary, collision="mrt",
              precision=precision, max_steps=200, report_interval=100)
    t_dir, j_dir = tmp_path / "torch", tmp_path / "jax"
    t_sum = t_simulate(TConfig(**kw), TOptions(out_dir=str(t_dir), verbose=False),
                       device="cpu")
    j_sum = j_simulate(JConfig(**kw), JOptions(out_dir=str(j_dir), verbose=False))
    assert t_sum.backend == "push-oracle" and t_sum.steps == j_sum.steps == 200
    t_rec = _records(t_dir / "ldc_metrics.jsonl")
    j_rec = _records(j_dir / "ldc_metrics.jsonl")
    assert [r["step"] for r in t_rec] == [r["step"] for r in j_rec]
    for a, b in zip(t_rec[:-1], j_rec[:-1]):
        assert a["backend"] == b["backend"] == "push-oracle"
        assert a["mean_u"] == pytest.approx(b["mean_u"], rel=0, abs=tol)
    assert t_sum.r2_ux == pytest.approx(j_sum.r2_ux, abs=100 * tol)


def test_push_oracle_run_to_convergence_observes_the_push_state():
    """``run_to_convergence`` on the push route reads the push state's
    observables (lid corners by the boundary's rule), as ``simulate`` does."""
    cfg = TConfig(nx=24, ny=24, reynolds=100.0, boundary="nebb_west_eq",
                  max_steps=60, report_interval=30)
    res = lbt.run_to_convergence(cfg, device="cpu")
    _, u = t_eng.push_observables(cfg, res.state)
    assert res.mean_u_history[-1] == float(np.mean(u.numpy(), dtype=np.float64))
    assert float(u[0, 0, 0]) == pytest.approx(cfg.u_lid)  # nebb_west_eq: corners move with the lid


@pytest.mark.parametrize("option, value", [
    ("save_plots", True), ("save_vtk", True), ("profile_dir", "trace"),
])
def test_options_not_ported_yet_raise(tmp_path, option, value):
    """Named for the slices in which these options raised
    ``NotImplementedError``; each now runs and writes its output."""
    if option == "profile_dir":
        value = str(tmp_path / value)
    opts = TOptions(out_dir=str(tmp_path), verbose=False, **{option: value})
    t_simulate(TConfig(nx=16, ny=16, max_steps=40, report_interval=20), opts, device="cpu")
    written = {"save_plots": "ldc_000040.png", "save_vtk": "ldc.1.vtr",
               "profile_dir": "trace/trace.json"}[option]
    assert (tmp_path / written).is_file()


def test_simulate_raises_on_blow_up(tmp_path):
    cfg = TConfig(nx=16, ny=16, reynolds=200000.0, collision="srt",
                  max_steps=2000, report_interval=100, convergence_tol=0.0)
    with pytest.raises(FloatingPointError):
        t_simulate(cfg, TOptions(out_dir=str(tmp_path), verbose=False), device="cpu")


def test_simulate_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_simulate(TConfig(nx=16, ny=16), TOptions(out_dir=str(tmp_path), verbose=False))


@pytest.mark.parametrize("backend", ["auto", "sharded"])
def test_simulate_on_a_mesh_of_cpu_shards_gives_the_single_device_run(tmp_path, backend):
    """A (2, 2) mesh of CPU shards routes to the plain sharded engine and
    reproduces the single-device run: steps, metrics and Ghia scores, with
    the mass correction applied to every shard.  (float64: the sharded
    density sums round differently from the global ones in the last bit.)"""
    kw = dict(nx=32, ny=32, reynolds=100.0, collision="mrt", max_steps=600,
              report_interval=200, precision="float64")
    one = t_simulate(TConfig(**kw), TOptions(out_dir=str(tmp_path / "one"), verbose=False),
                     device="cpu")
    mesh = t_simulate(TConfig(**kw, mesh_shape=(2, 2)),
                      TOptions(out_dir=str(tmp_path / "mesh"), verbose=False,
                               backend=backend),
                      device=["cpu"] * 4)
    assert (one.backend, mesh.backend) == ("torch", "sharded")
    assert (mesh.steps, mesh.converged) == (one.steps, one.converged)
    for key in ("r2_ux", "r2_uy", "l2_combined"):
        assert getattr(mesh, key) == pytest.approx(getattr(one, key), abs=1e-12), key
    a = _records(tmp_path / "one" / "ldc_metrics.jsonl")
    b = _records(tmp_path / "mesh" / "ldc_metrics.jsonl")
    assert [r["step"] for r in a] == [r["step"] for r in b]
    for x, y in zip(a, b):
        if "mean_u" in x:
            assert y["mean_u"] == pytest.approx(x["mean_u"], abs=1e-15)


def test_run_to_convergence_on_a_mesh_of_cpu_shards_gives_the_single_device_run():
    kw = dict(nx=24, ny=24, reynolds=100.0, max_steps=90, report_interval=30,
              precision="float64")
    one = t_run(TConfig(**kw), device="cpu")
    seen = []
    mesh = t_run(TConfig(**kw, mesh_shape=(2, 2)), device=["cpu"] * 4,
                 callback=lambda step, state, rho, u: seen.append((step, type(state))))
    assert (mesh.steps, mesh.converged) == (one.steps, one.converged) == (90, False)
    assert mesh.mean_u_history == pytest.approx(one.mean_u_history, abs=1e-15)
    # the result holds the global state; the callback saw the sharded one
    torch.testing.assert_close(mesh.state.f, one.state.f, rtol=0, atol=1e-12)
    torch.testing.assert_close(mesh.state.rho_lid, one.state.rho_lid, rtol=0, atol=1e-12)
    assert seen == [(30, halo.ShardedState), (60, halo.ShardedState),
                    (90, halo.ShardedState)]


@pytest.mark.parametrize("device, exc, match", [
    ("cpu", ValueError, "pass a sequence"),           # one device, a 2x2 mesh
    (["cpu"] * 3, ValueError, "needs 4 devices, have 3"),
    (torch.device("cuda", 0), ValueError, "pass a sequence"),
])
def test_a_mesh_needs_its_devices(tmp_path, device, exc, match):
    cfg = TConfig(nx=16, ny=16, max_steps=10, report_interval=10, mesh_shape=(2, 2))
    with pytest.raises(exc, match=match):
        t_simulate(cfg, TOptions(out_dir=str(tmp_path), verbose=False), device=device)
    with pytest.raises(exc, match=match):
        t_run(cfg, device=device)


def test_a_mesh_defaults_to_the_cards(tmp_path):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present")
    cfg = TConfig(nx=16, ny=16, max_steps=10, report_interval=10, mesh_shape=(2, 2))
    with pytest.raises((RuntimeError, ValueError), match="CUDA devices|needs 4 devices"):
        t_simulate(cfg, TOptions(out_dir=str(tmp_path), verbose=False))


def test_a_one_device_sequence_runs_a_single_device_config():
    cfg = TConfig(nx=16, ny=16, max_steps=20, report_interval=10)
    a = t_run(cfg, device=["cpu"])
    b = t_run(cfg, device="cpu")
    assert torch.equal(a.state.f, b.state.f)
