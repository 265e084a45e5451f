"""The port's driver against the JAX package's, and its routing."""

import json

import numpy as np
import pytest
import torch

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
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
    (dict(boundary="nebb_tangential"), "auto", CUDA, "torch"),
    (dict(), "cuda-pull", CUDA, "cuda-pull"),
    (dict(), "torch", CUDA, "torch"),
])
def test_backend_routing(kw, backend, device, expect):
    cfg = TConfig(**{"nx": 16, "ny": 16, **kw})
    _, name = _select_backend(cfg, backend, device)
    assert name == expect


@pytest.mark.parametrize("kw, backend, exc", [
    (dict(precision="float64"), "cuda-pull", ValueError),
    (dict(boundary="nebb_tangential"), "cuda-pull", ValueError),
    (dict(), "cuda-pull", ValueError),               # CPU: the kernel needs the card
    (dict(), "pallas", ValueError),
    (dict(boundary="bounce_back"), "auto", NotImplementedError),
    (dict(boundary="nebb_west_eq"), "auto", NotImplementedError),
    (dict(mesh_shape=(2, 2)), "auto", NotImplementedError),
])
def test_backend_routing_refuses(kw, backend, exc):
    cfg = TConfig(nx=16, ny=16, **kw)
    with pytest.raises(exc):
        _select_backend(cfg, backend, CPU)


@pytest.mark.parametrize("option, value", [
    ("save_plots", True), ("save_vtk", True), ("checkpoint_every", 100),
    ("resume_from", "ckpt.npz"), ("profile_dir", "trace"),
])
def test_options_not_ported_yet_raise(tmp_path, option, value):
    opts = TOptions(out_dir=str(tmp_path), verbose=False, **{option: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_simulate(TConfig(nx=16, ny=16), opts, device="cpu")


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
