"""Simulation checkpoints (``io.checkpoint``) and ``simulate``'s resume,
checkpointing and one-shot blow-up restore, against the JAX package on the
CPU.

Tolerances: checkpoint arrays across packages byte for byte (the same
``.npz`` keys and fingerprint, NumPy on both sides); a resumed run against
the uninterrupted one in the same package bit for bit (the same arithmetic
from the same saved state); a port run resumed from the JAX package's
checkpoint against JAX's own continuation in float64 to 1e-12 (the same
algorithm in another framework)."""

import json
import os

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine, sim
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.io import checkpoint
from latticeboltzmannsimulations_torch.io import Checkpointer, load_checkpoint, save_checkpoint
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate
from latticeboltzmannsimulations_tpu import engine as jengine
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.io import checkpoint as jcheckpoint
from latticeboltzmannsimulations_tpu.sim import SimOptions as JOptions
from latticeboltzmannsimulations_tpu.sim import simulate as j_simulate

CPU = torch.device("cpu")
SELECT = sim._select_backend
CONFIGS = {
    "mrt": dict(collision="mrt"),
    "trt_les_van_driest": dict(collision="trt", turbulence="smagorinsky", van_driest=True,
                               reynolds=5000.0),
    "float64": dict(precision="float64"),
    "mesh": dict(mesh_shape=(2, 2), report_interval=250, max_steps=999),
}


def _state(cfg, seed=3):
    dtype = np.float32 if cfg.precision == "float32" else np.float64
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 0.3, (9, cfg.nx, cfg.ny)).astype(dtype),
            rng.uniform(0.9, 1.1, cfg.nx).astype(dtype))


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_checkpoints_load_across_packages(tmp_path, kw):
    """The port reads the JAX package's checkpoint and the JAX package the
    port's: the same fingerprint string, the same arrays, and each refuses
    the other's checkpoint of another configuration."""
    cfg, jcfg = SimConfig(nx=24, ny=16, **kw), JConfig(nx=24, ny=16, **kw)
    assert checkpoint._fingerprint(cfg) == jcheckpoint._fingerprint(jcfg)
    f, lid = _state(cfg)
    jpath = jcheckpoint.save_checkpoint(str(tmp_path / "jax"),
                                        jengine.State(f=f, rho_lid=lid), 70, jcfg)
    state, step = load_checkpoint(jpath, cfg, device="cpu")
    assert step == 70
    assert state.f.dtype == cfg.dtype and state.f.is_contiguous()
    assert state.rho_lid.is_contiguous()
    np.testing.assert_array_equal(state.f.numpy(), f)
    np.testing.assert_array_equal(state.rho_lid.numpy(), lid)

    tpath = save_checkpoint(str(tmp_path / "port"),
                            engine.State(torch.from_numpy(f), torch.from_numpy(lid)), 90, cfg)
    assert tpath.endswith(".npz")
    jstate, jstep = jcheckpoint.load_checkpoint(tpath, jcfg)
    assert jstep == 90
    np.testing.assert_array_equal(np.asarray(jstate.f), f)
    np.testing.assert_array_equal(np.asarray(jstate.rho_lid), lid)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files) == ["f", "fingerprint", "rho_lid", "step"]
        assert bytes(za["fingerprint"]) == bytes(zb["fingerprint"])

    other = SimConfig(nx=24, ny=16, **{**kw, "reynolds": 123.0})
    with pytest.raises(ValueError, match="different config"):
        load_checkpoint(jpath, other, device="cpu")
    with pytest.raises(ValueError, match="different config"):
        jcheckpoint.load_checkpoint(tpath, JConfig(nx=24, ny=16, **{**kw, "reynolds": 123.0}))


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    cfg = SimConfig(nx=16, ny=16)
    f, lid = _state(cfg)
    path = save_checkpoint(str(tmp_path / "c"), engine.State(torch.from_numpy(f),
                                                             torch.from_numpy(lid)), 1, cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(path, cfg)


# --- Checkpointer's rules (as tests/test_io.py pins the JAX package's) ------------

@pytest.fixture
def fields():
    cfg = SimConfig(nx=32, ny=32, reynolds=100.0)
    state = engine.init_state(cfg, CPU)
    rho, u = engine.observables(cfg, state)
    return cfg, state, rho.numpy(), u.numpy()


def _files(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".npz"))


def test_checkpointer_keeps_last_k(tmp_path, fields):
    cfg, state, rho, u = fields
    ck = Checkpointer(str(tmp_path), cfg, every=10, keep=2, device="cpu")
    for s in (10, 20, 30):
        ck(s, state, rho, u)
    assert _files(tmp_path) == ["ckpt_00000020.npz", "ckpt_00000030.npz"]
    restored, n = ck.restore_last_good()
    assert n == 30
    assert torch.equal(restored.f, state.f)


def test_checkpointer_never_deletes_the_last_good_one(tmp_path, fields):
    cfg, state, rho, u = fields
    ck = Checkpointer(str(tmp_path), cfg, every=10, keep=0, device="cpu")
    ck(10, state, rho, u)
    assert _files(tmp_path) == ["ckpt_00000010.npz"]


def test_checkpointer_saves_when_every_not_multiple_of_interval(tmp_path, fields):
    cfg, state, rho, u = fields
    ck = Checkpointer(str(tmp_path), cfg, every=75, keep=3, device="cpu")
    for s in (50, 100, 150, 200):
        ck(s, state, rho, u)
    assert _files(tmp_path) == ["ckpt_00000100.npz", "ckpt_00000200.npz"]


def test_checkpointer_resume_seeds_save_clock(tmp_path, fields):
    cfg, state, rho, u = fields
    ck = Checkpointer(str(tmp_path), cfg, every=100, keep=2, start_step=500, device="cpu")
    ck(550, state, rho, u)   # only 50 steps since resume: no save
    assert _files(tmp_path) == []
    ck(600, state, rho, u)   # 100 steps since resume: saves
    assert _files(tmp_path) == ["ckpt_00000600.npz"]


def test_checkpointer_never_persists_diverged_state(tmp_path, fields):
    """A non-finite state is never written (a fresh process's cold scan
    takes the newest file), and the save clock rewinds on restore."""
    cfg, state, rho, u = fields
    bad_u = u.copy()
    bad_u[0, 5, 5] = np.nan
    ck = Checkpointer(str(tmp_path), cfg, every=100, keep=2, device="cpu")
    ck(100, state, rho, u)
    ck(200, state, rho, torch.from_numpy(bad_u))  # a tensor is read as well
    assert _files(tmp_path) == ["ckpt_00000100.npz"]
    ck2 = Checkpointer(str(tmp_path), cfg, every=100, keep=2, device="cpu")
    restored, step = ck2.restore_last_good()
    assert step == 100
    ck2(200, restored, rho, u)
    assert _files(tmp_path) == ["ckpt_00000100.npz", "ckpt_00000200.npz"]
    with pytest.raises(FileNotFoundError):
        os.makedirs(tmp_path / "empty")
        Checkpointer(str(tmp_path / "empty"), cfg, device="cpu").restore_last_good()


# --- simulate: resume, checkpoints, the blow-up restore ------------------------------

ROUTES = {
    "torch": (dict(), "cpu", "torch"),
    "push": (dict(boundary="bounce_back"), "cpu", "push-oracle"),
    "sharded": (dict(mesh_shape=(2, 2), precision="float64"), ["cpu"] * 4, "sharded"),
}
RUN = dict(nx=32, ny=32, reynolds=100.0, collision="mrt", max_steps=600, report_interval=100,
           convergence_tol=0.0)


def _opts(out, **kw):
    return SimOptions(out_dir=str(out), verbose=False, checkpoint_every=200, **kw)


def _final(out, step=600):
    with np.load(os.path.join(out, "ckpt", f"ckpt_{step:08d}.npz")) as z:
        return z["f"], z["rho_lid"], int(z["step"])


@pytest.mark.parametrize("route", ROUTES.values(), ids=ROUTES.keys())
def test_resumed_simulate_equals_the_uninterrupted_run(tmp_path, monkeypatch, route):
    """Checkpoints every 200 steps (the last two kept, of the global state
    on a mesh); a run resumed from the middle one writes the uninterrupted
    run's final checkpoint bit for bit, and counts its MLUPS over the steps
    it ran."""
    kw, device, backend = route
    cfg = SimConfig(**RUN, **kw)
    full = simulate(cfg, _opts(tmp_path / "full"), device=device)
    assert full.backend == backend and full.steps == 600
    assert _files(tmp_path / "full" / "ckpt") == ["ckpt_00000400.npz", "ckpt_00000600.npz"]
    counted = []
    monkeypatch.setattr(sim, "mlups", lambda nx, ny, steps, s: counted.append(steps) or 1.0)
    resumed = simulate(cfg, _opts(tmp_path / "resumed", resume_from=str(
        tmp_path / "full" / "ckpt" / "ckpt_00000400.npz")), device=device)
    assert resumed.steps == 600 and counted == [200]
    assert _files(tmp_path / "resumed" / "ckpt") == ["ckpt_00000600.npz"]
    f, lid, step = _final(tmp_path / "resumed")
    f_want, lid_want, _ = _final(tmp_path / "full")
    assert step == 600 and f.shape == (9, 32, 32)
    np.testing.assert_array_equal(f, f_want)
    np.testing.assert_array_equal(lid, lid_want)
    metrics = (tmp_path / "resumed" / "ldc_metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in metrics] == [500, 600, 600]


def test_sharded_simulate_gathers_the_state_only_for_a_save(tmp_path, monkeypatch):
    """On a mesh the global state is gathered at the report intervals where
    a checkpoint is written (every 200 of 600 steps at intervals of 100),
    not at the others."""
    kw, device, _ = ROUTES["sharded"]
    gathered = []
    real = sim._global_state
    monkeypatch.setattr(sim, "_global_state",
                        lambda state, dev: gathered.append(state) or real(state, dev))
    simulate(SimConfig(**RUN, **kw), _opts(tmp_path), device=device)
    assert len(gathered) == 3
    assert _files(tmp_path / "ckpt") == ["ckpt_00000400.npz", "ckpt_00000600.npz"]


def test_checkpointer_due_follows_its_save_clock(tmp_path, fields):
    cfg, state, rho, u = fields
    ck = Checkpointer(str(tmp_path), cfg, every=100, start_step=500, device="cpu")
    assert [ck.due(s) for s in (550, 600)] == [False, True]
    ck(600, state, rho, u)
    assert [ck.due(s) for s in (650, 700)] == [False, True]
    assert Checkpointer(str(tmp_path), cfg, device="cpu").due(1)


def test_resume_from_a_jax_checkpoint_continues_the_jax_run(tmp_path):
    """The port resumes the JAX package's checkpoint at step 200 of a
    float64 run and ends where the JAX run ends (1e-12)."""
    kw = dict(RUN, precision="float64", max_steps=400)
    j_simulate(JConfig(**kw), JOptions(out_dir=str(tmp_path / "jax"), verbose=False,
                                       backend="jit", checkpoint_every=200))
    simulate(SimConfig(**kw), _opts(tmp_path / "port", resume_from=str(
        tmp_path / "jax" / "ckpt" / "ckpt_00000200.npz")), device="cpu")
    f, lid, _ = _final(tmp_path / "port", 400)
    f_want, lid_want, _ = _final(tmp_path / "jax", 400)
    np.testing.assert_allclose(f, f_want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lid, lid_want, rtol=0, atol=1e-12)


def _poisoned(monkeypatch, calls_to_poison):
    """Route as ``simulate`` does, but turn the state to NaN after the
    runner calls numbered in ``calls_to_poison`` (a transient blow-up)."""
    real = SELECT
    calls = {"n": 0}

    def select(cfg, backend, device):
        routed = real(cfg, backend, device)

        def make_runner(n):
            run = routed.make_runner(n)

            def poisoned(state):
                out = run(state)
                calls["n"] += 1
                if calls["n"] in calls_to_poison:
                    out = engine.State(out.f * float("nan"), out.rho_lid)
                return out

            return poisoned

        return routed._replace(make_runner=make_runner)

    monkeypatch.setattr(sim, "_select_backend", select)


def test_blow_up_restores_the_last_good_checkpoint_once(tmp_path, monkeypatch, capsys):
    """A blow-up at step 400 restores step 200's checkpoint once and
    replays: the run ends on the uninterrupted run's state.  A second
    blow-up raises ``FloatingPointError``."""
    cfg = SimConfig(**RUN)
    simulate(cfg, _opts(tmp_path / "clean"), device="cpu")
    _poisoned(monkeypatch, {4})
    out = simulate(cfg, SimOptions(out_dir=str(tmp_path / "restored"), checkpoint_every=200),
                   device="cpu")
    assert out.steps == 600
    assert "blow-up at step 400; restoring" in capsys.readouterr().out
    f, lid, _ = _final(tmp_path / "restored")
    f_want, lid_want, _ = _final(tmp_path / "clean")
    np.testing.assert_array_equal(f, f_want)
    np.testing.assert_array_equal(lid, lid_want)

    _poisoned(monkeypatch, {4, 7})
    with pytest.raises(FloatingPointError, match="diverged at step 500"):
        simulate(cfg, _opts(tmp_path / "twice"), device="cpu")
