"""The port's training path against the JAX package's on the CPU: the
optimiser layer (``train.Optimizer``, ``lr_schedule``) against optax, and
``train.train`` against JAX ``train`` from the same flax init carried across
by ``models.state_dict_from_flax``; then what the port holds on its own:
resume (of its own checkpoints, and of the JAX package's), data parallelism
over a mesh, weight files, ``fine_tune`` and the loss plot.

Tolerances: the optimiser step and every schedule in float64 to 1e-12 (the
same arithmetic in another framework, its operations ordered differently);
a float32 training run (a few epochs of ``cnn_one`` at 48^2) the loss
history to rel 1e-4 and the parameters to rtol 2e-4, atol 1e-6 (float32
convolutions summed in another order, through a few updates; the JAX
package holds its own data-parallel run to the same); a resumed run, and a
run beside its data-parallel twin on one device, to the bit or to the JAX
test's tolerance as each test says."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latticeboltzmannsimulations_torch.ml import datagen, models, train
from latticeboltzmannsimulations_torch.parallel.mesh import Mesh, make_mesh
from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen
from latticeboltzmannsimulations_tpu.ml import models as jmodels
from latticeboltzmannsimulations_tpu.ml import train as jtrain

PRESET = "cnn_one"
LR = 0.05
STEPS = 20
SCHEDULES = [None, "cosine", "plateau", "inverse", "inverse:0.04"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU training: the test workers
    share the machine's cores, and a pool of one thread per core in each of
    them oversubscribes it (a step then takes tens of times longer)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- the optimiser layer --------------------------------------------------------

def _gradients(seed=11):
    """A start point and a sequence of gradients of a two-leaf tree: some
    entries tiny (RMSprop's linear range, |g| << 3e-4), the global norm
    above and below the clipping norm in turn."""
    rng = np.random.default_rng(seed)
    p0 = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
    seq = []
    for k in range(STEPS):
        g = {name: rng.standard_normal(v.shape) * (3.0 if k % 3 == 0 else 0.2)
             for name, v in p0.items()}
        g["a"][0] *= 1e-6
        seq.append(g)
    return p0, seq


def _optax_run(opt_name, schedule, clip, total, p0, seq):
    preset = dataclasses.replace(jmodels.PRESETS[PRESET], optimizer=opt_name)
    tx = jtrain._optimizer(preset, LR, schedule=schedule, total_steps=total, clip_norm=clip)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    out = []
    for g in seq:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _port_run(opt_name, schedule, clip, total, p0, seq):
    preset = dataclasses.replace(models.PRESETS[PRESET], optimizer=opt_name)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = train.Optimizer(preset, params.values(), LR, schedule=schedule, total_steps=total,
                          clip_norm=clip)
    out = []
    for g in seq:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in params.items()})
    assert opt.count == len(seq)
    return out


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("opt_name, clip", [("rmsprop", None), ("rmsprop", 1.0),
                                            ("adam", None), ("adam", 1.0)])
def test_optimizer_step_matches_optax(opt_name, clip, schedule):
    """Every update of a 20-step gradient sequence, in float64, against the
    JAX package's optax chain (clipping, then RMSprop or Adam at the
    schedule's rate for the count of updates applied)."""
    p0, seq = _gradients()
    want = _optax_run(opt_name, schedule, clip, STEPS, p0, seq)
    got = _port_run(opt_name, schedule, clip, STEPS, p0, seq)
    moved = 0.0
    for w, g in zip(want, got):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12)
            moved = max(moved, float(np.abs(w[k] - p0[k]).max()))
    assert moved > 10 * LR * 1e-3  # the updates are not vanishing


def test_rmsprop_is_optax_not_torch():
    """The first RMSprop update is +-lr*sqrt(10) for large |g| and linear in
    g for tiny |g| (optax), not +-10*lr for every nonzero g (torch)."""
    p = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    opt = train.RMSprop([p], lr=1.0)
    p.grad = torch.tensor([1.0, 1e-6], dtype=torch.float64)
    opt.step()
    got = p.detach()
    assert float(got[0]) == pytest.approx(-1.0 / math.sqrt(0.1 + 1e-8), rel=1e-12)  # ~ -sqrt(10)
    assert float(got[1]) == pytest.approx(-1e-6 / math.sqrt(0.1 * 1e-12 + 1e-8), rel=1e-12)


@pytest.mark.parametrize("schedule, total", [
    ("cosine", 7), ("cosine", 0), ("plateau", 1), ("plateau", 2), ("plateau", 3),
    ("plateau", 40), ("inverse", 5), ("inverse:0.04", 5)])
def test_lr_schedule_matches_optax(schedule, total):
    """The rate at counts 0..2T+3 against the optax schedule the JAX
    package builds, including the plateau totals whose two boundaries
    collide."""
    if schedule == "cosine":
        ref = optax.cosine_decay_schedule(LR, max(1, total), alpha=0.01)
    elif schedule == "plateau":
        ref = optax.piecewise_constant_schedule(
            LR, {int(total * 0.5): 0.2, int(total * 0.8): 0.2})
    else:
        rate = float(schedule.split(":", 1)[1]) if ":" in schedule else 0.02
        ref = lambda step: LR / (1.0 + rate * step)  # noqa: E731 (the JAX package's form)
    lr_at = train.lr_schedule(LR, schedule, total)
    for count in range(2 * total + 4):
        assert lr_at(count) == pytest.approx(float(ref(jnp.asarray(count))), rel=0, abs=1e-15)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        train.lr_schedule(LR, "warmup", 10)
    with pytest.raises(ValueError, match="unknown lr schedule"):
        jtrain._optimizer(jmodels.PRESETS[PRESET], LR, schedule="warmup", total_steps=10)


def test_clip_by_global_norm_is_optax_rule():
    """Below the norm the gradients stay as they are; above it they become
    g / norm * max_norm, with no 1e-6 in the divisor."""
    g = torch.tensor([3.0, 4.0], dtype=torch.float64)
    p = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    p.grad = g.clone()
    train.clip_by_global_norm([p], 5.0 + 1e-12)
    assert torch.equal(p.grad, g)
    p.grad = g.clone()
    train.clip_by_global_norm([p], 1.0)
    assert torch.equal(p.grad, (g / 5.0) * 1.0)


# --- train against JAX train ----------------------------------------------------

def _synthetic(module, n=10, res=48, seed=5):
    rng = np.random.default_rng(seed)
    return module.DatasetArrays(
        re_range=np.linspace(100.0, 2000.0, n),
        feq_initial=rng.uniform(0.0, 0.5, (9, res, res)).astype(np.float32),
        f_final=np.zeros((n, 9, res, res), np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, res, res))).astype(np.float32),
        failed=None)


@pytest.fixture(scope="module")
def data():
    """``prepare_inputs`` of a seeded 10-sample dataset at 48^2 (8 train, 2
    validation), in both packages."""
    preset = models.PRESETS[PRESET]
    return (train.prepare_inputs(_synthetic(datagen), preset),
            jtrain.prepare_inputs(_synthetic(jdatagen), jmodels.PRESETS[PRESET]))


@pytest.fixture(scope="module")
def flax_init(data):
    """The flax initialisation JAX ``train`` draws for seed 0, and the same
    weights as this package's state dict."""
    _, jdata = data
    params = jmodels.make_model(PRESET).init(jax.random.PRNGKey(0),
                                             jnp.asarray(jdata.fnet[:1]))["params"]
    params = jax.device_get(params)
    return params, models.state_dict_from_flax(models.PRESETS[PRESET], params)


@pytest.mark.parametrize("epochs, kw", [
    (3, dict(optimizer="rmsprop")),
    (1, dict(optimizer="adam", schedule="cosine", clip_norm=0.05)),
], ids=["rmsprop", "adam_cosine_clip"])
def test_train_matches_jax_train(data, flax_init, epochs, kw):
    """``cnn_one`` at 48^2, batch 4 (two steps per epoch), from the same
    flax init: RMSprop over 3 epochs; Adam, with a clipping norm below the
    first gradients' (0.075) and the cosine schedule, over 1 epoch.  The
    loss history to rel 1e-4, every parameter to rtol 2e-4, atol 1e-6."""
    port_data, jdata = data
    jparams, sd = flax_init
    common = dict(component="x", epochs=epochs, batch_size=4, learning_rate=1e-3, **kw)
    want = jtrain.train(PRESET, jdata, init_params=jparams, **common)
    got = train.train(PRESET, port_data, init_params=sd, device="cpu", **common)
    assert len(got.history["loss"]) == epochs
    assert got.history["loss"] == pytest.approx(want.history["loss"], rel=1e-4)
    assert got.history["val_loss"] == pytest.approx(want.history["val_loss"], rel=1e-4)
    ref = models.state_dict_from_flax(models.PRESETS[PRESET], jax.device_get(want.params))
    assert set(got.params) == set(ref)
    for name, w in ref.items():
        assert got.params[name].device.type == "cpu"
        a, b = got.params[name].numpy(), w.numpy()
        assert not np.array_equal(a, sd[name].numpy()), name  # every leaf trained
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6, err_msg=name)


def test_train_defaults_to_the_card_and_honours_tf32_only_there(data):
    port_data, _ = data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.train(PRESET, port_data, epochs=1, batch_size=4)
    with pytest.raises(ValueError, match="TF32"):
        train.train(PRESET, port_data, epochs=1, batch_size=4, device="cpu", allow_tf32=True)


# --- resume ---------------------------------------------------------------------

RESUME_KW = dict(component="x", batch_size=4, schedule="inverse", learning_rate=1e-3,
                 device="cpu")


@pytest.mark.parametrize("opt_name", ["rmsprop", "adam"])
def test_resume_equals_the_uninterrupted_run(data, tmp_path, opt_name):
    """A run killed after 2 of 3 epochs and restarted from its checkpoint
    gives the uninterrupted run's history and parameters bit for bit: the
    shuffle trajectory, the optimiser state and the schedule's count
    resume."""
    port_data, _ = data
    kw = dict(RESUME_KW, optimizer=opt_name)
    full = train.train(PRESET, port_data, epochs=3, **kw)
    ckpt = str(tmp_path / "leg.ckpt")
    train.train(PRESET, port_data, epochs=2, checkpoint_path=ckpt, checkpoint_every=1, **kw)
    resumed = train.train(PRESET, port_data, epochs=3, checkpoint_path=ckpt,
                          checkpoint_every=1, **kw)
    assert resumed.history == full.history
    for name, w in full.params.items():
        assert torch.equal(resumed.params[name], w), name
    with open(ckpt, "rb") as fh:  # the header the JAX package writes
        hlen = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(hlen))
    assert header["epoch"] == 3 and header["history"] == full.history
    assert header["recipe"]["optimizer"] == opt_name and header["recipe"]["epochs"] is None


def test_foreign_recipe_or_smaller_budget_starts_fresh(data, tmp_path, capsys):
    """A completed run's checkpoint is not resumed by another recipe, nor by
    a budget below its progress: the new run trains all its epochs."""
    port_data, _ = data
    ckpt = str(tmp_path / "leg.ckpt")
    kw = dict(component="x", batch_size=4, checkpoint_path=ckpt, checkpoint_every=1,
              device="cpu")
    train.train(PRESET, port_data, epochs=1, optimizer="rmsprop", learning_rate=1e-3, **kw)
    fresh = train.train(PRESET, port_data, epochs=2, optimizer="adam", learning_rate=1e-4,
                        **kw)
    assert len(fresh.history["loss"]) == 2
    smaller = train.train(PRESET, port_data, epochs=1, optimizer="adam", learning_rate=1e-4,
                          **kw)
    assert len(smaller.history["loss"]) == 1
    assert capsys.readouterr().out.count("starting fresh") == 2


@pytest.mark.parametrize("kw", [
    dict(optimizer="rmsprop", schedule="inverse"),
    dict(optimizer="adam", clip_norm=0.05),
    dict(optimizer="rmsprop"),
], ids=["rmsprop_inverse", "adam_clip", "rmsprop_constant"])
def test_jax_checkpoint_resumes_as_the_jax_run_continues(data, tmp_path, kw):
    """JAX ``train`` writes a checkpoint after 1 epoch; JAX and the port each
    resume it for 2 more.  The port carries the flax parameters, optax's
    moments (RMSprop ``nu``; Adam ``mu``, ``nu`` and ``count``, under the
    clipping's state) and the schedule's count across, so the two
    continuations agree to ``test_train_matches_jax_train``'s tolerances,
    and the port's next checkpoint is its own.  The three count sources:
    the schedule's, Adam's, and none (a constant RMSprop rate)."""
    port_data, jdata = data
    common = dict(component="x", batch_size=4, learning_rate=1e-3, checkpoint_every=1, **kw)
    jax_ckpt, port_ckpt = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jtrain.train(PRESET, jdata, epochs=1, checkpoint_path=jax_ckpt, **common)
    with open(jax_ckpt, "rb") as fh:
        blob = fh.read()
    assert not blob[8 + int.from_bytes(blob[:8], "little"):].startswith(b"PK")
    with open(port_ckpt, "wb") as fh:
        fh.write(blob)
    want = jtrain.train(PRESET, jdata, epochs=3, checkpoint_path=jax_ckpt, **common)
    got = train.train(PRESET, port_data, epochs=3, checkpoint_path=port_ckpt,
                      device="cpu", **common)
    assert len(got.history["loss"]) == 3
    assert got.history["loss"][0] == want.history["loss"][0]  # from the header
    assert got.history["loss"] == pytest.approx(want.history["loss"], rel=1e-4)
    assert got.history["val_loss"] == pytest.approx(want.history["val_loss"], rel=1e-4)
    ref = models.state_dict_from_flax(models.PRESETS[PRESET], jax.device_get(want.params))
    for name, w in ref.items():
        np.testing.assert_allclose(got.params[name].numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=name)
    with open(port_ckpt, "rb") as fh:
        hlen = int.from_bytes(fh.read(8), "little")
        assert json.loads(fh.read(hlen))["epoch"] == 3
        assert fh.read(4) == b"PK\x03\x04"


def test_jax_checkpoint_of_another_recipe_is_refused(data, tmp_path, capsys):
    """A JAX checkpoint resumes only under its own recipe, as in JAX: another
    learning rate starts fresh."""
    port_data, jdata = data
    ckpt = str(tmp_path / "jax.ckpt")
    common = dict(component="x", batch_size=4, checkpoint_path=ckpt, checkpoint_every=1)
    jtrain.train(PRESET, jdata, epochs=1, learning_rate=1e-3, **common)
    capsys.readouterr()
    fresh = train.train(PRESET, port_data, epochs=1, learning_rate=1e-4, device="cpu",
                        **common)
    assert "starting fresh" in capsys.readouterr().out
    assert len(fresh.history["loss"]) == 1


def test_recipe_is_the_jax_recipe(data):
    port_data, jdata = data
    preset = models.PRESETS[PRESET]
    got = train._recipe(PRESET, preset, port_data, "y", 7, 4, 1e-3, 3, "cosine", 0.5,
                        "glorot_uniform")
    assert got == {"preset": PRESET, "component": "y", "batch_size": 4, "lr": 1e-3,
                   "seed": 3, "optimizer": "rmsprop", "schedule": "cosine",
                   "clip_norm": 0.5, "epochs": 7, "data_n": 10,
                   "data_shape": [10, 48, 48, 10],
                   "data_sig": float(np.abs(np.asarray(
                       jdata.fnet[::1, 24, 24, :], np.float64)).sum()),
                   "kernel_init": "glorot_uniform"}
    assert "kernel_init" not in train._recipe(PRESET, preset, port_data, "x", 7, 4, 1e-3, 0,
                                              None, None, "lecun_normal")


# --- data parallelism -----------------------------------------------------------

def test_mesh_matches_the_single_device_run(data):
    """Two replicas on a (2, 1) mesh of the CPU, each on half of every
    minibatch, against one device: the JAX test's tolerance (float
    reduction order)."""
    port_data, _ = data
    kw = dict(component="x", epochs=2, batch_size=4, learning_rate=1e-3, optimizer="adam",
              device="cpu")
    single = train.train(PRESET, port_data, **kw)
    dp = train.train(PRESET, port_data, mesh=make_mesh((2, 1), ["cpu"] * 2), **kw)
    assert dp.history["loss"] == pytest.approx(single.history["loss"], rel=1e-4)
    for name, w in single.params.items():
        np.testing.assert_allclose(dp.params[name].numpy(), w.numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=name)


def test_mesh_refuses_an_indivisible_batch_and_a_mesh_across_processes(data):
    port_data, _ = data
    with pytest.raises(ValueError, match="divide"):
        train.train(PRESET, port_data, epochs=1, batch_size=3,
                    mesh=make_mesh((2, 1), ["cpu"] * 2))
    spanning = Mesh((2, 1), ((CPU,), (CPU,)), ranks=((0,), (1,)), rank=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train.train(PRESET, port_data, epochs=1, batch_size=4, mesh=spanning)


def test_loss_and_grads_over_replicas_is_the_batch_gradient():
    """The mean of the replicas' gradients, each over its half of the
    batch, is the gradient of the whole batch's mean loss."""
    preset = models.PRESETS[PRESET]
    rng = np.random.default_rng(2)
    xb = torch.from_numpy(rng.standard_normal((4, 48, 48, 10)).astype(np.float32))
    yb = torch.from_numpy(rng.standard_normal((4, 48, 48, 1)).astype(np.float32))
    one = models.CavityCNN(preset, seed=1)
    two = [models.CavityCNN(preset, seed=1) for _ in range(2)]
    loss1 = train.loss_and_grads([one], xb, None, yb)
    loss2 = train.loss_and_grads(two, xb, None, yb)
    assert float(loss2) == pytest.approx(float(loss1), rel=1e-6)
    assert two[1].enc0.weight.grad is not None
    for p, q in zip(one.parameters(), two[0].parameters()):  # float32 sums, reordered
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-4,
                                   atol=1e-5 * float(p.grad.abs().max()))


# --- weights, fine_tune, plot ---------------------------------------------------

@pytest.fixture(scope="module")
def short_run(data):
    port_data, _ = data
    return train.train(PRESET, port_data, component="y", epochs=1, batch_size=4,
                       device="cpu")


def test_save_and_load_weights_round_trip(short_run, data, tmp_path):
    port_data, _ = data
    path = train.save_weights(short_run, str(tmp_path), scalers=port_data.scalers)
    assert os.path.basename(path) == f"{PRESET}_y.pt"
    params, meta = train.load_weights(PRESET, "y", str(tmp_path))
    assert set(params) == set(short_run.params)
    for name, w in short_run.params.items():
        assert torch.equal(params[name], w), name
    assert meta == {"preset": PRESET, "component": "y", "history": short_run.history,
                    "scalers": port_data.scalers}
    os.replace(path, tmp_path / "cnn_two_y.pt")  # another preset's layers
    with pytest.raises(RuntimeError, match="state_dict"):
        train.load_weights("cnn_two", "y", str(tmp_path))


def test_fine_tune_is_train_from_the_weights_at_a_lower_rate(short_run, data):
    port_data, _ = data
    kw = dict(component="y", epochs=1, batch_size=4, device="cpu")
    tuned = train.fine_tune(PRESET, port_data, short_run.params, **kw)
    direct = train.train(PRESET, port_data, init_params=short_run.params,
                         learning_rate=1e-4, **kw)
    assert tuned.history == direct.history
    for name, w in direct.params.items():
        assert torch.equal(tuned.params[name], w), name


def test_plot_history_writes_a_png(short_run, tmp_path):
    path = train.plot_history({"loss": [1.0, 0.5, 0.25], "val_loss": [1.1, 0.6, 0.3]},
                              str(tmp_path / "plots" / "history.png"))
    with open(path, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
