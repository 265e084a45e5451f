"""The JAX package's own initial weights of ``cnn_nine`` as a file the port
reads, and ``scripts/torch_train_full.py``'s two ways to train as JAX's
record was trained: from those weights (``--init-from``) and at the TPU's
convolution precision (``--tpu-precision``).

``INIT`` is flax's ``model.init(jax.random.PRNGKey(0), x[:1], aux[:1])``
of ``cnn_nine``, drawn eagerly as JAX's ``train`` draws it (the shapes do
not depend on the grid, so 192^2 inputs serve) and written with
``flax.serialization.to_bytes``; ``ml.flax_msgpack.load`` reads it.  The x
and y halves of JAX's record start from this one draw.  It equals the
TPU's draw only to the last bits of ``erfinv``, which each backend
evaluates in its own way.  Remade on the CPU with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ml_jax_init.py write

``... init-losses`` writes ``INIT_LOSSES``: the loss of flax's draws
``PRNGKey(0..7)`` and the port's seeds 0-7 on the kept held-out truth
downsampled to 192^2, at initialisation and over three of the full run's
epochs' worth of Adam steps (about 15 minutes); and
``... correlations`` writes ``CORRELATIONS``: per layer, how JAX's
trained halves correlate with ``INIT``, with the draw of the same key under
the older, non-partitionable threefry and with the port's seed-0 draw, and
how far each half moved from ``INIT``.  The committed ``INIT_LOSSES`` and
``CORRELATIONS`` are records of the port's former draw (a
``torch.Generator``'s sample of the same law); since the port draws what
flax draws (``ml.flax_init``), its seeds give flax's keys' numbers and a
rerun of either command writes them twice.  ``... late-history`` writes
``LATE_HISTORY``: the late validation MSE of the runs from ``INIT`` and
of the port's own draws beside JAX's history (``late_history``).

Tolerances: the committed file against a fresh draw through XLA's cheapest
compile within 2.1e-7 of each layer's largest value (that compile's
rounding against the eager draw, as ``test_initial_weights_have_flaxs_distribution``
states); the script's run from the file against JAX's ``train`` from the
same parameters as ``test_384_preset_train_matches_jax_train`` holds
them, the losses to rel 1e-4."""

import dataclasses
import functools
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

from latticeboltzmannsimulations_torch.ml import datagen, flax_msgpack, models, predict, train  # noqa: E402
from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen  # noqa: E402
from latticeboltzmannsimulations_tpu.ml import models as jmodels  # noqa: E402
from latticeboltzmannsimulations_tpu.ml import train as jtrain  # noqa: E402

import torch_pipeline_cards  # noqa: E402
import torch_train_full  # noqa: E402

MODEL = "cnn_nine"
INIT = torch_pipeline_cards.JAX_INIT
INIT_LOSSES = os.path.join(os.path.dirname(INIT), "init_losses.json")
CORRELATIONS = os.path.join(os.path.dirname(INIT), "init_correlations.json")
TRUTH = REPO / "docs" / "artifacts" / "torch" / "ml_full" / "held_out_truth.npz"
JAX_TRAINED = REPO / "docs" / "artifacts" / "ml_full" / MODEL
DRAW_TOL = 2.1e-7          # of a layer's largest value
SEEDS = range(8)


def _example():
    """Zero inputs at the smallest grid of ``MODEL``'s stride pyramid."""
    sp = jmodels.stride_product(jmodels.PRESETS[MODEL])
    return jnp.zeros((1, sp, sp, 10), jnp.float32), jnp.zeros((1, sp, sp, 2), jnp.float32)


def draw(seed: int = 0, cheap: bool = False) -> dict:
    """flax's ``init`` of ``MODEL`` from ``PRNGKey(seed)``: eagerly, as JAX's
    ``train`` draws it, or through XLA's cheapest compile."""
    init = jmodels.make_model(MODEL).init
    if cheap:
        init = _cheap_init()
    return jax.device_get(init(jax.random.PRNGKey(seed), *_example())["params"])


@functools.lru_cache(maxsize=1)
def _cheap_init():
    return jax.jit(jmodels.make_model(MODEL).init, compiler_options={
        "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def write(path: str = INIT) -> None:
    import flax.serialization

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(flax.serialization.to_bytes(draw()))


def init_losses(truth_path=TRUTH, seeds=SEEDS, grid: int = 192) -> dict:
    """The x half's loss at initialisation, ``mean((pred - y)^2)`` over the
    truth's held-out Re in the scaled space it trains in (the truth's
    ``MODEL`` scalers), its fields downsampled to ``grid`` as
    ``torch_train_full.downsample`` does: for flax's ``PRNGKey(s)`` and the
    port's seed ``s``, each forward through the port's model on the CPU;
    and each draw's ``first_steps`` on those fields, ``epochs_apart``."""
    truth = torch_train_full.load_truth(truth_path)
    k = truth.feq_initial.shape[-1] // grid
    scalers = truth.scalers[MODEL]
    s_vel = predict._restore_scaler(scalers["vel"])
    res = sorted(truth.held)
    inputs = [predict.build_input(MODEL, re, truth.feq_initial[:, ::k, ::k], scalers,
                                  u_lid=truth.u_lid) for re in res]
    x = torch.from_numpy(np.concatenate([f for f, _ in inputs]))
    aux = torch.from_numpy(np.concatenate([a for _, a in inputs]))
    y = np.stack([s_vel.transform(truth.held[re][:, ::k, ::k])[0] for re in res])

    def loss(sd) -> float:
        model = models.make_model(MODEL)
        model.load_state_dict(sd)
        with torch.no_grad():
            pred = model(x, aux)[..., 0].double().numpy()
        return float(np.mean((pred - y) ** 2))

    flax_sds = [models.state_dict_from_flax(models.PRESETS[MODEL], draw(s, cheap=True))
                for s in seeds]
    port_sds = [models.make_model(MODEL, seed=s).state_dict() for s in seeds]
    flax, port = [loss(sd) for sd in flax_sds], [loss(sd) for sd in port_sds]
    rec = {"model": MODEL, "component": "x", "grid": grid, "re": res,
           "target_mean_square": float(np.mean(y ** 2)), "seeds": list(seeds),
           "flax_prngkey": flax, "port_seed": port,
           "flax_median": float(np.median(flax)), "port_median": float(np.median(port)),
           "port_above_flax": sum(p > f for p, f in zip(port, flax))}
    target = torch.from_numpy(y[..., None].astype(np.float32))
    flax_steps = [first_steps(sd, x, aux, target, STEPS) for sd in flax_sds]
    port_steps = [first_steps(sd, x, aux, target, STEPS) for sd in port_sds]
    rec["first_steps"] = dict(steps=STEPS, epoch_steps=EPOCH_STEPS,
                              flax_prngkey=flax_steps, port_seed=port_steps,
                              **epochs_apart(flax_steps, port_steps))
    return rec


# The full run's steps an epoch: its 500 cavities less the held-out seven,
# less the validation fifth, over the batch (train's split and floor).
EPOCH_STEPS = (len(train.train_val_split(500 - len(torch_train_full.HELD_OUT))[0])
               // models.PRESETS[MODEL].batch_size)
STEPS = 3 * EPOCH_STEPS


def first_steps(sd, x, aux, y, steps: int) -> list:
    """The training loss at each of the first ``steps`` steps of ``MODEL``
    from the state dict ``sd``, train_full's recipe (Adam, lr 1e-3) on the
    whole of ``x`` each step, in the order ``train`` reads it (each step's
    loss before its update)."""
    model = models.make_model(MODEL)
    model.load_state_dict(sd)
    preset = dataclasses.replace(models.PRESETS[MODEL], optimizer="adam")
    opt = train.Optimizer(preset, model.parameters(), 1e-3)
    out = []
    for _ in range(steps):
        out.append(float(train.loss_and_grads([model], x, aux, y)))
        opt.step()
    return out


def epochs_apart(flax_steps: list, port_steps: list) -> dict:
    """Per epoch of ``EPOCH_STEPS`` steps: each draw's mean loss, the two
    sides' medians, how many of the port's seeds read above flax's key of
    the same number, and the two-sided Mann-Whitney p of the two sides."""
    from scipy.stats import mannwhitneyu

    out = []
    for e in range(len(flax_steps[0]) // EPOCH_STEPS):
        part = slice(e * EPOCH_STEPS, (e + 1) * EPOCH_STEPS)
        f = [float(np.mean(s[part])) for s in flax_steps]
        p = [float(np.mean(s[part])) for s in port_steps]
        out.append({"epoch": e + 1, "flax": f, "port": p, "flax_median": float(np.median(f)),
                    "port_median": float(np.median(p)),
                    "port_above_flax": sum(b > a for a, b in zip(f, p)),
                    "mann_whitney_p": float(mannwhitneyu(p, f, alternative="two-sided").pvalue)})
    return {"epochs": out}


def correlations() -> dict:
    """Per layer of JAX's trained ``MODEL`` halves: the correlation of its
    kernel with ``INIT``'s, with the eager draw of ``PRNGKey(0)`` under the
    non-partitionable threefry, and with the port's seed-0 draw (carried
    into flax's layout); and the trained kernel's distance from ``INIT``'s
    over ``INIT``'s norm."""
    def corr(a, b):
        return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])

    init = flax_msgpack.load(INIT)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        unpartitioned = draw()
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    port = models.make_model(MODEL, seed=0).state_dict()
    out = {}
    for c in "xy":
        trained = flax_msgpack.load(JAX_TRAINED / f"{MODEL}_{c}.msgpack")
        port_trained = models.state_dict_from_flax(models.PRESETS[MODEL], trained)
        out[c] = {layer: {
            "n": int(leaf["kernel"].size),
            "init": corr(leaf["kernel"], trained[layer]["kernel"]),
            "unpartitioned": corr(unpartitioned[layer]["kernel"], trained[layer]["kernel"]),
            "port_seed0": corr(port[f"{layer}.weight"], port_trained[f"{layer}.weight"]),
            "moved": float(np.linalg.norm(trained[layer]["kernel"] - leaf["kernel"])
                           / np.linalg.norm(leaf["kernel"]))} for layer, leaf in init.items()}
    return out


@pytest.fixture(scope="module")
def committed():
    return flax_msgpack.load(INIT)


def test_committed_init_is_flaxs_prngkey0_draw(committed):
    """The committed file against a fresh draw of the JAX package's
    ``cnn_nine`` from ``PRNGKey(0)``, layer by layer."""
    fresh = draw(cheap=True)
    assert set(committed) == set(fresh)
    for layer, leaf in fresh.items():
        assert set(committed[layer]) == {"kernel", "bias"}
        for p, want in leaf.items():
            got = committed[layer][p]
            assert got.dtype == np.float32 and got.shape == want.shape, (layer, p)
            scale = float(np.abs(want).max()) or 1.0
            assert float(np.abs(got - want).max()) <= DRAW_TOL * scale, (layer, p)
    models.make_model(MODEL).load_state_dict(
        models.state_dict_from_flax(models.PRESETS[MODEL], committed))


def test_committed_init_is_where_jaxs_record_started(committed):
    """JAX's trained halves of ``cnn_nine`` still carry their start: every
    layer's kernel correlates with the committed draw's (read: 0.64-0.998,
    the x half; 0.0002-0.12 in magnitude for the draw of the same key under
    the older, non-partitionable threefry)."""
    for c in "xy":
        trained = flax_msgpack.load(JAX_TRAINED / f"{MODEL}_{c}.msgpack")
        for layer, leaf in committed.items():
            r = np.corrcoef(leaf["kernel"].ravel(), trained[layer]["kernel"].ravel())[0, 1]
            assert r > 0.5, (c, layer, r)


def _dataset(n=5, res=192, seed=5, module=datagen):
    """Seeded cavities at Re none of ``HELD_OUT`` holds: 4 train, 1 validates."""
    rng = np.random.default_rng(seed)
    return module.DatasetArrays(
        re_range=np.linspace(100.0, 2000.0, n),
        feq_initial=rng.uniform(0.0, 0.5, (9, res, res)).astype(np.float32),
        f_final=np.zeros((n, 9, res, res), np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, res, res))).astype(np.float32),
        failed=None)


def _run_script(tmp_path, monkeypatch, *flags, held=False):
    """``torch_train_full.py`` on ``_dataset`` (its last cavity at a held-out
    Re where ``held``) for one epoch of two steps (``train``'s batch cut to
    2) of ``MODEL``'s x half on the CPU; its summary entry and output
    directory."""
    data_dir, out = tmp_path / "data", tmp_path / "out"
    ds = _dataset()
    if held:
        ds.re_range[-1] = torch_train_full.HELD_OUT[1]
    datagen.save_dataset(ds, str(data_dir))
    monkeypatch.setattr(train, "train", functools.partial(train.train, batch_size=2))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch_train_full.main([
            "--models", MODEL, "--components", "x", "--epochs-scale",
            str(1 / models.PRESETS[MODEL].epochs), "--early-preset", "", "--fine-tune-epochs",
            "0", "--data", str(data_dir), "--out", str(out), "--device", "cpu", *flags]) == 0
    finally:
        torch.set_num_threads(threads)
    with open(out / "summary.json") as fh:
        return json.load(fh)["models"][MODEL], out


def test_train_full_from_the_init_file_matches_jax_train(tmp_path, monkeypatch, committed):
    """``--init-from INIT``: the script's losses equal JAX ``train``'s from the
    same parameters on the same data; the summary names the file and sets
    the run's epochs beside JAX's record."""
    entry, out = _run_script(tmp_path, monkeypatch, "--init-from", INIT)
    jdata = jtrain.prepare_inputs(_dataset(module=jdatagen), jmodels.PRESETS[MODEL])
    want = jtrain.train(MODEL, jdata, component="x", epochs=1, batch_size=2,
                        learning_rate=1e-3, optimizer="adam", init_params=committed)
    with open(out / MODEL / f"{MODEL}_x.json") as fh:
        got = json.load(fh)["history"]
    assert got["loss"] == pytest.approx(want.history["loss"], rel=1e-4)
    assert got["val_loss"] == pytest.approx(want.history["val_loss"], rel=1e-4)
    assert entry["init_from"] == os.path.relpath(INIT, REPO)
    assert entry["tpu_precision"] is False
    jax_x = torch_train_full.jax_history(MODEL, "x")
    hist = entry["against_jax_history"]["x"]
    assert hist["first_epochs"] == [
        {"epoch": 1, "loss": got["loss"][0], "jax_loss": jax_x["loss"][0],
         "ratio": got["loss"][0] / jax_x["loss"][0]}]
    late = hist["late_val_mse_median"]
    assert late["epochs"] == 1 and late["port"] == got["val_loss"][0]
    assert late["jax"] == float(np.median(jax_x["val_loss"][-torch_train_full.LATE:]))


def test_train_full_from_the_init_file_starts_fresh_past_a_foreign_checkpoint(
        tmp_path, monkeypatch, committed):
    """A checkpoint that an earlier run of the same recipe from another
    start (the port's seed-1 draw, with seed 0's shuffle) left in the
    output directory, and that ``train`` would resume, is not resumed by
    ``--init-from INIT --snapshots 1``: the run's history is a fresh run's
    from ``INIT``."""
    datagen.save_dataset(_dataset(), str(tmp_path / "data"))
    train_ds, _ = torch_train_full.split_dataset(
        datagen.load_dataset(str(tmp_path / "data")), torch_train_full.HELD_OUT)
    data = train.prepare_inputs(train_ds, models.PRESETS[MODEL], u_lid=0.08)
    init = models.state_dict_from_flax(models.PRESETS[MODEL], committed)
    run = functools.partial(train.train, MODEL, data, component="x", epochs=1, batch_size=2,
                            optimizer="adam", device="cpu")
    ckpt = tmp_path / "out" / MODEL / f"{MODEL}_x.ckpt"
    ckpt.parent.mkdir(parents=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        other = models.make_model(MODEL, seed=1).state_dict()
        foreign = run(init_params=other, checkpoint_path=str(tmp_path / "foreign.ckpt"),
                      checkpoint_every=1).history
        fresh = run(init_params=init).history
        ckpt.write_bytes((tmp_path / "foreign.ckpt").read_bytes())
        assert run(init_params=init, checkpoint_path=str(tmp_path / "foreign.ckpt")
                   ).history == foreign                          # train would resume it
    finally:
        torch.set_num_threads(threads)
    _run_script(tmp_path, monkeypatch, "--init-from", INIT, "--snapshots", "1")
    with open(ckpt.parent / f"{MODEL}_x.json") as fh:
        got = json.load(fh)["history"]
    assert got == fresh and got != foreign and not ckpt.exists()


def _spying(fn, seen: dict, name: str, plain):
    """``fn``, noting in ``seen[name]`` at each call whether the models' ``F``
    is ``plain``."""
    def wrapped(*a, **kw):
        seen.setdefault(name, []).append(models.F is plain)
        return fn(*a, **kw)
    return wrapped


def test_train_full_tpu_precision_wraps_the_run_and_restores(tmp_path, monkeypatch):
    """``--tpu-precision``: the training and the held-out evaluation run
    with the models' ``F`` swapped for the TPU's convolutions, and ``F`` is
    the plain one again after the run."""
    plain, seen = models.F, {}
    monkeypatch.setattr(train, "train", _spying(train.train, seen, "train", plain))
    monkeypatch.setattr(torch_train_full, "evaluate",
                        _spying(torch_train_full.evaluate, seen, "evaluate", plain))
    entry, _ = _run_script(tmp_path, monkeypatch, "--tpu-precision", held=True)
    assert models.F is plain
    assert seen == {"train": [False], "evaluate": [False]}
    assert entry["tpu_precision"] is True and entry["init_from"] is None
    assert [r["re"] for r in entry["held_out_eval"]] == [torch_train_full.HELD_OUT[1]]


# ``late-history``: late validation MSE of runs of ``MODEL``'s x half beside
# JAX's record of it, and what the snapshots' R^2(ux) at ``MISS_RE`` says of
# a late epoch (``LATE_HISTORY``).
JAX_X = JAX_TRAINED / f"{MODEL}_x.json"
MISS_RE, MISS_R2 = 500.0, 0.999
SNAPSHOTS = tuple(range(300, 351, 10))     # the epochs --snapshots 50 keeps
WINDOW = 50          # the last epochs the rank test and the spike count read
SPIKE = 1e-5         # a validation MSE above this counts as a spike
TORCH_ART = REPO / "docs" / "artifacts" / "torch"
LATE_HISTORY = TORCH_ART / "ml_full" / "late_history.json"


def late_runs() -> dict:
    """The runs ``LATE_HISTORY`` reads, name -> (weight sidecar, summary
    with snapshots or None): the two from ``INIT`` and the port's own
    draws at seeds 0 and 1."""
    full, cards = TORCH_ART / "ml_full", TORCH_ART / "pipeline_cards"
    runs = {job: (full / job / f"{MODEL}_x.json", cards / "train" / f"{job}.x" / "summary.json")
            for job in ("cnn_nine_jax0", "cnn_nine_jax0_tpu")}
    runs[MODEL] = (full / MODEL / f"{MODEL}_x.json", None)                # seed 0
    runs["cnn_nine_s1"] = (full / "cnn_nine_seed1" / MODEL / f"{MODEL}_x.json",
                           full / "cnn_nine_seed1" / "summary.json")
    return runs


def _val_loss(sidecar) -> list:
    with open(sidecar) as fh:
        return json.load(fh)["history"]["val_loss"]


def late_readings(val: list) -> dict:
    """``torch_train_full.late`` of a validation-MSE history, its value at
    ``SNAPSHOTS`` and its spikes among the last ``WINDOW`` epochs."""
    v = np.asarray(val, np.float64)
    return dict(torch_train_full.late(val),
                at={e: float(v[e - 1]) for e in SNAPSHOTS if e <= len(v)},
                spikes=int((v[-WINDOW:] > SPIKE).sum()))


def separation(summaries: list) -> dict:
    """The snapshots' (validation MSE, R^2(ux) at ``MISS_RE``) pairs and where
    they part: the largest validation MSE that meets ``MISS_R2``, the
    smallest that misses it."""
    pairs = []
    for path in summaries:
        with open(path) as fh:
            for snap in json.load(fh)["models"][MODEL].get("snapshots", []):
                (row,) = [r for r in snap["held_out_eval"] if r["re"] == MISS_RE]
                pairs.append((snap["final_val_mse"]["x"], row["r2_ux"]))
    meets = [v for v, r2 in pairs if r2 >= MISS_R2]
    misses = [v for v, r2 in pairs if r2 < MISS_R2]
    return {"pairs": sorted(pairs), "meets_at_most": max(meets, default=None),
            "misses_from": min(misses, default=None),
            "clean": bool(meets and misses and max(meets) < min(misses))}


def late_history(runs: dict) -> dict:
    """``runs`` (as ``late_runs``) beside JAX's history: each run's
    ``late_readings``, its late median over JAX's and the two-sided
    Mann-Whitney p of its last ``WINDOW`` validation MSE against JAX's; and,
    where summaries are given, their ``separation``, against which JAX's
    value at each of ``SNAPSHOTS`` is read (``meets`` at or under the
    largest that met, ``misses`` at or over the smallest that missed,
    ``between`` otherwise): what JAX's own run would likely score there,
    which its record does not hold."""
    from scipy.stats import mannwhitneyu

    jax_val = _val_loss(JAX_X)
    out = {"model": MODEL, "window": WINDOW, "spike": SPIKE, "re": MISS_RE, "r2": MISS_R2,
           "jax": late_readings(jax_val), "runs": {}}
    for name, (sidecar, _) in runs.items():
        val = _val_loss(sidecar)
        rec = late_readings(val)
        rec["median_over_jax"] = rec["median"] / out["jax"]["median"]
        rec["mann_whitney_p"] = float(mannwhitneyu(val[-WINDOW:], jax_val[-WINDOW:],
                                                   alternative="two-sided").pvalue)
        out["runs"][name] = rec
    summaries = [s for _, s in runs.values() if s]
    if summaries:
        sep = out["separation"] = separation(summaries)
        out["jax"]["read"] = {
            e: ("meets" if sep["meets_at_most"] is not None and v <= sep["meets_at_most"] else
                "misses" if sep["misses_from"] is not None and v >= sep["misses_from"] else
                "between") for e, v in out["jax"]["at"].items()}
    return out


def test_late_history_reads_snapshots_against_jaxs_history(tmp_path):
    """``late_history`` on a made-up run: its validation MSE at the snapshot
    epochs and late quantiles, where its snapshots' R^2 part at 0.999,
    JAX's epochs read against that, and the rank test; and the kept record
    of the two runs from JAX's initial weights and of the port's own draws
    at seeds 0 and 1 (``LATE_HISTORY``) is what ``late_history`` makes of
    the kept sidecars and summaries."""
    val = [1e-3] * 250 + [2e-6] * 100
    for e, v in zip(SNAPSHOTS, [4e-6, 1e-6, 2e-5, 3e-6, 5e-6, 1.2e-6]):
        val[e - 1] = v
    (tmp_path / "run.json").write_text(json.dumps({"history": {"loss": val, "val_loss": val}}))
    snaps = [{"final_val_mse": {"x": val[e - 1]},
              "held_out_eval": [{"re": 500.0, "r2_ux": 0.9995 if val[e - 1] <= 1.2e-6 else 0.998}]}
             for e in SNAPSHOTS]
    (tmp_path / "summary.json").write_text(json.dumps({"models": {MODEL: {"snapshots": snaps}}}))
    rec = late_history({"run": (tmp_path / "run.json", tmp_path / "summary.json")})
    run = rec["runs"]["run"]
    assert run["at"] == {e: val[e - 1] for e in SNAPSHOTS}
    assert run["median"] == float(np.median(val[-25:])) and run["epochs"] == 25
    assert run["median_over_jax"] == run["median"] / float(np.median(_val_loss(JAX_X)[-25:]))
    assert run["spikes"] == sum(v > 1e-5 for v in val[-50:]) and 0 <= run["mann_whitney_p"] <= 1
    sep = rec["separation"]
    assert (sep["meets_at_most"], sep["misses_from"], sep["clean"]) == (1.2e-6, 3e-6, True)
    jax_at = rec["jax"]["at"]
    assert rec["jax"]["read"] == {e: ("meets" if v <= 1.2e-6 else "misses" if v >= 3e-6 else
                                      "between") for e, v in jax_at.items()}
    again = json.loads(json.dumps(late_history(late_runs())))
    assert again == json.loads(LATE_HISTORY.read_text())


if __name__ == "__main__":
    if sys.argv[1:] == ["write"]:
        write()
        print(f"wrote {INIT}")
    elif sys.argv[1:] in (["init-losses"], ["correlations"], ["late-history"]):
        path, make = {"init-losses": (INIT_LOSSES, init_losses),
                      "correlations": (CORRELATIONS, correlations),
                      "late-history": (LATE_HISTORY, lambda: late_history(late_runs()))
                      }[sys.argv[1]]
        rec = make()
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(json.dumps(rec, indent=1))
    else:
        raise SystemExit("usage: test_torch_ml_jax_init.py "
                         "write | init-losses | correlations | late-history")
