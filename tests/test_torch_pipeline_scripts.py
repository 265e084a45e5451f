"""The last surrogate scripts that read the whole dataset, against the JAX
package's on the CPU: ``scripts/torch_resume_eight_y.py``,
``torch_train_eight_faithful.py``, ``torch_train_early_presets.py``,
``torch_diagnose_cnn_eight.py``, ``torch_loss_floor_report.py`` and
``torch_render_early_compare.py`` each run beside its JAX script on the same
seeded dataset (a few cavities at 192^2, 96^2 where downsampled), JAX's
flax initial weights carried across; the determinism check against JAX's
on the same records; ``torch_train_full.py``'s evaluation from saved halves
and its ``--data-parallel``; and the pipeline runner's pair layout.

Tolerances: the training runs' losses, validation MSEs and held-out numbers
to rel 1e-3, abs 1e-3, as ``test_torch_train_scripts.py``'s (float32
convolutions summed in another order, carried through two optimiser
updates whose first steps move a weight by about the learning rate whatever
its gradient's size); the rendered relative L2 to 1e-4 (the JAX script's
weights served by both, printed to four decimals); the loss-floor numbers
and the determinism verdicts exactly (the same numpy on the same records);
the evaluation from saved halves exactly (the same weights, read back bit
for bit); ``--data-parallel 2`` against one device to rel 1e-4, abs 1e-5
(the minibatch's mean over two halves in another float order)."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import re
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch.ml import datagen, models
from latticeboltzmannsimulations_torch.ml import train as ptrain
from latticeboltzmannsimulations_tpu.ml import models as jmodels
from latticeboltzmannsimulations_tpu.ml import train as jtrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TOL = 1e-3
PORT_RECORD = os.path.join(ROOT, "docs", "artifacts", "torch", "ml_full", "metadata.json")


def _script(name: str, path: str | None = None):
    """``scripts/<name>.py`` (or the file at ``path``) loaded as its own
    module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", path or os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread for this module's CPU training (the test
    workers share the machine's cores), the JAX scripts' imports found."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.syspath_prepend(SCRIPTS)
    yield
    torch.set_num_threads(before)


def _from_jax_init(train_fn, **fixed):
    """``train`` of the port whose initial weights, where none are given,
    are the flax ones JAX ``train`` draws for the same seed, data and
    initialiser; ``fixed`` overrides its arguments (the epochs)."""
    def run(preset_name, data, *args, init_params=None, seed=0, **kw):
        kw.update(fixed)
        if init_params is None:
            example = (data.fnet[:1],) if data.aux is None else (data.fnet[:1], data.aux[:1])
            flax = jmodels.make_model(preset_name, kernel_init=kw.get(
                "kernel_init", "lecun_normal")).init(
                jax.random.PRNGKey(seed), *map(jnp.asarray, example))["params"]
            init_params = models.state_dict_from_flax(models.PRESETS[preset_name],
                                                      jax.device_get(flax))
        return train_fn(preset_name, data, *args, init_params=init_params, seed=seed, **kw)
    return run


# Three of train_full's held-out Re (500, 3200 and 5000; the latter two in
# the Ghia tables) among ten cavities; Re 5000 is where the early presets
# and the diagnosis evaluate.  RES_PLAIN holds out Re 500, 1500 and 2500,
# none in the Ghia tables: the evaluation of both halves draws no
# dashboards there (the Ghia numbers are test_torch_train_scripts.py's).
RES = (100.0, 300.0, 500.0, 700.0, 900.0, 1100.0, 1300.0, 1700.0, 3200.0, 5000.0)
RES_PLAIN = (100.0, 300.0, 500.0, 700.0, 900.0, 1100.0, 1300.0, 1500.0, 1700.0, 2500.0)


def _dataset(grid: int, res=RES, seed: int = 5):
    rng = np.random.default_rng(seed)
    n = len(res)
    return datagen.DatasetArrays(
        re_range=np.array(res),
        feq_initial=rng.uniform(0.0, 0.5, (9, grid, grid)).astype(np.float32),
        f_final=rng.uniform(0.0, 0.5, (n, 9, grid, grid)).astype(np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, grid, grid))).astype(np.float32))


def _tree(tmp_path_factory, res):
    """A tree with a seeded 192^2 dataset at ``data/ml_full``, where the
    JAX scripts whose paths are fixed find it."""
    root = tmp_path_factory.mktemp("root192")
    datagen.save_dataset(_dataset(192, res), str(root / "data" / "ml_full"))
    (root / "data" / "ml_full" / "metadata.json").write_text(json.dumps({"u_lid": 0.08}))
    return root


@pytest.fixture(scope="module")
def root192(tmp_path_factory):
    return _tree(tmp_path_factory, RES)


@pytest.fixture(scope="module")
def plain192(tmp_path_factory):
    return _tree(tmp_path_factory, RES_PLAIN)


def _jax_copy(name: str, root) -> types.ModuleType:
    """The JAX script ``name`` copied into ``root/scripts`` and loaded from
    there: its paths, taken from its own place, then lie under ``root``."""
    dst = root / "scripts" / f"{name}.py"
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(os.path.join(SCRIPTS, f"{name}.py"), dst)
    return _script(name, str(dst))


def _patched_jax_train(monkeypatch, **fixed):
    monkeypatch.setattr(jtrain, "train", functools.partial(jtrain.train, **fixed))


# --- the determinism check ----------------------------------------------------

def _changed(how: str) -> dict:
    """The port's record changed as ``how`` says."""
    meta = json.load(open(PORT_RECORD))
    if how == "steps":
        meta["chunks"][6]["steps"] += 5_000
    elif how == "converged":
        meta["chunks"][0]["converged"] += 1
    elif how == "field":
        meta["u_lid"] = 0.1
    elif how == "missing":
        del meta["chunks"][40]
    return meta


@pytest.mark.parametrize("how, rc", [("copy", 0), ("steps", 1), ("converged", 1), ("field", 1),
                                     ("missing", 1)])
def test_determinism_check_is_the_jax_scripts(how, rc, tmp_path, capsys):
    """A copy of the port's record passes; a changed ``steps``, a changed
    ``converged``, a changed field and a missing chunk each fail, in the
    port's script as in JAX's on the same two files, with the same count
    of chunks agreeing."""
    meta = _changed(how)
    new = tmp_path / "metadata.json"
    new.write_text(json.dumps(meta))
    port, jax_ = _script("torch_check_dataset_determinism"), _script("check_dataset_determinism")
    assert port.main([str(new), PORT_RECORD, "--out", str(tmp_path / "out.json")]) == rc
    out = json.loads((tmp_path / "out.json").read_text())
    capsys.readouterr()
    assert jax_.main(str(new), PORT_RECORD) == rc
    jax_agree = re.search(r"chunks agreeing \(steps\+converged\): (\d+)/(\d+)",
                          capsys.readouterr().out)
    assert (out["agree"], out["compared"]) == tuple(map(int, jax_agree.groups()))
    assert out["deterministic"] == (rc == 0) and out["of"] == 72
    assert len(out["mismatches"]) == (0 if rc == 0 else 1)


def test_determinism_check_of_a_partial_rebuild(tmp_path):
    """A rebuild of chunk Re 520-580 alone, assembled partially (its own
    ``n``, ``re`` and ``max_steps``), is compared on that chunk only and
    says so; a changed ``failed`` count fails it; without
    ``--assemble-partial`` the 71 chunks it lacks fail it."""
    check = _script("torch_check_dataset_determinism")
    record = json.load(open(PORT_RECORD))
    chunk = next(c for c in record["chunks"] if c["re_lo"] == 520.0)
    assert (chunk["steps"], chunk["converged"], chunk["of"]) == (290_000, 7, 7)
    meta = dict(record, n=7, re=[520.0, 580.0], max_steps=290_000, converged_cavities=7,
                chunks=[dict(chunk)])
    out = check.compare(meta, record, partial=True)
    assert (out["compared"], out["agree"], out["of"]) == (1, 1, 72) and out["deterministic"]
    assert out["converged_in_compared"] == {"old": 7, "new": 7}
    assert not check.compare(meta, record)["deterministic"]
    meta["chunks"][0]["failed"] = 1
    assert not check.compare(meta, record, partial=True)["deterministic"]


# --- train_full: evaluation from saved halves, data-parallel ------------------

FULL = ["--early-preset", "", "--fine-tune-epochs", "0"]


@pytest.fixture(scope="module")
def data96(tmp_path_factory):
    root = tmp_path_factory.mktemp("data96")
    datagen.save_dataset(_dataset(96), str(root / "data"))
    return root / "data"


def _model(out) -> dict:
    return json.loads((out / "summary.json").read_text())["models"]


def test_evaluation_from_saved_halves_equals_one_process(data96, tmp_path):
    """``cnn_one``'s x and y trained by two runs (``--components x``, then
    ``y``), their weights put side by side and evaluated by a third
    (``--evaluate-only``), equal one run of both, number for number."""
    tf = _script("torch_train_full")
    tf.figures = lambda: False
    base = ["--models", "cnn_one", "--epochs-scale", "0.004", *FULL, "--data", str(data96),
            "--device", "cpu"]
    for comp in ("x", "y", "x,y"):
        assert tf.main([*base, "--components", comp, "--out", str(tmp_path / comp)]) == 0
    both = tmp_path / "halves" / "cnn_one"
    both.mkdir(parents=True)
    for comp in "xy":
        for ext in (".pt", ".json"):
            shutil.copyfile(tmp_path / comp / "cnn_one" / f"cnn_one_{comp}{ext}",
                            both / f"cnn_one_{comp}{ext}")
    assert tf.main([*base, "--evaluate-only", "--out", str(tmp_path / "halves")]) == 0
    got, want = _model(tmp_path / "halves")["cnn_one"], _model(tmp_path / "x,y")["cnn_one"]
    keep = ("epochs", "final_val_mse", "held_out_eval", "lr", "schedule")
    tf.hold_close({k: got[k] for k in keep}, {k: want[k] for k in keep}, 0.0, 0.0)
    assert got["held_out_eval"][1]["figure"] is None        # Re 3200: the Ghia numbers
    assert got["train_s"] == {} and want["data_parallel"] == 1
    assert _model(tmp_path / "y")["cnn_one"]["held_out_eval"] == []   # no x to predict with


def test_data_parallel_on_a_cpu_mesh_equals_one_device(data96, tmp_path):
    """``--data-parallel 2`` (``ml.train`` over ``make_mesh((2, 1), ["cpu"] *
    2)``) against one device: ``cnn_four`` (batch 20) at 96^2, two epochs
    of both components, to float reduction order."""
    tf = _script("torch_train_full")
    tf.figures = lambda: False
    base = ["--models", "cnn_four", "--epochs-scale", "0.004", *FULL, "--data", str(data96),
            "--device", "cpu"]
    for k in (1, 2):
        assert tf.main([*base, "--data-parallel", str(k), "--out", str(tmp_path / f"k{k}")]) == 0
    one, two = (_model(tmp_path / f"k{k}")["cnn_four"] for k in (1, 2))
    assert two["data_parallel"] == 2 and one["data_parallel"] == 1
    keep = ("epochs", "final_val_mse", "held_out_eval")
    tf.hold_close({k: two[k] for k in keep}, {k: one[k] for k in keep}, 1e-4, 1e-5)


# --- the pipeline runner's pair layout ----------------------------------------

def test_pipeline_runner_puts_the_halves_on_pairs(monkeypatch, tmp_path):
    """``--jobs cnn_nine.x,cnn_nine.y --group 2`` on four cards: the x half
    on cards 0-1 and the y half on 2-3 at once, each with
    ``--data-parallel 2`` and its pair as ``CUDA_VISIBLE_DEVICES``, its
    estimate from the two-card epoch; the evaluation after both, on one
    card."""
    drv = _script("torch_pipeline_cards")
    queue = drv.job_queue("cnn_nine.x,cnn_nine.y", 2)
    assert queue == ["cnn_nine.x", "cnn_nine.y", "cnn_nine.eval"]
    free = [0, 1, 2, 3]
    started, dropped = drv.place(queue, free, set(queue), set(), 2)
    assert started == [("cnn_nine.x", (0, 1)), ("cnn_nine.y", (2, 3))] and not dropped
    assert queue == ["cnn_nine.eval"] and free == []
    assert drv.place(queue, [0], {"cnn_nine.y", "cnn_nine.eval"}, set(), 2) == ([], [])
    assert drv.place(queue, [0, 1], {"cnn_nine.eval"}, set(), 2) == (
        [("cnn_nine.eval", (0,))], [])
    assert drv.job_estimate("cnn_nine.x", 2) == pytest.approx(
        drv.JOB_SETUP_S + 350 * drv.EPOCH_S["cnn_nine@2"])
    assert drv.job_estimate("cnn_nine", 1) == pytest.approx(
        drv.JOB_SETUP_S + 700 * drv.EPOCH_S["cnn_nine"])
    args = types.SimpleNamespace(out="/d", device="cuda")
    argv = drv.job_argv(args, "cnn_nine.x", 2)
    assert argv[argv.index("--components") + 1] == "x"
    assert argv[argv.index("--data-parallel") + 1] == "2"
    assert argv[argv.index("--out") + 1] == os.path.join("/d", "train", "cnn_nine.x")
    ev = drv.job_argv(args, "cnn_nine.eval", 1)
    assert "--evaluate-only" in ev and ev[ev.index("--out") + 1] == os.path.join(
        "/d", "train", "cnn_nine")
    seen = {}

    class Popen:
        def __init__(self, argv, env, **kw):
            seen["env"] = env["CUDA_VISIBLE_DEVICES"]

    monkeypatch.setattr(drv.subprocess, "Popen", Popen)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    drv.Proc("cnn_nine.y", argv, (2, 3), "cuda", str(tmp_path / "log"))
    assert seen["env"] == "6,7"
    # a half after a failed one is dropped; a deadline drops what ends past it
    q = ["cnn_nine.eval"]
    assert drv.place(q, [0], set(), {"cnn_nine.x"}, 2)[1][0][0] == "cnn_nine.eval"
    q = ["cnn_nine.x"]
    assert drv.place(q, [0, 1], set(q), set(), 2, lambda job: False)[1][0][0] == "cnn_nine.x"


def _parser(mod):
    """The parser ``mod.main`` builds, caught as it parses."""
    import argparse

    class Parsed(Exception):
        pass

    seen = {}

    def parse(self, *a, **k):
        seen["parser"] = self
        raise Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(Parsed):
            mod.main()
    return seen["parser"]


@pytest.mark.parametrize("dep", ["cnn_eight.x", "cnn_eight"])
def test_resume_eight_y_waits_for_the_x_weights(dep, tmp_path):
    """``resume_eight_y`` starts only once the job that writes ``cnn_eight``'s
    x weights has ended, the x half or the whole model, and reads those
    weights (not the y ones) from that job's directory."""
    drv = _script("torch_pipeline_cards")
    queue = drv.job_queue(f"resume_eight_y,{dep}", 2)
    started, _ = drv.place(list(queue), [0, 1, 2, 3], set(queue), set(), 2)
    assert [job for job, _ in started] == [dep]
    assert drv.place(["resume_eight_y"], [2], set(), {dep}, 2)[1][0][0] == "resume_eight_y"
    args = types.SimpleNamespace(out=str(tmp_path))
    src = tmp_path / "train" / dep / "cnn_eight"
    src.mkdir(parents=True)
    for fn in ("cnn_eight_x.pt", "cnn_eight_x.json", "cnn_eight_y.pt"):
        (src / fn).write_text(fn)
    assert drv.place(["resume_eight_y"], [2], set(), set(), 2)[0] == [("resume_eight_y", (2,))]
    drv.link_inputs(args, "resume_eight_y")
    got = tmp_path / "train" / "resume_eight_y" / "cnn_eight"
    assert sorted(os.listdir(got)) == ["cnn_eight_x.json", "cnn_eight_x.pt"]


@pytest.mark.parametrize("job", ["resume_eight_y", "eight_faithful", "early_presets",
                                 "diagnose_cnn_eight"])
def test_pipeline_runner_names_the_other_whole_dataset_runs(job):
    """Each of the other scripts' runs is a job of the runner on one card:
    its command line parses in its script, and its estimate is its epochs
    at ``EPOCH_S``."""
    drv = _script("torch_pipeline_cards")
    argv = drv.job_argv(types.SimpleNamespace(out="/d", device="cuda"), job, 1)
    parsed = _parser(_script(os.path.basename(argv[0])[:-3])).parse_args(argv[1:])
    assert (parsed.data, parsed.out, parsed.device) == ("/d", os.path.join("/d", "train", job),
                                                        "cuda")
    assert drv.job_cards(job, 2) == 1
    spec = drv.JOBS[job]
    assert drv.job_estimate(job, 2) == pytest.approx(
        drv.JOB_SETUP_S + sum(n * drv.EPOCH_S[k] for k, n in spec.epochs.items()))


def test_epoch_timing_covers_the_runners_keys():
    """``scripts/torch_train_epochs.py`` times every one-card key of the
    runner's ``EPOCHS`` (at its preset's batch, which two CPU replicas
    split), and an epoch is its steps and one validation forward."""
    drv, epochs = _script("torch_pipeline_cards"), _script("torch_train_epochs")
    assert {k.split("@")[0] for k in drv.EPOCHS} <= set(epochs.MODELS)
    r = epochs.epoch_seconds("cnn_eight_192", ["cpu", "cpu"], reps=1)
    assert (r["preset"], r["grid"], r["batch"], r["cards"], r["steps"]) == (
        "cnn_eight", 192, 20, 2, 394 // 20)
    assert r["epoch_s"] == pytest.approx((r["steps"] * r["step_ms"] + r["val_ms"]) / 1e3,
                                         abs=1e-3)


def test_epoch_timing_holds_two_cards_to_one(monkeypatch):
    """``torch_train_epochs.hold_to_one_card`` over two CPU replicas: the
    same losses and first gradients as one to float reduction order; with
    the replicas left unsynchronised after each step it fails."""
    epochs = _script("torch_train_epochs")
    held = epochs.hold_to_one_card("cnn_eight_192", ["cpu", "cpu"], steps=3)
    assert held["ok"] and len(held["loss_many"]) == 3
    monkeypatch.setattr(ptrain, "_sync_replicas", lambda replicas: None)
    assert not epochs.hold_to_one_card("cnn_eight_192", ["cpu", "cpu"], steps=3)["ok"]


def test_pipeline_runner_trains_halves_then_evaluates(monkeypatch, tmp_path):
    """The runner's training stage on the CPU, a job of ``cnn_four`` (batch
    20) at 96^2 as halves over two slots each (held out: Re 500, 1500 and
    2500, none in the Ghia tables, so nothing is drawn): both halves end
    with 0, the evaluation reads their weights, and the merged record holds
    each half's seconds and its ``--data-parallel``."""
    drv = _script("torch_pipeline_cards")
    monkeypatch.setitem(drv.JOBS, "cnn_four", drv.Job(
        "torch_train_full", ["--models", "cnn_four", *FULL, "--epochs-scale", "0.004"],
        "ml_full", {"cnn_four": 4}, "cnn_four"))
    monkeypatch.setitem(drv.EPOCH_S, "cnn_four", 1.0)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "data"
    datagen.save_dataset(_dataset(96, RES_PLAIN), str(out))
    args = types.SimpleNamespace(out=str(out), jobs="cnn_four.y,cnn_four.x", group=2,
                                 device="cpu", deadline=None)
    records = drv.Records(str(tmp_path / "records"))
    assert drv.train_jobs(args, [0, 0, 0, 0], records, 0.0)
    jobs = records.driver["jobs"]
    assert jobs["cnn_four.x"]["cards"] == [0, 0] and jobs["cnn_four.y"]["cards"] == [0, 0]
    assert jobs["cnn_four.eval"]["started"] >= max(jobs["cnn_four.x"]["started"],
                                                   jobs["cnn_four.y"]["started"])
    assert [p["rc"] for p in records.driver["processes"]] == [0, 0, 0]
    merged = json.loads((tmp_path / "records" / "ml_full" / "summary.json").read_text())
    m = merged["models"]["cnn_four"]
    assert m["epochs"] == {"x": 2, "y": 2} and len(m["held_out_eval"]) == 3
    assert m["data_parallel"] == {"x": 2, "y": 2} and set(m["train_s"]) == {"x", "y"}
    halves = {c: _model(out / "train" / f"cnn_four.{c}")["cnn_four"] for c in "xy"}
    assert m["final_val_mse"] == {c: halves[c]["final_val_mse"][c] for c in "xy"}


class _Ended:
    """A ``Proc`` that has ended with 1 at once (no summary): the runner's
    placement without a training run."""

    def __init__(self, name, argv, card, device, log_path):
        self.name, self.argv, self.card = name, argv, card

    def poll(self):
        return 1

    def row(self) -> dict:
        return {"name": self.name, "card": self.card, "argv": self.argv, "rc": 1,
                "seconds": 0.0}


@pytest.mark.parametrize("deadline", [400.0, 350.0])
def test_a_job_takes_its_own_card_count(deadline, monkeypatch, tmp_path):
    """``--jobs cnn_ten.x,cnn_ten.y,cnn_nine_s1.x@2`` under ``--group 1`` on
    four cards: ``cnn_ten``'s halves take one card each and its evaluation
    one after both, the seed-1 x half of ``cnn_nine`` two (with
    ``--data-parallel 2`` and the two-card epoch's estimate, 379.5 s); the
    deadline holds each job to its own estimate (at 350 s only the seed-1
    half is dropped); ``--group 2`` still gives every model's training two
    cards."""
    drv = _script("torch_pipeline_cards")
    jobs = "cnn_ten.x,cnn_ten.y,cnn_nine_s1.x@2"
    counts = drv.parse_jobs(jobs, 1)
    assert counts == {"cnn_ten.x": 1, "cnn_ten.y": 1, "cnn_nine_s1.x": 2, "cnn_ten.eval": 1}
    assert drv.parse_jobs("cnn_ten.x,cnn_ten.y", 2) == {"cnn_ten.x": 2, "cnn_ten.y": 2,
                                                        "cnn_ten.eval": 1}
    nine, ten = (drv.job_estimate(j, counts) for j in ("cnn_nine_s1.x", "cnn_ten.x"))
    assert nine == pytest.approx(drv.JOB_SETUP_S + 350 * drv.EPOCH_S["cnn_nine@2"])
    assert ten == pytest.approx(drv.JOB_SETUP_S + 200 * drv.EPOCH_S["cnn_ten"])
    assert drv.job_estimate("cnn_ten.x", 2) == pytest.approx(
        drv.JOB_SETUP_S + 200 * drv.EPOCH_S["cnn_ten@2"])
    for bad in ("cnn_ten.eval@2", "resume_eight_y@2", "cnn_ten.x@0", "cnn_ten.x@1,cnn_ten.x@2"):
        with pytest.raises(ValueError):
            drv.parse_jobs(bad, 1)
    queue = drv.job_queue(jobs, 1)
    assert queue == ["cnn_nine_s1.x", "cnn_ten.x", "cnn_ten.y", "cnn_ten.eval"]

    monkeypatch.setattr(drv, "Proc", _Ended)
    args = types.SimpleNamespace(out=str(tmp_path), jobs=jobs, group=1, device="cuda",
                                 deadline=deadline)
    records = drv.Records(str(tmp_path / "records"))
    assert not drv.train_jobs(args, [0, 1, 2, 3], records, drv.time.time())
    got = records.driver["jobs"]
    assert {j: got[j]["n_cards"] for j in got} == counts
    assert got["cnn_nine_s1.x"]["estimate_s"] == round(nine, 1)
    assert got["cnn_ten.eval"]["started"] is False        # its halves failed
    assert "failed" in records.driver["bounds"]["cnn_ten.eval"]["why"]
    argv = {p["name"]: p["argv"] for p in records.driver["processes"]}
    if deadline >= nine:
        assert [got[j]["cards"] for j in queue[:3]] == [[0, 1], [2], [3]]
        s1 = argv["cnn_nine_s1.x"]
        assert s1[s1.index("--data-parallel") + 1] == "2" and s1[s1.index("--seed") + 1] == "1"
    else:
        assert got["cnn_nine_s1.x"]["started"] is False
        assert "ends past the deadline" in records.driver["bounds"]["cnn_nine_s1.x"]["why"]
        assert [got[j]["cards"] for j in queue[1:3]] == [[0], [1]]
    assert "--data-parallel" not in argv["cnn_ten.x"]


def test_a_seeded_job_draws_other_initial_weights_on_the_same_split(data96, tmp_path,
                                                                    monkeypatch):
    """``cnn_nine_s1``'s x half passes ``--seed 1`` (and ``--snapshots 50``) to
    ``torch_train_full.py`` and writes to its own directory; a run at
    ``--seed 1`` (``cnn_three`` at 96^2, one epoch) records its seed, starts
    from other initial weights than seed 0's and trains and validates on
    the same split."""
    drv, tf = _script("torch_pipeline_cards"), _script("torch_train_full")
    tf.figures = lambda: False
    args = types.SimpleNamespace(out="/d", device="cuda")
    argv = drv.job_argv(args, "cnn_nine_s1.x", 2)
    parsed = _parser(tf).parse_args(argv[1:])
    assert (parsed.models, parsed.components, parsed.seed, parsed.snapshots) == (
        "cnn_nine", "x", 1, 50)
    assert parsed.out == os.path.join("/d", "train", "cnn_nine_s1.x") != drv.job_out(
        args, "cnn_nine.x")
    assert drv.JOBS["cnn_nine_s1"].layout != drv.JOBS["cnn_nine"].layout
    inits, splits = [], []
    make, split = ptrain.make_model, ptrain.train_val_split

    def made(*a, **k):
        model = make(*a, **k)
        if "seed" in k:                       # train's draw, not a weights file's template
            inits.append({n: t.clone() for n, t in model.state_dict().items()})
        return model

    monkeypatch.setattr(ptrain, "make_model", made)
    monkeypatch.setattr(ptrain, "train_val_split", lambda *a, **k: splits.append(
        split(*a, **k)) or splits[-1])
    for seed in (0, 1):
        assert tf.main(["--models", "cnn_three", "--components", "x", "--epochs-scale", "0.002",
                        *FULL, "--data", str(data96), "--out", str(tmp_path / f"s{seed}"),
                        "--device", "cpu", "--seed", str(seed)]) == 0
        assert _model(tmp_path / f"s{seed}")["cnn_three"]["seed"] == seed
    assert len(inits) == len(splits) == 2
    assert all(not torch.equal(inits[0][n], inits[1][n]) for n in inits[0] if "weight" in n)
    for a, b in zip(*splits):
        np.testing.assert_array_equal(a, b)


# --- the training scripts against JAX's ---------------------------------------

def _drop(obj, keys=("train_s", "d_train_s")):
    """``obj`` without wall times (each run's own)."""
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def test_resume_eight_y_gives_jax_summary(plain192, tmp_path, monkeypatch):
    """``cnn_eight``'s y half trained (two epochs) and evaluated with the x
    half from disk, through the JAX script and the port's, both reading
    the same x weights (the JAX package's ``.msgpack``): the merged
    summary entry."""
    tf = _script("torch_train_full")
    ds = datagen.load_dataset(str(plain192 / "data" / "ml_full"))
    train_ds, _ = tf.split_dataset(ds, tf.HELD_OUT)
    from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen
    jds = jdatagen.DatasetArrays(re_range=train_ds.re_range, feq_initial=train_ds.feq_initial,
                                 f_final=train_ds.f_final, u_final=train_ds.u_final)
    jdata = jtrain.prepare_inputs(jds, jmodels.PRESETS["cnn_eight"])
    jx = jtrain.train("cnn_eight", jdata, component="x", epochs=2, optimizer="adam")
    jroot = tmp_path / "jax"
    shutil.copytree(plain192 / "data", jroot / "data")
    art = jroot / "docs" / "artifacts" / "ml_full"
    jtrain.save_weights(jx, str(art / "cnn_eight"), scalers=jdata.scalers)
    (art / "summary.json").write_text(json.dumps({"models": {}}))
    port_out = tmp_path / "port"
    shutil.copytree(art / "cnn_eight", port_out / "cnn_eight")

    _patched_jax_train(monkeypatch, epochs=2)
    src = open(os.path.join(SCRIPTS, "resume_eight_y.py")).read()
    # The script's absolute paths (its import paths and its root) rewritten
    # to this checkout's and to jroot, so that nothing outside is read.
    fixed = re.search(r'^root = "(.*)"$', src, flags=re.M).group(1)
    n = 0
    for old, new in ((f'sys.path.insert(0, "{fixed}/scripts")', f"sys.path.insert(0, {SCRIPTS!r})"),
                     (f'sys.path.insert(0, "{fixed}")', f"sys.path.insert(0, {ROOT!r})"),
                     (f'root = "{fixed}"', f"root = {str(jroot)!r}")):
        n += src.count(old)
        src = src.replace(old, new)
    assert n == 3 and f'"{fixed}' not in src            # no literal of the old root left
    monkeypatch.setattr(sys, "path", list(sys.path))
    sys.modules.pop("train_full", None)
    try:
        exec(compile(src, "resume_eight_y.py", "exec"), {"__name__": "resume_eight_y"})
        assert sys.modules["train_full"].__file__ == os.path.join(SCRIPTS, "train_full.py")
    finally:
        sys.modules.pop("train_full", None)
    want = json.loads((art / "summary.json").read_text())["models"]["cnn_eight"]

    port = _script("torch_resume_eight_y")
    monkeypatch.setattr(ptrain, "train", _from_jax_init(ptrain.train, epochs=2))
    assert port.main(["--data", str(plain192 / "data" / "ml_full"), "--out", str(port_out),
                      "--device", "cpu"]) == 0
    got = _model(port_out)["cnn_eight"]
    tf.hold_close(got, want, TOL, TOL)
    assert [r["re"] for r in got["held_out_eval"]] == [500.0, 1500.0, 2500.0]
    assert {c: got["epochs"][c] for c in "xy"} == {"x": 2, "y": 2}
    assert set(got["train_s"]) == {"y"}
    assert "jax_r2_ux" in got["held_out_eval"][0]          # JAX's record beside


def test_train_eight_faithful_gives_jax_summary(plain192, tmp_path, monkeypatch):
    """The faithful recipe (RMSprop, inverse-time decay, batch 20,
    checkpoints) cut to two epochs a component, through the JAX script and
    the port's; a second run of the port's trains nothing (both weights on
    disk) and evaluates the same."""
    jroot = tmp_path / "jax"
    shutil.copytree(plain192 / "data", jroot / "data")
    jmod = _jax_copy("train_eight_faithful", jroot)
    monkeypatch.setattr(jmod, "EPOCHS", 2)
    assert jmod.main() == 0
    want = json.loads((jroot / "docs" / "artifacts" / "ml_full" / "cnn_eight_faithful"
                       / "summary.json").read_text())

    port = _script("torch_train_eight_faithful")
    monkeypatch.setattr(port, "EPOCHS", 2)
    monkeypatch.setattr(ptrain, "train", _from_jax_init(ptrain.train))
    argv = ["--data", str(plain192 / "data" / "ml_full"), "--out", str(tmp_path / "port"),
            "--device", "cpu"]
    assert port.main(argv) == 0
    path = tmp_path / "port" / "cnn_eight_faithful" / "summary.json"
    got = json.loads(path.read_text())
    _script("torch_train_full").hold_close(got, want, TOL, TOL)
    assert got["recipe"]["epochs"] == 2 and set(got["train_s"]) == {"x", "y"}
    assert "jax_x" in got["final_val_mse"]
    assert (tmp_path / "port" / "cnn_eight_faithful" / "cnn_eight_y.ckpt").exists()
    assert port.main(argv) == 0
    again = json.loads(path.read_text())
    assert again["train_s"] == {} and again["held_out_eval"] == got["held_out_eval"]


@pytest.fixture(scope="module")
def early_runs(root192, tmp_path_factory):
    """``train_early_presets`` of ``cnn_two`` (batch 5, max scaling) and
    ``cnn_four`` (batch 20, minmax) on the 96^2 downsample, two epochs, the
    second case with an inverse-time schedule and clipping, through the JAX
    script and the port's."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(SCRIPTS)
    root = tmp_path_factory.mktemp("early")
    data = str(root192 / "data" / "ml_full")
    cases = {"plain": ["--models", "cnn_two,cnn_four"],
             "clipped": ["--models", "cnn_four", "--schedule", "inverse", "--clip-norm", "0.5"]}
    out = {}
    for case, extra in cases.items():
        argv = [*extra, "--epochs", "2", "--seven-384-epochs", "0", "--data", data]
        jmod = _script("train_early_presets")
        mp.setattr(sys, "argv", ["train_early_presets.py", *argv, "--out",
                                 str(root / case / "jax")])
        assert jmod.main() == 0
        port = _script("torch_train_early_presets")
        mp.setattr(ptrain, "train", _from_jax_init(ptrain.train))
        assert port.main([*argv, "--out", str(root / case / "ml_early"), "--device", "cpu"]) == 0
        mp.undo()
        mp.syspath_prepend(SCRIPTS)
        out[case] = {k: json.loads((root / case / d / "summary.json").read_text())
                     for k, d in (("jax", "jax"), ("port", "ml_early"))}
    mp.undo()
    return root, out


@pytest.mark.parametrize("case", ["plain", "clipped"])
def test_train_early_presets_gives_jax_summary(early_runs, case):
    _, out = early_runs
    want, got = out[case]["jax"], out[case]["port"]
    models_run = ["cnn_two_192", "cnn_four_192"] if case == "plain" else ["cnn_four_192"]
    assert sorted(got["models"]) == sorted(want["models"]) == sorted(models_run)
    _script("torch_train_full").hold_close(_drop(got), _drop(want), TOL, TOL)
    rec = got["models"]["cnn_four_192"]
    assert rec["grid"] == 96 and rec["eval_re"] == 5000.0 and rec["device"] == "cpu"
    assert "jax_r2_ux_re5000" in rec                     # ml_early's record beside
    if case == "clipped":
        assert rec["schedule"] == "inverse" and rec["clip_norm"] == 0.5


def test_render_early_compare_gives_jax_numbers(early_runs, root192, tmp_path, capsys):
    """The figures of the JAX early-preset run's weights (``.msgpack``),
    rendered by the JAX script and by the port's: the same relative L2 per
    model, each figure written."""
    root, _ = early_runs
    jroot = tmp_path / "jax"
    shutil.copytree(root192 / "data", jroot / "data")
    for who in ("jax", "port"):
        shutil.copytree(root / "plain" / "jax", tmp_path / who / "early")
    jmod = _jax_copy("render_early_compare", jroot)
    capsys.readouterr()
    saved = sys.argv
    sys.argv = ["render_early_compare.py", "--out", str(tmp_path / "jax" / "early")]
    try:
        assert jmod.main() == 0
    finally:
        sys.argv = saved
    read = re.compile(r"(\S+): relL2\(ux\) (\S+) -> ")
    want = dict(read.findall(capsys.readouterr().out))
    assert _script("torch_render_early_compare").main(
        ["--out", str(tmp_path / "port" / "early"), "--data",
         str(root192 / "data" / "ml_full")]) == 0
    got = dict(read.findall(capsys.readouterr().out))
    assert sorted(got) == sorted(want) == ["cnn_four_192", "cnn_two_192"]
    for entry in want:
        assert abs(float(got[entry]) - float(want[entry])) <= 1e-4, entry
        name = entry.rsplit("_", 1)[0]
        assert (tmp_path / "port" / "early" / entry / f"{name}_predict_re5000.png").exists()


def test_loss_floor_report_gives_jax_verdicts(tmp_path):
    """The loss-floor block of JAX's early-preset record (its histories,
    ``docs/artifacts/ml_early``) through the JAX script and the port's on
    copies of the same files: every model's numbers and verdict equal, and
    beside each the committed JAX record's."""
    src = os.path.join(ROOT, "docs", "artifacts", "ml_early")
    for who in ("jax", "port"):
        dst = tmp_path / who / "ml_early"
        dst.mkdir(parents=True)
        shutil.copyfile(os.path.join(src, "summary.json"), dst / "summary.json")
        for sub in sorted(os.listdir(src)):
            if os.path.isdir(os.path.join(src, sub)):
                (dst / sub).mkdir()
                for fn in os.listdir(os.path.join(src, sub)):
                    if fn.endswith("_x.json"):
                        shutil.copyfile(os.path.join(src, sub, fn), dst / sub / fn)
    assert _script("loss_floor_report").main(str(tmp_path / "jax" / "ml_early")) == 0
    assert _script("torch_loss_floor_report").main(str(tmp_path / "port" / "ml_early")) == 0
    want, got = (json.loads((tmp_path / who / "ml_early" / "summary.json").read_text())
                 ["loss_floor"] for who in ("jax", "port"))
    assert got["criteria"] == want["criteria"]
    assert sorted(got["models"]) == sorted(want["models"]) and len(want["models"]) == 7
    record = json.load(open(os.path.join(src, "summary.json")))["loss_floor"]["models"]
    for key, w in want["models"].items():
        g = got["models"][key]
        assert {k: g[k] for k in w} == w, key
        assert g["jax_at_floor"] == record[key]["at_floor"]
        assert g["d_best_epoch"] == w["best_epoch"] - record[key]["best_epoch"]


def test_diagnose_cnn_eight_gives_jax_summary(root192, tmp_path, monkeypatch):
    """Three of the seven matched runs (``base150``, ``plateau``,
    ``msfront``: the preset, a schedule and a structural variant made with
    ``dataclasses.replace``), two epochs each at 192^2, through the JAX
    script and the port's."""
    argv = ["--epochs", "2", "--only", "base150,plateau,msfront", "--data",
            str(root192 / "data" / "ml_full")]
    jmod = _script("diagnose_cnn_eight")
    monkeypatch.setattr(sys, "argv", ["diagnose_cnn_eight.py", *argv, "--out",
                                      str(tmp_path / "jax")])
    assert jmod.main() == 0
    want = json.loads((tmp_path / "jax" / "summary.json").read_text())
    port = _script("torch_diagnose_cnn_eight")
    monkeypatch.setattr(ptrain, "train", _from_jax_init(ptrain.train))
    assert port.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert [r["tag"] for r in got["runs"]] == ["base150", "plateau", "msfront"]
    _script("torch_train_full").hold_close(_drop(got), _drop(want), TOL, TOL)
    assert models.PRESETS["cnn_eight_ms"].multiscale_front == (2, 4, 8, 12)
    assert "jax_val_mse" in got["runs"][0]


@pytest.mark.parametrize("jax_name, port_name", [
    ("train_early_presets", "torch_train_early_presets"),
    ("diagnose_cnn_eight", "torch_diagnose_cnn_eight")])
def test_command_lines_are_the_jax_scripts(jax_name, port_name):
    """The port's command line is the JAX script's plus ``--device``."""
    def options(mod):
        return {a.option_strings[0]: (a.default, a.type, a.help, a.choices)
                for a in _parser(mod)._actions if a.dest not in ("help", "device")}

    assert options(_script(port_name)) == options(_script(jax_name))


# --- the other whole-dataset runs' four-card job list ---------------------------

LAST_CALL = "diagnose_cnn_eight,eight_faithful,cnn_eight.x,resume_eight_y,early_presets"


class _InProcess:
    """A ``Proc`` that runs its script's ``main`` in this process at once."""

    def __init__(self, name, argv, card, device, log_path):
        self.name, self.argv, self.card = name, argv, card
        self.rc = _script(os.path.basename(argv[0])[:-3]).main(argv[1:])

    def poll(self):
        return self.rc

    def row(self) -> dict:
        return {"name": self.name, "card": self.card, "argv": self.argv, "rc": self.rc,
                "seconds": 0.0}


def test_the_last_calls_job_list_runs_and_merges_on_the_cpu(monkeypatch, tmp_path):
    """The other whole-dataset runs' ``--jobs`` through the runner's training
    stage on the CPU, cut: a seeded 192^2 dataset (held out: Re 500, 3200
    and 5000, where the diagnosis evaluates), every training one epoch, the diagnosis cut to ``base150``
    and the early presets to ``cnn_four`` (the grids and the presets the
    card runs cannot be cut to the CPU's time), no figures drawn; each job
    runs to its end as it is started, so the cards it takes say nothing.
    Every job ends with 0 and
    its summary is merged where the JAX records lie: ``cnn_eight`` with
    both halves in ``ml_full``, the faithful run, the diagnosis and the
    early presets."""
    drv = _script("torch_pipeline_cards")
    train_fn = ptrain.train

    def one_epoch(*args, **kw):
        return train_fn(*args, **dict(kw, epochs=1))

    monkeypatch.setattr(ptrain, "train", one_epoch)
    monkeypatch.setattr(importlib.import_module("torch_train_full"), "figures", lambda: False)
    monkeypatch.setattr(drv, "Proc", _InProcess)
    for job, argv in (("diagnose_cnn_eight", ["--only", "base150"]),
                      ("early_presets", ["--models", "cnn_four", "--seven-384-epochs", "0"])):
        monkeypatch.setitem(drv.JOBS, job, drv.JOBS[job]._replace(argv=argv))
    out = tmp_path / "data"
    datagen.save_dataset(_dataset(192, RES), str(out))
    (out / "metadata.json").write_text(json.dumps({"u_lid": 0.08}))
    args = types.SimpleNamespace(out=str(out), jobs=LAST_CALL, group=1, device="cpu",
                                 deadline=None)
    records = drv.Records(str(tmp_path / "records"))
    assert drv.train_jobs(args, [0, 1, 2, 3], records, 0.0)
    assert sorted(p["name"] for p in records.driver["processes"]) == sorted(LAST_CALL.split(","))
    assert all(p["rc"] == 0 for p in records.driver["processes"])

    def merged(rel):
        return json.loads((tmp_path / "records" / rel / "summary.json").read_text())

    eight = merged("ml_full")["models"]["cnn_eight"]
    assert (eight["epochs"]["x"], eight["epochs"]["y"]) == (1, 1)
    assert len(eight["held_out_eval"]) == 3
    assert "rel_l2" in eight["held_out_eval"][0]
    assert {"x", "y"} <= set(merged("ml_full/cnn_eight_faithful")["final_val_mse"])
    assert [r["tag"] for r in merged("cnn_eight_diag")["runs"]] == ["base150"]
    assert list(merged("ml_early")["models"]) == ["cnn_four_192"]


def test_epoch_timing_of_the_probe_keys_takes_their_precision(monkeypatch):
    """``torch_train_epochs.epoch_seconds`` times the key of the runner's
    ``TPU_PRECISION`` (``cnn_nine_jax0_tpu``'s full-scale epoch) inside
    ``tpu_conv_precision`` and every other key with the plain
    convolutions."""
    drv, epochs = _script("torch_pipeline_cards"), _script("torch_train_epochs")
    assert drv.TPU_PRECISION == ("cnn_nine_tpu",)
    assert epochs.MODELS["cnn_nine"] == epochs.MODELS["cnn_nine_tpu"] == ("cnn_nine", 384)
    seen = {}
    monkeypatch.setattr(epochs, "_epoch_seconds", lambda key, *a: seen.setdefault(
        key, models.F is torch.nn.functional))
    for key in ("cnn_nine", "cnn_nine_tpu"):
        epochs.epoch_seconds(key, ["cpu"])
    assert seen == {"cnn_nine": True, "cnn_nine_tpu": False}
    assert models.F is torch.nn.functional


JAX0_CALL = "cnn_nine_jax0.x@2,cnn_nine_jax0_tpu.x@2"


def test_the_jax_init_jobs_differ_only_in_precision():
    """``cnn_nine_jax0`` and ``cnn_nine_jax0_tpu`` pass ``torch_train_full.py``
    the JAX package's own initial weights (``--init-from JAX_INIT``), seed
    0's shuffle and ``--snapshots 50``; only the second ``--tpu-precision``;
    each writes to its own directory and layout, and its estimate is 350
    epochs of its own two-card key."""
    drv, tf = _script("torch_pipeline_cards"), _script("torch_train_full")
    args = types.SimpleNamespace(out="/d", device="cuda")
    parsed = {}
    for job in ("cnn_nine_jax0", "cnn_nine_jax0_tpu"):
        argv = drv.job_argv(args, f"{job}.x", 2)
        parsed[job] = p = _parser(tf).parse_args(argv[1:])
        assert (p.models, p.components, p.seed, p.snapshots, p.init_from, p.data_parallel,
                p.fine_tune_epochs, p.early_preset) == (
            "cnn_nine", "x", 0, 50, drv.JAX_INIT, 2, 0, "")
        assert p.out == os.path.join("/d", "train", f"{job}.x")
    assert not parsed["cnn_nine_jax0"].tpu_precision and parsed["cnn_nine_jax0_tpu"].tpu_precision
    assert (vars(parsed["cnn_nine_jax0"]) == dict(vars(parsed["cnn_nine_jax0_tpu"]),
                                                  tpu_precision=False,
                                                  out=parsed["cnn_nine_jax0"].out))
    layouts = {spec.layout for spec in drv.JOBS.values()}
    assert len(layouts) == len({spec.layout for job, spec in drv.JOBS.items()
                                if job not in ("cnn_nine_jax0", "cnn_nine_jax0_tpu")}) + 2
    counts = drv.parse_jobs(JAX0_CALL, 1)
    assert counts == {"cnn_nine_jax0.x": 2, "cnn_nine_jax0_tpu.x": 2}
    assert drv.job_estimate("cnn_nine_jax0.x", counts) == pytest.approx(
        drv.JOB_SETUP_S + 350 * drv.EPOCH_S["cnn_nine@2"])
    assert drv.job_estimate("cnn_nine_jax0_tpu.x", counts) == pytest.approx(
        drv.JOB_SETUP_S + 350 * drv.EPOCH_S["cnn_nine_tpu@2"])
    assert "cnn_nine_tpu" in drv.TPU_PRECISION and drv.BOUNDS["cnn_nine"] == (0.999, 0.05)


@pytest.mark.parametrize("cut", [False, True])
def test_the_jax_init_pair_takes_two_cards_each(cut, monkeypatch, tmp_path):
    """The pair on four cards: the longer (the TPU's precision) first on
    cards 0-1, the float32 run on cards 2-3, each with ``--data-parallel
    2``; under a deadline that only the float32 run's estimate meets, the
    other is dropped and the float32 run still takes its cards."""
    drv = _script("torch_pipeline_cards")
    monkeypatch.setattr(drv, "Proc", _Ended)
    assert drv.job_queue(JAX0_CALL, 1) == ["cnn_nine_jax0_tpu.x", "cnn_nine_jax0.x"]
    ends = [drv.job_estimate(f"{job}.x", 2) for job in ("cnn_nine_jax0", "cnn_nine_jax0_tpu")]
    assert ends[0] < ends[1]
    deadline = sum(ends) / 2 if cut else None
    args = types.SimpleNamespace(out=str(tmp_path), jobs=JAX0_CALL, group=1, device="cuda",
                                 deadline=deadline)
    records = drv.Records(str(tmp_path / "records"))
    drv.train_jobs(args, [0, 1, 2, 3], records, drv.time.time())
    got = records.driver["jobs"]
    argv = {p["name"]: p["argv"] for p in records.driver["processes"]}
    if not cut:
        assert (got["cnn_nine_jax0_tpu.x"]["cards"], got["cnn_nine_jax0.x"]["cards"]) == (
            [0, 1], [2, 3])
    else:
        assert got["cnn_nine_jax0_tpu.x"]["started"] is False
        assert got["cnn_nine_jax0.x"]["cards"] == [0, 1]
    a = argv["cnn_nine_jax0.x"]
    assert a[a.index("--data-parallel") + 1] == "2" and "--tpu-precision" not in a
