"""The surrogate pipeline at its own scale on the CPU:
``scripts/torch_train_full.py`` against the JAX package's
``scripts/train_full.py`` (its helpers on a seeded dataset, and a reduced
run of both from the same flax initial weights), the dataset check's
readings beside its bounds, and ``scripts/torch_pipeline_cards.py``'s
ranges and its split-and-merge.

Tolerances: the reduced training's losses, validation MSEs and held-out
numbers (R^2, relative L2, the Ghia comparison's) to rel 1e-3, abs 1e-3:
float32 convolutions summed in another order at 96^2, carried through two
Adam updates whose first steps move a weight by the learning rate whatever
its gradient's size (measured: 3e-4 of the y model's validation MSE, 5.6e-4
in its held-out R^2(uy)); the merged dataset bit for bit."""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch.ml import datagen, models
from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen
from latticeboltzmannsimulations_tpu.ml import models as jmodels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "ml_full", "dataset_metadata.json")


def _script(name: str):
    """``scripts/<name>.py`` loaded by path, as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU training (the test workers
    share the machine's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dataset(module, res=(100.0, 300.0, 500.0, 700.0, 900.0, 1100.0, 1300.0, 1500.0,
                          1700.0, 1900.0, 2100.0, 3200.0), grid=96, seed=5, failed=None):
    """A seeded dataset of ``module``'s ``DatasetArrays``: three of its Re
    values are held out by ``train_full`` (500, 1500 and 3200, which the
    Ghia tables hold)."""
    rng = np.random.default_rng(seed)
    n = len(res)
    return module.DatasetArrays(
        re_range=np.array(res),
        feq_initial=rng.uniform(0.0, 0.5, (9, grid, grid)).astype(np.float32),
        f_final=rng.uniform(0.0, 0.5, (n, 9, grid, grid)).astype(np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, grid, grid))).astype(np.float32),
        failed=failed)


# --- the helpers --------------------------------------------------------------

def test_held_out_split_and_downsample_are_the_jax_scripts():
    """``HELD_OUT``, ``full_field_r2``, ``split_dataset`` (a quarantined
    training cavity carried, a quarantined held-out one left out) and
    ``downsample`` give JAX's arrays."""
    port, jax_ = _script("torch_train_full"), _script("train_full")
    assert port.HELD_OUT == jax_.HELD_OUT
    failed = np.zeros(12, dtype=bool)
    failed[[1, 7]] = True                        # Re 300 trains, Re 1500 is held out
    ds, jds = _dataset(datagen, failed=failed), _dataset(jdatagen, failed=failed)
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 96, 96))
    assert port.full_field_r2(a, b) == jax_.full_field_r2(a, b)
    (train, held), (jtrain, jheld) = (port.split_dataset(ds, port.HELD_OUT),
                                      jax_.split_dataset(jds, jax_.HELD_OUT))
    assert sorted(held) == sorted(jheld) == [500.0, 3200.0]
    for re in held:
        np.testing.assert_array_equal(held[re], jheld[re])
    for name in ("re_range", "feq_initial", "f_final", "u_final", "failed"):
        np.testing.assert_array_equal(getattr(train, name), getattr(jtrain, name))
    assert train.failed.tolist() == [False, True] + [False] * 7
    small, jsmall = port.downsample(train), jax_.downsample(jtrain)
    for name in ("re_range", "feq_initial", "f_final", "u_final", "failed"):
        np.testing.assert_array_equal(getattr(small, name), getattr(jsmall, name))
    assert small.u_final.shape == (9, 2, 48, 48)


# --- a reduced train_full against JAX's ---------------------------------------

REDUCED = ["--models", "cnn_one", "--epochs-scale", "0.004", "--early-epochs", "2",
           "--fine-tune-epochs", "0"]


def _from_jax_init(train_fn):
    """``train`` of the port whose initial weights, where none are given,
    are the flax ones JAX ``train`` draws for the same seed and data
    (``models.state_dict_from_flax``)."""
    def run(preset_name, data, *args, init_params=None, seed=0, **kw):
        if init_params is None:
            example = (data.fnet[:1],) if data.aux is None else (data.fnet[:1], data.aux[:1])
            flax = jmodels.make_model(preset_name).init(
                jax.random.PRNGKey(seed), *map(jnp.asarray, example))["params"]
            init_params = models.state_dict_from_flax(models.PRESETS[preset_name],
                                                      jax.device_get(flax))
        return train_fn(preset_name, data, *args, init_params=init_params, seed=seed, **kw)
    return run


@pytest.fixture(scope="module")
def reduced_runs(tmp_path_factory):
    """``train_full`` of ``cnn_one`` at 96^2 (x and y, 2 epochs) and the
    early ``cnn_one`` at 48^2 (2 epochs) on a seeded 12-cavity dataset,
    through the JAX script and through the port's on the CPU."""
    root = tmp_path_factory.mktemp("train_full")
    data = root / "data"
    datagen.save_dataset(_dataset(datagen), str(data))
    mp = pytest.MonkeyPatch()
    jmod = _script("train_full")
    mp.setattr(sys, "argv", ["train_full.py", *REDUCED, "--data", str(data),
                             "--out", str(root / "jax")])
    assert jmod.main() == 0
    tmod = _script("torch_train_full")
    mp.setattr(tmod.tr, "train", _from_jax_init(tmod.tr.train))
    assert tmod.main([*REDUCED, "--data", str(data), "--out", str(root / "torch"),
                      "--device", "cpu"]) == 0
    mp.undo()
    runs = {kind: json.loads((root / kind / "summary.json").read_text())
            for kind in ("jax", "torch")}
    return dict(runs, root=root)


def test_reduced_train_full_gives_jax_summary(reduced_runs):
    want, got = reduced_runs["jax"], reduced_runs["torch"]
    assert set(want["models"]) == {"cnn_one", "cnn_one_192"}
    assert want["held_out"] == [500.0, 1500.0, 3200.0]
    _script("torch_train_full").hold_close(got, want, rtol=1e-3, atol=1e-3)
    one = got["models"]["cnn_one"]
    assert [r["re"] for r in one["held_out_eval"]] == [500.0, 1500.0, 3200.0]
    assert "r2_lbm_ux" in one["held_out_eval"][-1]      # Re 3200: the Ghia numbers
    assert one["seed"] == 0 and set(one["train_s"]) == {"x", "y"}
    assert one["device"] == "cpu"


def test_summary_holds_the_jax_record_beside_each_number():
    """Beside every number of the JAX record the port writes that number
    (``jax_<key>``) and the difference (``d_<key>``); the held-out rows are
    matched by Re."""
    mod = _script("torch_train_full")
    record = mod.jax_record("cnn_nine")
    assert record["epochs"] == {"x": 350, "y": 350}
    port = {"epochs": {"x": 350, "y": 350}, "final_val_mse": {"x": 2e-6},
            "schedule": "constant",
            "held_out_eval": [{"re": 1500.0, "r2_ux": 0.999, "rel_l2": 0.02}]}
    out = mod.beside(port, record)
    assert out["epochs"] == {"x": 350, "y": 350, "jax_x": 350, "d_x": 0, "jax_y": 350,
                             "d_y": 0}
    assert out["final_val_mse"]["jax_x"] == record["final_val_mse"]["x"]
    row = out["held_out_eval"][0]
    jrow = next(r for r in record["held_out_eval"] if r["re"] == 1500.0)
    assert row["jax_r2_ux"] == jrow["r2_ux"] and row["d_r2_ux"] == 0.999 - jrow["r2_ux"]
    assert "jax_re" not in row and out["schedule"] == "constant"
    assert mod.jax_record("cnn_one_192")["epochs"] == 80
    assert mod.jax_record("cnn_two") is None


def test_evaluate_without_matplotlib_gives_the_ghia_numbers(monkeypatch, tmp_path):
    """Where matplotlib is missing (the card's machine) a held-out Re of
    the Ghia tables gets ``comparison_metrics``' numbers, in JAX's key
    order, and ``"figure": None``; nothing is drawn."""
    from latticeboltzmannsimulations_torch.config import SimConfig
    from latticeboltzmannsimulations_torch.ml import predict, train

    mod = _script("torch_train_full")
    monkeypatch.setattr(mod, "figures", lambda: False)
    ds = _dataset(datagen, res=(100.0, 3200.0), grid=48)
    data = train.prepare_inputs(ds, models.PRESETS["cnn_one"])
    results = {c: types.SimpleNamespace(params=models.make_model("cnn_one", seed=s).state_dict())
               for s, c in enumerate("xy")}
    held = {3200.0: ds.u_final[1]}
    (rec,) = mod.evaluate("cnn_one", results, data, ds, held, 0.08, str(tmp_path),
                          lambda msg: None, "cpu")
    assert list(rec) == ["re", "r2_ux", "rel_l2", "r2_uy", "r2_lbm_ux", "r2_cnn_ux", "l2_lbm",
                         "l2_cnn", "figure", "cnn_vs_lbm_l2"]
    assert rec["figure"] is None and not os.listdir(tmp_path)
    fnet, aux = predict.build_input("cnn_one", 3200.0, ds.feq_initial, data.scalers)
    u = predict.predict_velocity("cnn_one", results["x"].params, results["y"].params, fnet,
                                 aux, data.scalers, device="cpu")
    want = predict.comparison_metrics(SimConfig(nx=48, ny=48, reynolds=3200.0), held[3200.0], u)
    assert {k: rec[k] for k in want} == {k: round(v, 5) for k, v in want.items()}


# --- the kept held-out truth --------------------------------------------------

def test_kept_truth_rereads_to_the_in_run_evaluation(reduced_runs):
    """The record the reduced run kept (``held_out_truth.npz``), re-read
    without the dataset, gives the saved halves the in-run evaluation
    exactly; the seeded dataset's ``feq_initial`` is no sweep's, so the
    record stores it."""
    tf = _script("torch_train_full")
    out = reduced_runs["root"] / "torch"
    with np.load(out / tf.TRUTH) as z:
        assert sorted(z.files) == ["feq_initial", "re", "scalers", "u_final", "u_lid"]
    truth = tf.load_truth(str(out / tf.TRUTH))
    ds = datagen.load_dataset(str(reduced_runs["root"] / "data"))
    np.testing.assert_array_equal(truth.feq_initial, ds.feq_initial)
    for re, u in truth.held.items():
        np.testing.assert_array_equal(u, ds.u_final[list(ds.re_range).index(re)])
    entry = tf.score_saved("cnn_one", str(out / "cnn_one"), truth, lambda msg: None, "cpu")
    want = reduced_runs["torch"]["models"]["cnn_one"]["held_out_eval"]
    assert entry["scalers"] == entry["dataset_scalers"] == truth.scalers["cnn_one"]
    got = entry["held_out_eval"]
    assert [r["re"] for r in got] == [500.0, 1500.0, 3200.0] and got[-1]["figure"] is None
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "figure"} == {
            k: v for k, v in w.items() if k != "figure"}


@pytest.mark.parametrize("sweep", [True, False])
def test_kept_truth_rebuilds_the_sweeps_initial_equilibrium(sweep, tmp_path):
    """A dataset whose ``feq_initial`` is the sweep's own (the configuration's
    initial equilibrium, as ``torch_datagen_full.py`` assembles it) is not
    stored but rebuilt bit for bit; any other is stored."""
    from latticeboltzmannsimulations_torch import engine
    from latticeboltzmannsimulations_torch.config import SimConfig

    tf = _script("torch_train_full")
    cfg = SimConfig(nx=48, ny=48, reynolds=1000.0, collision="srt", turbulence="smagorinsky",
                    precision="float32").validate()
    feq = engine.init_state(cfg, "cpu").f.numpy()
    if not sweep:
        feq = feq.copy()
        feq[4, 7, 9] = np.nextafter(feq[4, 7, 9], np.float32(1))
    held = {2500.0: np.full((2, 48, 48), 0.25, np.float32)}
    tf.save_truth(str(tmp_path / "t.npz"), held, feq, 0.08, {"cnn_nine": {"re": None}})
    with np.load(tmp_path / "t.npz") as z:
        assert ("feq_initial" in z.files) == (not sweep)
    truth = tf.load_truth(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(truth.feq_initial, feq)
    assert truth.feq_initial.dtype == np.float32 and truth.u_lid == 0.08
    assert list(truth.held) == [2500.0] and truth.scalers == {"cnn_nine": {"re": None}}


def test_jax_weights_on_a_kept_truth_score_as_the_jax_script(tmp_path):
    """JAX's trained ``cnn_nine`` halves (the committed ``.msgpack`` files and
    their sidecars' scalers) scored by ``scripts/torch_score_weights.py`` on
    a kept record of a seeded 192^2 truth (Re 1500 and 2500) against JAX's
    ``train_full.evaluate`` of the same weights on the same truth, within
    rel 1e-3, abs 1e-3 (float32 convolutions in another order); each
    number stands beside JAX's record."""
    from flax import serialization

    port, jax_ = _script("torch_train_full"), _script("train_full")
    ds = _dataset(jdatagen, res=(1500.0, 2500.0), grid=192, seed=11)
    held = {float(r): ds.u_final[i] for i, r in enumerate(ds.re_range)}
    port.save_truth(str(tmp_path / "truth.npz"), held, ds.feq_initial, 0.08, {})
    weights = os.path.join(ROOT, "docs", "artifacts", "ml_full", "cnn_nine")
    out = tmp_path / "scores.json"
    assert _script("torch_score_weights").main([
        "--truth", str(tmp_path / "truth.npz"), "--weights", f"cnn_nine={weights}",
        "--out", str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())["models"]["cnn_nine"]["jax"]
    side = json.load(open(os.path.join(weights, "cnn_nine_x.json")))["scalers"]
    assert got["scalers"] == side and got["dataset_scalers"] is None
    results = {c: types.SimpleNamespace(params=serialization.msgpack_restore(
        open(os.path.join(weights, f"cnn_nine_{c}.msgpack"), "rb").read())) for c in "xy"}
    want = jax_.evaluate("cnn_nine", results, types.SimpleNamespace(scalers=side), ds, held,
                         0.08, str(tmp_path), lambda msg: None)
    port.hold_close(got["held_out_eval"], want, rtol=1e-3, atol=1e-3)
    record = {r["re"]: r for r in port.jax_record("cnn_nine")["held_out_eval"]}
    for row in got["held_out_eval"]:
        assert row["jax_r2_ux"] == record[row["re"]]["r2_ux"]
        assert row["d_rel_l2"] == row["rel_l2"] - record[row["re"]]["rel_l2"]


# --- the dataset check's readings ---------------------------------------------

def test_dataset_check_readings_of_jax_record_against_itself(tmp_path):
    check = _script("torch_check_dataset")
    assert check.main([JAX_RECORD, JAX_RECORD, "--out", str(tmp_path / "c.json")]) == 0
    out = json.loads((tmp_path / "c.json").read_text())
    assert out["converged_cavities"] == {"port": 313, "jax": 313}
    assert sum(c["of"] for c in json.load(open(JAX_RECORD))["chunks"]) == 500
    assert out["readings"] == {"converged_in_both": 32, "earlier": 0, "later": 0, "same": 32,
                               "sign_test_p": 1.0, "median_steps_ratio": 1.0,
                               "median_steps_ratio_all": 1.0}


@pytest.mark.parametrize("earlier, later, p", [
    (0, 0, 1.0), (0, 10, 2 / 1024), (10, 0, 2 / 1024), (3, 2, 1.0), (1, 9, 22 / 1024),
])
def test_sign_test_is_the_exact_binomial(earlier, later, p):
    assert _script("torch_check_dataset").sign_test_p(earlier, later) == pytest.approx(p)


def test_dataset_check_reads_earlier_and_later_chunks(tmp_path):
    """Three chunks that converged everywhere in both stop earlier in a
    changed record, one later: the readings count them; a capped chunk is
    left out of the count."""
    check = _script("torch_check_dataset")
    meta = json.load(open(JAX_RECORD))
    both = [c for c in meta["chunks"] if c["converged"] == c["of"]]
    for c in both[:3]:
        c["steps"] -= 50_000
    both[3]["steps"] += 50_000
    rd = check.compare(meta, json.load(open(JAX_RECORD)))["readings"]
    assert (rd["earlier"], rd["later"], rd["same"]) == (3, 1, 28)
    assert rd["sign_test_p"] == pytest.approx(check.sign_test_p(3, 1))


# --- the pipeline runner over the cards ---------------------------------------

def test_card_ranges_are_whole_chunks_balanced_on_the_record():
    """Four ranges of whole chunks from Re 100 (each a first Re of 100 +
    70 k), covering Re 100..5090 once, the largest as small as any
    contiguous cut of the record's 72 chunks makes it: JAX's steps 37.66 M,
    40.67 M, 42.0 M and 42.0 M."""
    drv = _script("torch_pipeline_cards")
    record = json.load(open(JAX_RECORD))
    ranges = drv.card_ranges(record, 4)
    assert [(r["re_start"], r["re_stop"], r["chunks"]) for r in ranges] == [
        (100.0, 2130.0, 29), (2130.0, 3180.0, 15), (3180.0, 4160.0, 14), (4160.0, 5100.0, 14)]
    assert [r["steps"] for r in ranges] == [37_660_000, 40_670_000, 42_000_000, 42_000_000]
    covered = np.concatenate([np.arange(r["re_start"], r["re_stop"], 10.0) for r in ranges])
    np.testing.assert_array_equal(covered, np.arange(100.0, 5100.0, 10.0))
    assert all((r["re_start"] - 100.0) % 70.0 == 0 for r in ranges)
    steps = np.array([c[2] for c in drv.record_chunks(record)])
    assert steps.sum() == 162_330_000
    prefix = np.concatenate([[0], np.cumsum(steps)])
    best = min(max(prefix[a], prefix[b] - prefix[a], prefix[c] - prefix[b],
                   prefix[-1] - prefix[c])
               for a, b, c in itertools.combinations(range(1, len(steps)), 3))
    assert max(r["steps"] for r in ranges) == best
    for n in (1, 2, 3, 72):
        parts = drv.balanced_ranges(list(steps), n)
        assert parts[0][0] == 0 and parts[-1][1] == 72 and len(parts) == n
        assert all(a < b for a, b in parts)
        assert all(b == a2 for (_, b), (a2, _) in zip(parts, parts[1:]))
    with pytest.raises(ValueError):
        drv.balanced_ranges(list(steps), 73)


SMALL_SWEEP = ["--grid", "32", "--max-steps", "200", "--report-interval", "50"]
SMALL_TOPUP = ["--grid", "32", "--extra-steps", "100", "--report-interval", "50"]


def test_split_and_merge_equals_one_directory(tmp_path):
    """The first four chunks of the sweep at 32^2 (a 200-step cap, a
    100-step top-up) as two "cards" on the CPU, each range in its own
    directory, merged and assembled by the pipeline runner, against the same chunks
    in one directory (the sweep, the top-up, the assembly): the chunk files,
    the four arrays and ``metadata.json`` (but its wall time) equal, bit for
    bit; and the pipeline runner's check of its dataset against that directory's
    record passes every chunk, as does its determinism check against it."""
    full, topup = _script("torch_datagen_full"), _script("torch_datagen_topup")
    one = tmp_path / "one"
    base = ["--re-start", "100", "--re-stop", "380", "--out", str(one), "--device", "cpu"]
    assert full.main([*SMALL_SWEEP, *base]) == 0
    assert topup.main([*SMALL_TOPUP, "--data", str(one), "--device", "cpu"]) == 0
    assert full.main([*SMALL_SWEEP, *base]) == 0            # the assembly after the top-up
    drv = _script("torch_pipeline_cards")
    out, records = tmp_path / "cards", tmp_path / "records"
    assert drv.main(["--out", str(out), "--records", str(records), "--cards", "0,0",
                     "--device", "cpu", "--re-stop", "380", "--record",
                     str(one / "metadata.json"), "--determinism-record",
                     str(one / "metadata.json"), "--sweep-args", " ".join(SMALL_SWEEP),
                     "--topup-args", " ".join(SMALL_TOPUP), "--jobs", ""]) == 0
    driver = json.loads((records / "driver.json").read_text())
    assert [(r["re_start"], r["re_stop"]) for r in driver["ranges"]] == [(100.0, 240.0),
                                                                         (240.0, 380.0)]
    assert [p["rc"] for p in driver["processes"]] == [0] * 7
    assert driver["determinism_rc"] == 0
    assert sorted(os.listdir(out / "card0" / "chunks")) == ["re000100.0.npz", "re000170.0.npz"]
    names = sorted(os.listdir(one / "chunks"))
    assert sorted(os.listdir(out / "chunks")) == names and len(names) == 4
    for fn in names:
        a, b = np.load(one / "chunks" / fn), np.load(out / "chunks" / fn)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=f"{fn} {key}")
    for name in ("Re_range.npy", "feq_initial.npy", "f_final.npy", "u_final.npy"):
        np.testing.assert_array_equal(np.load(out / name), np.load(one / name), err_msg=name)
    want, got = (json.loads((d / "metadata.json").read_text()) for d in (one, out))
    assert {k: v for k, v in got.items() if k != "elapsed_s"} == {
        k: v for k, v in want.items() if k != "elapsed_s"}
    assert all(int(c["steps"]) == 300 for c in got["chunks"])     # every chunk topped up
    check = json.loads((records / "ml_dataset.json").read_text())
    assert check["ok"] and check["agree"] == 4
    same = json.loads((records / "determinism.json").read_text())
    assert same["deterministic"] and (same["agree"], same["compared"]) == (4, 4)
    assert (records / "card1" / "topup.jsonl").exists()
    assert (records / "ml_full" / "metadata.json").exists()


def test_cut_pipeline_keeps_the_held_out_truth(monkeypatch, tmp_path):
    """The cut pipeline on the CPU (the first six chunks, Re 100..510, at
    48^2 with a 200-step cap and a 100-step top-up, on two slots) with
    ``cnn_one``'s halves (one slot each: its batch of 5 does not split) and
    its evaluation: the evaluation's kept record
    (``held_out_truth.npz``, Re 500) reaches the runner's records beside the
    merged summary, holds the assembled dataset's field of Re 500, and
    rebuilds the sweep's ``feq_initial`` bit for bit without storing it.
    The dataset check holds the 48^2 chunks to JAX's 384^2 record and
    misses, as it should."""
    drv, tf = _script("torch_pipeline_cards"), _script("torch_train_full")
    assert drv.TRUTH == tf.TRUTH
    monkeypatch.setitem(drv.JOBS, "cnn_one", drv.Job(
        "torch_train_full", ["--models", "cnn_one", "--early-preset", "", "--fine-tune-epochs",
                             "0", "--epochs-scale", "0.004"],
        "ml_full", {"cnn_one": 4}, "cnn_one"))
    monkeypatch.setitem(drv.EPOCH_S, "cnn_one", 1.0)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out, records = tmp_path / "data", tmp_path / "records"
    sweep = "--grid 48 --max-steps 200 --report-interval 50"
    assert drv.main(["--out", str(out), "--records", str(records), "--cards", "0,0",
                     "--device", "cpu", "--re-stop", "520", "--determinism-record", "",
                     "--sweep-args", sweep, "--topup-args",
                     "--grid 48 --extra-steps 100 --report-interval 50",
                     "--jobs", "cnn_one.x,cnn_one.y"]) == 1
    driver = json.loads((records / "driver.json").read_text())
    assert [p["rc"] for p in driver["processes"]] == [0] * 5 + [1] + [0] * 3
    assert driver["dataset_check_rc"] == 1 and driver["assemble_s"] > 0
    assert all(b["ok"] for b in driver["bounds"].values())
    summary = json.loads((records / "ml_full" / "summary.json").read_text())
    assert [r["re"] for r in summary["models"]["cnn_one"]["held_out_eval"]] == [500.0]
    with np.load(records / "ml_full" / tf.TRUTH) as z:
        assert "feq_initial" not in z.files
    truth = tf.load_truth(str(records / "ml_full" / tf.TRUTH))
    ds = datagen.load_dataset(str(out))
    np.testing.assert_array_equal(truth.feq_initial, ds.feq_initial)
    np.testing.assert_array_equal(truth.held[500.0], ds.u_final[list(ds.re_range).index(500.0)])
    assert truth.scalers["cnn_one"] == json.loads(
        (out / "train" / "cnn_one.x" / "cnn_one" / "cnn_one_x.json").read_text())["scalers"]


def test_assembly_timing_assembles_every_chunk_of_the_record(tmp_path):
    """``scripts/torch_time_assembly.py`` at 48^2: one synthetic chunk file
    per chunk of JAX's record (72, 500 Re values), assembled by
    ``torch_datagen_full.py --assemble-partial`` in a process of its own
    and timed; the files are removed after."""
    mod = _script("torch_time_assembly")
    out = tmp_path / "assembly.json"
    assert mod.main(["--grid", "48", "--dir", str(tmp_path / "a"), "--out", str(out),
                     "--workers", "1"]) == 0
    got = json.loads(out.read_text())
    assert (got["chunks"], got["cavities"], got["grid"]) == (72, 500, 48)
    assert got["seconds"] > 0 and got["assembled_bytes"] > 500 * 11 * 48 * 48 * 4
    assert not (tmp_path / "a").exists()


def test_driver_raises_without_a_card_and_gates_the_jobs():
    """The pipeline runner defaults to the card and raises without one; each job's
    held-out numbers are held to its bound."""
    drv = _script("torch_pipeline_cards")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            drv.main(["--jobs", ""])
    rows = [{"re": r, "r2_ux": 0.9995, "rel_l2": 0.02} for r in range(7)]
    assert drv.held_to_bounds("cnn_nine", {"models": {"cnn_nine": {"held_out_eval": rows}}})["ok"]
    rows[3]["rel_l2"] = 0.06
    out = drv.held_to_bounds("cnn_nine", {"models": {"cnn_nine": {"held_out_eval": rows}}})
    assert not out["ok"] and [r["ok"] for r in out["rows"]].count(False) == 1
    assert drv.held_to_bounds("cnn_ten", {"models": {"cnn_ten": {"held_out_eval": rows}}})["ok"]
    one = {"first_loss": 0.035, "final_loss": 1.4e-4, "final_val_mse": {"x": 2.4e-5}}
    assert drv.held_to_bounds("cnn_one_192", {"models": {"cnn_one_192": one}})["ok"]
    one["final_loss"] = 1e-3
    assert not drv.held_to_bounds("cnn_one_192", {"models": {"cnn_one_192": one}})["ok"]
    eight = drv.held_to_bounds("cnn_eight", {"models": {"cnn_eight": {
        "held_out_eval": [{"re": 500.0, "r2_ux": 0.92, "rel_l2": 0.41}], "seed": 0}}})
    assert eight["ok"] and eight["on_plateau"] and eight["seed"] == 0


def test_gated_jobs_start_before_the_readings():
    """The held-out bounds' jobs are queued first, longest first, and
    ``cnn_eight``'s plateau reading last, whatever ``--jobs``' order."""
    drv = _script("torch_pipeline_cards")
    assert drv.job_queue("cnn_eight,cnn_one_192,cnn_ten,cnn_nine") == [
        "cnn_nine", "cnn_ten", "cnn_one_192", "cnn_eight"]
    assert drv.job_queue(",".join(drv.TRAIN_FULL_JOBS)) == drv.job_queue(
        "cnn_ten,cnn_nine,cnn_eight,cnn_one_192")
    assert drv.job_queue("") == []
