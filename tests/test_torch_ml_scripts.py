"""The port's surrogate-pipeline scripts (``scripts/torch_datagen_full.py``,
``torch_datagen_topup.py``, ``torch_check_dataset.py``,
``torch_predict_extrapolate.py``, ``torch_ml_demo.py``) against the JAX
package's on the CPU: the same command lines and configurations, a reduced
sweep and top-up through both giving the same chunks, the dataset check on
JAX's record, and a trained surrogate served from the tracked weights.

Tolerances: the chunks' fields to atol 2e-5 (float32 over a few hundred
steps, another implementation of the step), their counters and flags
equal; the served field to 1e-6 of its norm and its metrics to 1e-6 (the
same convolutions in another framework, float32)."""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import sys
import types

import flax.serialization as serialization
import numpy as np
import pytest

from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.ml import predict, train
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels import pallas_pull
from latticeboltzmannsimulations_tpu.ml import predict as jpredict
from latticeboltzmannsimulations_tpu.validate import compare_to_ghia as jcompare_to_ghia

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
# the scripts whose command line is the JAX script's (plus --device)
SAME_CLI = [("datagen_full", "torch_datagen_full"), ("datagen_topup", "torch_datagen_topup"),
            ("predict_extrapolate", "torch_predict_extrapolate"),
            ("train_full", "torch_train_full")]


def _script(name: str):
    """``scripts/<name>.py`` loaded by path, as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


# the port's own flags: the device, and torch_train_full.py's training over
# several cards, its evaluation of halves trained apart, the seed of its
# initial weights, its kept snapshots, the flax parameters it starts from and
# its training at the TPU's convolution precision
PORT_FLAGS = ("device", "data_parallel", "evaluate_only", "seed", "snapshots", "init_from",
              "tpu_precision")


def _options(mod, monkeypatch) -> dict:
    """``--flag -> (default, type, help, action)`` of the parser that
    ``mod.main`` builds, caught as it parses; ``PORT_FLAGS`` are the port's
    own."""
    seen = {}

    def parse(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed):
        mod.main()
    monkeypatch.undo()
    return {a.option_strings[0] if a.option_strings else a.dest:
            (a.default, a.type, a.help, type(a).__name__)
            for a in seen["parser"]._actions if a.dest not in ("help", *PORT_FLAGS)}


@pytest.mark.parametrize("jax_name, port_name", SAME_CLI)
def test_command_lines_are_the_jax_scripts(jax_name, port_name, monkeypatch):
    assert _options(_script(port_name), monkeypatch) == _options(_script(jax_name),
                                                                 monkeypatch)


def test_weight_dirs_are_the_jax_scripts():
    assert (_script("torch_predict_extrapolate").WEIGHT_DIRS
            == _script("predict_extrapolate").WEIGHT_DIRS)


def _record_demo(mod, tmp_path) -> list:
    """Run ``mod.main`` with its pipeline's calls replaced by recorders of
    their arguments (nothing is generated, trained or solved)."""
    calls = []

    def rec(name, result=None):
        def call(*args, **kw):
            kw.pop("device", None)
            kw.pop("progress", None)
            calls.append((name, args, kw))
            return result
        return call

    n = 48
    ds = types.SimpleNamespace(feq_initial=np.zeros((9, 4, 4), np.float32),
                               re_range=np.zeros(n))
    data = types.SimpleNamespace(scalers={})
    history = {"loss": [1.0], "val_loss": [1.0]}
    with open(os.path.join(ROOT, "docs", "artifacts", "ml_demo", "metrics.json")) as fh:
        metrics = {k: v for k, v in json.load(fh).items() if not k.endswith("_s")}
    mod.OUT = str(tmp_path)
    mod.generate_dataset = rec("generate_dataset", ds)
    mod.save_dataset = lambda *a, **k: None
    mod.ml_train = types.SimpleNamespace(
        prepare_inputs=rec("prepare_inputs", data),
        train=rec("train", types.SimpleNamespace(history=history, params={})),
        save_weights=lambda *a, **k: None, plot_history=lambda *a, **k: None)
    mod.ml_predict = types.SimpleNamespace(
        build_input=rec("build_input", (None, None)),
        predict_velocity=rec("predict_velocity"),
        lbm_reference=rec("lbm_reference"),
        comparison_figure=lambda *a, **k: dict(metrics),
        comparison_metrics=lambda *a, **k: dict(metrics))
    return calls


def _plain(value):
    """Configurations as their fields (the port's dtype is torch's)."""
    if dataclasses.is_dataclass(value):
        return {k: v for k, v in dataclasses.asdict(value).items()}
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def test_demo_configuration_is_the_jax_scripts(tmp_path, monkeypatch):
    jmod, tmod = _script("ml_demo_tpu"), _script("torch_ml_demo")
    jcalls = _record_demo(jmod, tmp_path / "jax")
    tcalls = _record_demo(tmod, tmp_path / "torch")
    monkeypatch.setattr(sys, "argv", ["ml_demo_tpu.py"])
    jmod.main()
    assert tmod.main(["--device", "cpu"]) == 0
    names = [c[0] for c in jcalls]
    assert names == ["generate_dataset", "prepare_inputs", "train", "train", "build_input",
                     "predict_velocity", "lbm_reference"]
    assert [c[0] for c in tcalls] == names
    for (name, jargs, jkw), (_, targs, tkw) in zip(jcalls, tcalls):
        if name in ("prepare_inputs", "predict_velocity"):
            continue            # the arrays and weights the recorders gave back
        assert [_plain(a) for a in targs] == [_plain(a) for a in jargs], name
        assert _plain(tkw) == _plain(jkw), name
    metrics = json.loads((tmp_path / "torch" / "metrics.json").read_text())
    assert metrics["jax_r2_cnn_ux"] == pytest.approx(0.97424, abs=1e-5)


# --- the reduced sweep and top-up ---------------------------------------------

SWEEP = ["--grid", "32", "--n-cav", "3", "--max-steps", "200", "--report-interval", "50",
         "--re-start", "100", "--re-stop", "170", "--re-step", "10", "--tol", "1e-7"]
TOPUP = ["--grid", "32", "--n-cav", "3", "--extra-steps", "180", "--total-cap", "400",
         "--report-interval", "20", "--tol", "2.8e-3"]


def _one_hit(config_cls):
    """``config_cls`` converging at the first check within the tolerance."""
    def make(**kwargs):
        return config_cls(**kwargs, convergence_hits=0)
    return make


@pytest.fixture(scope="module")
def reduced_sweep(tmp_path_factory):
    """7 Re at 32^2 in batches of 3 (the last a batch of 1, padded in the
    top-up), a 200-step cap at which none converges, then the top-up of 180
    steps in 20-step checks at a tolerance that two batches meet early and
    one never does, through the JAX scripts (the top-up's sweep runner in
    interpret mode) and through the port's on the CPU."""
    root = tmp_path_factory.mktemp("sweeps")
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_pull, "make_sweep_runner",
               functools.partial(pallas_pull.make_sweep_runner, interpret=True))
    out = {}
    for kind, full, topup, extra in (
            ("jax", "datagen_full", "datagen_topup", []),
            ("torch", "torch_datagen_full", "torch_datagen_topup", ["--device", "cpu"])):
        d = root / kind
        mp.setattr(sys, "argv", [full, *SWEEP, "--out", str(d), *extra])
        assert _script(full).main() == 0
        mod = _script(topup)
        mp.setattr(mod, "SimConfig", _one_hit(mod.SimConfig))
        mp.setattr(sys, "argv", [topup, *TOPUP, "--data", str(d), *extra])
        assert mod.main() == 0
        mp.setattr(sys, "argv", [full, *SWEEP, "--out", str(d), *extra])
        assert _script(full).main() == 0       # the resume: assembly only
        out[kind] = d
    mp.undo()
    return out


def _chunks(d):
    return {fn: dict(np.load(d / "chunks" / fn)) for fn in sorted(os.listdir(d / "chunks"))}


def test_reduced_sweep_and_topup_give_jax_chunks(reduced_sweep):
    want, got = _chunks(reduced_sweep["jax"]), _chunks(reduced_sweep["torch"])
    assert list(got) == list(want) == ["re000100.0.npz", "re000130.0.npz", "re000160.0.npz"]
    for fn in want:
        assert sorted(got[fn]) == sorted(want[fn]), fn
        for key in ("re", "steps", "converged"):
            np.testing.assert_array_equal(got[fn][key], want[fn][key], err_msg=f"{fn} {key}")
        for key in ("f_final", "u_final"):
            assert got[fn][key].dtype == want[fn][key].dtype == np.float32
            np.testing.assert_allclose(got[fn][key], want[fn][key], rtol=0, atol=ATOL,
                                       err_msg=f"{fn} {key}")
    # the top-up ran every chunk on: the first to its budget, unconverged;
    # the others converged before it, the padded batch of one among them
    assert {fn: (int(c["steps"]), c["converged"].tolist()) for fn, c in got.items()} == {
        "re000100.0.npz": (380, [False] * 3), "re000130.0.npz": (340, [True] * 3),
        "re000160.0.npz": (340, [True])}


def test_reduced_sweep_gives_jax_dataset_and_logs(reduced_sweep):
    jdir, tdir = reduced_sweep["jax"], reduced_sweep["torch"]
    want = json.loads((jdir / "metadata.json").read_text())
    got = json.loads((tdir / "metadata.json").read_text())
    assert list(got) == list(want)
    for key in want:
        if key != "elapsed_s":
            assert got[key] == want[key], key
    for name in ("Re_range.npy", "feq_initial.npy"):
        np.testing.assert_array_equal(np.load(tdir / name), np.load(jdir / name))
    for log in ("progress.jsonl", "topup.jsonl"):
        jl = [json.loads(x) for x in (jdir / log).read_text().splitlines()]
        tl = [json.loads(x) for x in (tdir / log).read_text().splitlines()]
        assert len(tl) == len(jl) > 0, log
        for j, t in zip(jl, tl):
            assert set(j) <= set(t), log
            assert {k: t[k] for k in j if k != "elapsed_s"} == {
                k: v for k, v in j.items() if k != "elapsed_s"}, log


# --- the dataset check --------------------------------------------------------

JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "ml_full", "dataset_metadata.json")


def _record():
    with open(JAX_RECORD) as fh:
        return json.load(fh)


def _check(tmp_path, meta) -> int:
    path = tmp_path / "metadata.json"
    path.write_text(json.dumps(meta))
    return _script("torch_check_dataset").main(
        [str(path), JAX_RECORD, "--out", str(tmp_path / "check.json")])


def test_dataset_check_passes_the_jax_record_against_itself(tmp_path):
    assert _check(tmp_path, _record()) == 0
    out = json.loads((tmp_path / "check.json").read_text())
    assert out["ok"] and out["agree"] == out["of"] == 72
    assert out["converged_cavities"] == {"port": 313, "jax": 313}


def _partial(keep=(240.0, 310.0, 940.0, 1640.0, 5070.0)) -> dict:
    """JAX's record cut to the chunks that start at ``keep``, as the port's
    ``--assemble-partial`` metadata of those chunks would hold them."""
    meta = _record()
    meta["chunks"] = [c for c in meta["chunks"] if c["re_lo"] in keep]
    meta["n"] = sum(c["of"] for c in meta["chunks"])
    meta["re"] = [min(keep), max(c["re_hi"] for c in meta["chunks"])]
    meta["max_steps"] = max(c["steps"] for c in meta["chunks"])
    return meta


@pytest.mark.parametrize("change, rc", [
    (None, 0),
    (("310", "steps", +10_000), 0),                 # 2 intervals: within the bound
    (("5070", "converged", +1), 0),                 # capped: one more converged
    (("310", "converged", -1), 1),                  # converged 7/7 in JAX's
    (("240", "converged", -2), 1),                  # capped: two fewer
    (("240", "steps", -15_000), 1),                 # capped: 3 intervals short
    (("1640", "steps", +150_000), 1),               # beyond 5 % and 2 intervals
    (("field", "sweep_max_steps", 20_000), 1),
])
def test_dataset_check_bounds_a_partial_dataset(tmp_path, change, rc):
    meta = _partial()
    if change is not None:
        where, key, delta = change
        if where == "field":
            meta[key] = delta
        else:
            chunk = next(c for c in meta["chunks"] if c["re_lo"] == float(where))
            chunk[key] += delta
    assert _check(tmp_path, meta) == rc


def test_dataset_check_reads_a_chunk_directory(tmp_path, reduced_sweep):
    """A directory of chunks: its record against itself (as JAX's
    metadata) passes, and one chunk changed on disk fails."""
    d = reduced_sweep["torch"]
    check = _script("torch_check_dataset")
    own = d / "metadata.json"
    assert check.main([str(d), str(own), "--out", str(tmp_path / "a.json")]) == 0
    meta = json.loads(own.read_text())
    meta["chunks"][0]["converged"] = meta["chunks"][0]["of"]
    meta["chunks"][0]["steps"] -= 50
    other = tmp_path / "other.json"
    other.write_text(json.dumps(meta))
    assert check.main([str(d), str(other), "--out", str(tmp_path / "b.json")]) == 1


# --- serving the tracked weights ----------------------------------------------

NINE = os.path.join(ROOT, "docs", "artifacts", "ml_full", "cnn_nine")
TRUTH = os.path.join(ROOT, "docs", "artifacts", "extrapolation", "lbm_re7500.npz")


def test_cnn_nine_at_re7500_serves_as_jax_does():
    """``cnn_nine`` from its tracked weights at Re = 7500 on the 384^2
    template, ``predict_velocity`` of the port against JAX's on the CPU
    (to 1e-6 of the field's norm), and ``comparison_figure``'s metrics
    (``comparison_metrics``) against the tracked truth (to 1e-6)."""
    from latticeboltzmannsimulations_torch import engine
    from latticeboltzmannsimulations_tpu import engine as jengine

    cfg = SimConfig(nx=384, ny=384, reynolds=7500.0, collision="srt",
                    turbulence="smagorinsky", precision="float32")
    jcfg = JConfig(nx=384, ny=384, reynolds=7500.0, collision="srt",
                   turbulence="smagorinsky", precision="float32")
    feq = engine.init_state(cfg, "cpu").f.numpy()
    np.testing.assert_array_equal(feq, np.asarray(jengine.init_state(jcfg).f))
    px, meta = train.load_weights("cnn_nine", "x", NINE)
    py, _ = train.load_weights("cnn_nine", "y", NINE)
    scalers = meta["scalers"]
    fnet, aux = predict.build_input("cnn_nine", 7500.0, feq, scalers)
    jfnet, jaux = jpredict.build_input("cnn_nine", 7500.0, feq, scalers)
    np.testing.assert_array_equal(fnet, jfnet)
    # flax's own reader without the template that jtrain.load_weights
    # initialises at 384^2 (tests/test_torch_ml_flax_msgpack.py holds the
    # two equal)
    jpx, jpy = (serialization.msgpack_restore(open(os.path.join(NINE, f"cnn_nine_{c}.msgpack"),
                                                   "rb").read()) for c in "xy")
    got = predict.predict_velocity("cnn_nine", px, py, fnet, aux, scalers, device="cpu")
    want = np.asarray(jpredict.predict_velocity("cnn_nine", jpx, jpy, jfnet, jaux, scalers))
    assert got.shape == want.shape == (2, 384, 384)
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    truth = np.load(TRUTH)["u"]
    # comparison_figure's metrics without the drawings (the card's machine
    # has no matplotlib; tests/test_torch_viz.py holds the two figures'
    # metrics equal)
    m = predict.comparison_metrics(cfg, truth, got)
    gl, gc = (jcompare_to_ghia(u, 0.08, 7500.0) for u in (truth, want))
    jm = {"r2_lbm_ux": gl.r2_ux, "r2_cnn_ux": gc.r2_ux, "l2_lbm": gl.l2_combined,
          "l2_cnn": gc.l2_combined,
          "cnn_vs_lbm_l2": float(np.linalg.norm(want - truth) / (np.linalg.norm(truth) + 1e-12))}
    assert list(m) == list(jm)
    for key in jm:
        assert m[key] == pytest.approx(jm[key], abs=1e-6), key


def test_cnn_nine_at_the_tpus_precision_gives_jax_record():
    """Served with each convolution at a TPU's default precision for
    float32 (``torch_predict_extrapolate.tpu_conv_precision``: the operands
    rounded to bfloat16), ``cnn_nine`` at Re = 7500 and 10000 gives the
    record's ``cnn_vs_lbm_l2`` against the tracked truth
    (``docs/artifacts/extrapolation/summary.json``, taken on the TPU) to
    its five decimals, where float32 serving misses it by over 1e-3."""
    from latticeboltzmannsimulations_torch import engine

    tpu_conv_precision = _script("torch_predict_extrapolate").tpu_conv_precision
    record = json.loads(open(os.path.join(ROOT, "docs", "artifacts", "extrapolation",
                                          "summary.json")).read())["cnn_nine"]
    cfg = SimConfig(nx=384, ny=384, precision="float32")
    feq = engine.init_state(cfg, "cpu").f.numpy()
    px, meta = train.load_weights("cnn_nine", "x", NINE)
    py, _ = train.load_weights("cnn_nine", "y", NINE)
    for re in (7500.0, 10000.0):
        run = dataclasses.replace(cfg, reynolds=re)
        truth = np.load(TRUTH.replace("7500", f"{re:g}"))["u"]
        fnet, aux = predict.build_input("cnn_nine", re, feq, meta["scalers"])

        def l2():
            return predict.comparison_metrics(run, truth, predict.predict_velocity(
                "cnn_nine", px, py, fnet, aux, meta["scalers"], device="cpu"))["cnn_vs_lbm_l2"]

        with tpu_conv_precision():
            at_tpu = l2()
        want = record[f"re{re:g}"]["cnn_vs_lbm_l2"]
        assert at_tpu == pytest.approx(want, abs=5e-6), re
        assert abs(l2() - want) > 1e-3, re       # the context left, float32 again


@pytest.mark.parametrize("transpose", [False, True])
def test_tpu_conv_precision_rounds_every_operand(transpose):
    """Inside ``tpu_conv_precision`` a convolution of ``ml.models`` and both
    of its gradient convolutions take bfloat16-rounded operands and sum in
    float32; the bias and its gradient stay float32 (the forward to 1e-6 of
    its norm, the gradients to 1e-5: the same products summed in another
    order)."""
    import torch
    import torch.nn.functional as F

    from latticeboltzmannsimulations_torch.ml import models

    mod = _script("torch_predict_extrapolate")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=gen, requires_grad=True)
    w = torch.randn(*((3, 4) if transpose else (4, 3)), 3, 3, generator=gen,
                    requires_grad=True)
    b = torch.randn(4, generator=gen, requires_grad=True)
    g = torch.randn(2, 4, *((17, 17) if transpose else (3, 3)), generator=gen)
    op = "conv_transpose2d" if transpose else "conv2d"
    with mod.tpu_conv_precision():
        y = getattr(models.F, op)(x, w, b, stride=2)
    y.backward(g)

    def r(t):
        return t.detach().to(torch.bfloat16).float()

    xr, wr, gr = r(x), r(w), r(g)
    xr.requires_grad_(True)
    wr.requires_grad_(True)
    want = getattr(F, op)(xr, wr, None, stride=2) + b.detach()[:, None, None]
    want.backward(gr)
    assert models.F is F
    assert torch.linalg.norm(y - want) <= 1e-6 * torch.linalg.norm(want)
    for got, ref in ((x.grad, xr.grad), (w.grad, wr.grad)):
        assert torch.linalg.norm(got - ref) <= 1e-5 * torch.linalg.norm(ref)
    torch.testing.assert_close(b.grad, g.sum(dim=(0, 2, 3)), rtol=0, atol=1e-5)


def test_lbm_reference_shows_each_interval():
    """``lbm_reference``'s ``on_interval`` sees each interval's host field;
    the last is the one returned (the far extrapolation keeps the truth's
    R2 and L2 at each interval)."""
    cfg = SimConfig(nx=32, ny=32, reynolds=100.0, collision="srt", max_steps=30,
                    report_interval=10, convergence_tol=1e-12)
    seen = []
    u = predict.lbm_reference(cfg, device="cpu",
                              on_interval=lambda steps, f: seen.append((steps, f.copy())))
    assert [s for s, _ in seen] == [10, 20, 30]
    np.testing.assert_array_equal(seen[-1][1], u)
    assert not np.array_equal(seen[0][1], u)


def test_precision_probe_stops_where_the_sweep_stops(tmp_path):
    """``scripts/torch_datagen_precision.py``'s copy 0 of a chunk stops at
    the step at which ``torch_datagen_full.py`` stops the same chunk (it
    reads the sweep's own loop), copy 1 runs each cavity at one unit in the
    last place more of float32 omega, and each copy's trace is kept."""
    small = ["--grid", "32", "--report-interval", "20", "--tol", "2e-2", "--n-cav", "3",
             "--device", "cpu"]
    out = tmp_path / "precision.json"
    probe = _script("torch_datagen_precision")
    assert probe.main([*small, "--chunks", "100", "--variants", "2", "--steps", "200",
                       "--sweep-cap", "200", "--out", str(out)]) == 0
    assert _script("torch_datagen_full").main(
        [*small, "--max-steps", "200", "--re-start", "100", "--re-stop", "130",
         "--out", str(tmp_path / "sweep")]) == 0
    rec = json.loads(out.read_text())["chunks"]["100"]
    (chunk,) = _chunks(tmp_path / "sweep").values()
    first, second = rec["copies"]
    assert first["stop"] == int(chunk["steps"]) < 200 and first["stopped_in"] == "sweep"
    assert first["omega"] == [float(np.float32(SimConfig(nx=32, ny=32, reynolds=r).omega))
                              for r in (100.0, 110.0, 120.0)]
    assert second["omega"] == [float(np.nextafter(np.float32(w), np.float32(2.0)))
                               for w in first["omega"]]
    assert rec["jax"] == {"steps": 3_000_000, "converged": 0, "of": 7}
    assert len(first["worst_log10"]) == rec["steps_run"] // 20 - 1


# --- the gate at the default tolerance ----------------------------------------

GATE = dict(nx=16, ny=16, reynolds=1000.0, collision="srt", turbulence="smagorinsky",
            precision="float32", report_interval=100, convergence_tol=1e-7)
GATE_RE, GATE_COPIES = 6.0, 8


def test_gate_at_the_default_tolerance_reads_the_last_bits():
    """The datagen rule at ``datagen_full.py``'s tolerance (1e-7) and the
    default ``convergence_hits`` (5), on a cavity (16^2, Re 6) whose flow
    settles in a few hundred steps and whose |d mean u| / u_lid then
    wanders about the tolerance, as the 384^2 chunks' do near their stop:
    JAX's own ``generate_dataset`` on the CPU stops eight copies whose
    float32 omegas lie one unit in the last place apart
    (``torch_datagen_precision.shifted_re``; each copy gated by its
    ``gate``) more than two checks apart, past
    ``torch_check_dataset.py``'s bound; and the port's sweep of the same
    cavity reads each check's mean u within 2e-8 of JAX's (mean u 1.2e-3;
    2.5 times the 8e-9 change a check must stay under: the two differ by
    the noise the gate reads, with no drift)."""
    from latticeboltzmannsimulations_torch.ml import datagen
    from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen

    probe = _script("torch_datagen_precision")
    jcfg = JConfig(**GATE, max_steps=4_000).validate()
    res = np.array([probe.shifted_re(jcfg, GATE_RE, k) for k in range(GATE_COPIES)])
    jtrace, observe = [], jdatagen._batched_observables

    def spy(cfg):
        obs = observe(cfg)

        def read(state):
            rho, u = obs(state)
            jtrace.append(np.asarray(u).mean(axis=(1, 2, 3), dtype=np.float64))
            return rho, u
        return read

    mp = pytest.MonkeyPatch()
    mp.setattr(jdatagen, "_batched_observables", spy)
    jdatagen.generate_dataset(jcfg, res, batch_size=GATE_COPIES)
    mp.undo()
    checks = jcfg.max_steps // jcfg.report_interval
    jtrace = np.array(jtrace[:checks])          # the last read is the final field's
    stops = [probe.gate(jtrace[:, [k]], jcfg, jcfg.max_steps)["stop"]
             for k in range(GATE_COPIES)]
    print(f"JAX's stops of the {GATE_COPIES} copies: {stops}")
    assert all(s is not None for s in stops)
    assert max(stops) - min(stops) > 2 * jcfg.report_interval

    cfg = SimConfig(**GATE, max_steps=1_000).validate()
    ttrace, mean_u = [], datagen._mean_u
    mp.setattr(datagen, "_mean_u", lambda u: ttrace.append(mean_u(u)) or ttrace[-1])
    datagen.generate_dataset(cfg, res[:1], batch_size=1, device="cpu")
    mp.undo()
    got = np.array(ttrace)[:, 0]
    np.testing.assert_allclose(got, jtrace[:len(got), 0], rtol=0, atol=2e-8)


# --- the float32 arithmetics against float64 -----------------------------------

GATE_ARITH_COPIES, GATE_ARITH_STEPS = 32, 2_400


def _sweep_trace(run, cfg, res) -> np.ndarray:
    """Each copy's mean u at every check of ``run(cfg, res)``, a sweep of
    every copy in one batch with a tolerance nothing meets (so every check
    is read), through the hook ``run`` installs: (checks, copies)."""
    trace = []
    run(dataclasses.replace(cfg, convergence_tol=1e-30), res, trace.append)
    return np.array(trace[:cfg.max_steps // cfg.report_interval])


def _jax_sweep(cfg, res, read):
    from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen

    observe = jdatagen._batched_observables

    def spy(c):
        obs = observe(c)

        def each(state):
            rho, u = obs(state)
            read(np.asarray(u).mean(axis=(1, 2, 3), dtype=np.float64))
            return rho, u
        return each

    mp = pytest.MonkeyPatch()
    mp.setattr(jdatagen, "_batched_observables", spy)
    try:
        jdatagen.generate_dataset(cfg, res, batch_size=len(res))
    finally:
        mp.undo()


def _port_sweep(cfg, res, read):
    from latticeboltzmannsimulations_torch.ml import datagen

    mean_u = datagen._mean_u
    mp = pytest.MonkeyPatch()
    mp.setattr(datagen, "_mean_u", lambda u: read(mean_u(u)) or mean_u(u))
    try:
        datagen.generate_dataset(cfg, res, batch_size=len(res), device="cpu")
    finally:
        mp.undo()


def test_float32_sweeps_against_float64_xla_reads_the_gate_noisier():
    """32 copies of the gate's cavity (16^2, Re 6, omega k units in the
    last place apart), 2 400 steps, each copy's mean u at every check of
    JAX's float32 sweep (jitted: XLA on the CPU) and of the port's (the
    plain batched engine on the CPU, the card's arithmetic) against JAX's
    float64 sweep of the same copies.  Measured: both deviate from float64
    alike, RMS 6.66e-9 (JAX) and 6.09e-9 (the port), mean -4.55e-9 and
    -4.49e-9; but XLA's arithmetic moves mean u more from check to check
    (the deviation of the change per check, RMS 7.01e-9 against 5.28e-9),
    so JAX's copies stop later (median 2 200 steps against 1 500; Mann-
    Whitney two-sided p 3.2e-4, a copy unstopped by 2 400 ranked last).
    The port is not quieter than float64 allows: XLA's contracted
    equilibrium is noisier (``test_first_stage_that_differs_is_xlas_fma``)."""
    from scipy.stats import mannwhitneyu

    probe = _script("torch_datagen_precision")
    jcfg = JConfig(**GATE, max_steps=GATE_ARITH_STEPS).validate()
    res = np.array([probe.shifted_re(jcfg, GATE_RE, k) for k in range(GATE_ARITH_COPIES)])
    j64 = _sweep_trace(_jax_sweep, dataclasses.replace(
        JConfig(**{**GATE, "precision": "float64"}, max_steps=GATE_ARITH_STEPS).validate()), res)
    j32 = _sweep_trace(_jax_sweep, jcfg, res)
    t32 = _sweep_trace(_port_sweep, SimConfig(**GATE, max_steps=GATE_ARITH_STEPS).validate(),
                       res)
    assert j32.shape == t32.shape == j64.shape == (24, GATE_ARITH_COPIES)

    def deviation(trace):
        d = trace - j64
        change = np.diff(trace, axis=0) - np.diff(j64, axis=0)
        return (float(np.sqrt((d ** 2).mean())), float(d.mean()),
                float(np.sqrt((change ** 2).mean())))

    def stops(trace):
        return [probe.gate(trace[:, [k]], jcfg, GATE_ARITH_STEPS)["stop"]
                or GATE_ARITH_STEPS + jcfg.report_interval for k in range(GATE_ARITH_COPIES)]

    (j_rms, j_mean, j_change), (t_rms, t_mean, t_change) = deviation(j32), deviation(t32)
    j_stops, t_stops = stops(j32), stops(t32)
    p = mannwhitneyu(j_stops, t_stops, alternative="two-sided").pvalue
    print(f"against float64: JAX RMS {j_rms:.3e} mean {j_mean:.3e} change {j_change:.3e}; "
          f"port RMS {t_rms:.3e} mean {t_mean:.3e} change {t_change:.3e}; stops JAX "
          f"{sorted(j_stops)} port {sorted(t_stops)}; Mann-Whitney p {p:.3g}")
    assert 3e-9 < t_rms < 1e-8 and 3e-9 < j_rms < 1e-8
    assert 0.8 < t_rms / j_rms <= 1.0
    assert j_mean < 0 and t_mean < 0 and abs(t_mean / j_mean - 1) < 0.1
    assert t_change < 0.85 * j_change
    assert np.median(j_stops) >= np.median(t_stops) + 3 * jcfg.report_interval
    assert p < 1e-2


def test_first_stage_that_differs_is_xlas_fma():
    """One step of the gate's cavity from the same float32 state, stage by
    stage: the gather with the NEBB walls, the moments and ``u = m / rho``
    of the port equal JAX's jitted ones bit for bit; the equilibrium is the
    first stage that differs, where XLA on the CPU contracts
    ``1 + 3 cu`` and ``+ 4.5 cu * cu`` into fused multiply-adds (JAX's
    values are that form's bit for bit, the port's the form rounded op by
    op, as the kernels' ``-fmad=false`` build); of the values that differ,
    neither package's is always the float64 value rounded (at this state
    after 300 steps, 33 of 2 304 values differ: JAX's is it for 14, the
    port's for 16).
    Op by op (``jax.disable_jit``) JAX's step equals the port's bit for bit
    over five steps."""
    import importlib

    import jax
    import jax.numpy as jnp
    import torch

    from latticeboltzmannsimulations_torch import engine, lattice
    from latticeboltzmannsimulations_tpu import engine as jengine

    teq = importlib.import_module("latticeboltzmannsimulations_torch.ops.equilibrium")
    jeq = importlib.import_module("latticeboltzmannsimulations_tpu.ops.equilibrium")
    gate = {**GATE, "reynolds": GATE_RE}
    cfg, jcfg = SimConfig(**gate).validate(), JConfig(**gate).validate()
    om = np.float32(cfg.omega)
    step = engine.make_fused_step_omega(cfg)
    state = engine.init_state(cfg, "cpu")
    for _ in range(300):
        state = step(state, torch.tensor(om))
    f0, lid0 = state.f.numpy(), state.rho_lid.numpy()

    g = engine._fused_gather_bc(cfg, state.f, state.rho_lid)
    jg = jax.jit(lambda f, lid: jengine._fused_gather_bc(jcfg, f, lid))(f0, lid0)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    rho, u = engine._fused_macros(cfg, g)
    jrho, ju = jax.jit(lambda g: jengine._fused_macros(jcfg, g))(g.numpy())
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jrho))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))

    feq = teq.equilibrium(rho, u).numpy()
    jfeq = np.asarray(jax.jit(jeq.equilibrium)(rho.numpy(), u.numpy()))
    differ = feq != jfeq
    assert differ.any()

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)

    f32 = np.float32
    ux, uy = u.numpy()
    usqr15 = f32(1.5) * (ux * ux + uy * uy)
    rho_n = rho.numpy()
    forms = {"fma": [], "op by op": []}
    for k in range(lattice.Q):
        cx, cy, w = float(lattice.CX[k]), float(lattice.CY[k]), f32(lattice.W[k])
        cu = (f32(cx) * ux + f32(cy) * uy if cx and cy else f32(cx) * ux if cx
              else f32(cy) * uy if cy else None)
        for form, out in forms.items():
            if cu is None:
                out.append(rho_n * w * (f32(1.0) - usqr15))
            elif form == "fma":
                out.append(rho_n * w * (fma(f32(4.5) * cu, cu, fma(np.full_like(cu, 3.0), cu,
                                                                   np.ones_like(cu)))
                                        - usqr15))
            else:
                out.append(rho_n * w * (f32(1.0) + f32(3.0) * cu + f32(4.5) * cu * cu - usqr15))
    np.testing.assert_array_equal(jfeq, np.stack(forms["fma"]))
    np.testing.assert_array_equal(feq, np.stack(forms["op by op"]))
    r64 = teq.equilibrium(rho.double(), u.double()).numpy().astype(np.float32)
    n, n_jax, n_port = (int(differ.sum()), int((jfeq[differ] == r64[differ]).sum()),
                        int((feq[differ] == r64[differ]).sum()))
    print(f"feq: {n} of {feq.size} values differ; the float64 value rounded: JAX's "
          f"{n_jax}, the port's {n_port}")
    assert 0 < n_jax < n and 0 < n_port < n and n_jax + n_port <= n

    js, ts = jengine.State(jnp.asarray(f0), jnp.asarray(lid0)), state
    jstep = jengine.make_fused_step_omega(jcfg)
    with jax.disable_jit():
        for _ in range(5):
            js, ts = jstep(js, jnp.float32(om)), step(ts, torch.tensor(om))
            np.testing.assert_array_equal(np.asarray(js.f), ts.f.numpy())
            np.testing.assert_array_equal(np.asarray(js.rho_lid), ts.rho_lid.numpy())
