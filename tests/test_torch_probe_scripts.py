"""The last three JAX scripts' counterparts against them on the CPU:
``scripts/torch_probe_fidelity.py`` beside ``probe_fidelity.py`` on the same
runs cut to 32^2 (R2(Ux) and L2, as a fraction, to abs 1e-5, as
``test_torch_validation_scripts.py`` holds the slow gates: two float32
engines), with its gate's references in JAX's current records;
``torch_rollup_validation.py`` beside ``rollup_validation.py`` on one
seeded tree of metrics logs (equal key for key); and
``torch_weak_scaling_cpu.py`` beside ``weak_scaling_cpu.py`` at a cut
block, each mesh's child run in process (the rows' shapes equal, the
overhead by JAX's formula)."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "docs", "artifacts")


def _script(name: str):
    """``scripts/<name>.py`` loaded by path, as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(path: str) -> dict:
    with open(path) as fh:
        return {r["name"]: r for r in json.load(fh)}


def _every(config_cls, interval: int):
    """``config_cls`` with its report interval fixed at ``interval``."""
    def make(**kwargs):
        kwargs["report_interval"] = interval
        return config_cls(**kwargs)
    return make


# --- the fidelity probes ---------------------------------------------------------

def test_probe_runs_are_the_jax_scripts_runs():
    assert _script("torch_probe_fidelity").RUNS == _script("probe_fidelity").RUNS


def test_a_cut_probe_gives_the_jax_scripts_rows(tmp_path, monkeypatch):
    jax_mod, port = _script("probe_fidelity"), _script("torch_probe_fidelity")
    cut = [(name, 32, re, coll, turb, u_lid, 300)
           for name, _, re, coll, turb, u_lid, _ in jax_mod.RUNS]
    monkeypatch.setattr(jax_mod, "RUNS", cut)
    monkeypatch.setattr(port, "RUNS", cut)
    monkeypatch.setattr(jax_mod, "lbt", types.SimpleNamespace(
        SimConfig=_every(jax_mod.lbt.SimConfig, 100)))
    monkeypatch.setattr(port, "REPORT_INTERVAL", 100)
    monkeypatch.setattr(jax_mod, "ART", str(tmp_path / "jax"))
    monkeypatch.setattr(port, "ART", str(tmp_path / "torch"))
    jax_mod.main()
    # the gated rows miss their full-size references at 32^2
    assert port.main(["--device", "cpu"]) == 1
    with open(tmp_path / "jax" / "probes.json") as fh:
        want = json.load(fh)
    with open(tmp_path / "torch" / "probes.json") as fh:
        got = json.load(fh)
    jax_probes = _by_name(port.JAX_PROBES)
    assert [g["name"] for g in got] == [w["name"] for w in want] == [r[0] for r in cut]
    for w, g in zip(want, got):
        assert set(w) <= set(g)
        for key in ("name", "grid", "re", "u_lid", "steps", "converged"):
            assert g[key] == w[key], key
        assert g["steps"] == 300
        assert g["r2_ux"] == pytest.approx(w["r2_ux"], abs=1e-5)
        # L2 as a fraction, as the slow gates' test holds l2_combined
        assert g["l2_pct"] / 100 == pytest.approx(w["l2_pct"] / 100, abs=1e-5)
        assert (g["backend"], g["device"], g["card"]) == ("torch", "cpu", None)
        theirs = jax_probes[g["name"]]
        assert (g["jax_probes_steps"], g["jax_probes_r2_ux"], g["jax_probes_l2_pct"]) == (
            theirs["steps"], theirs["r2_ux"], theirs["l2_pct"])
        assert g["d_probes_l2_pct"] == g["l2_pct"] - theirs["l2_pct"]
    assert [g["ok"] for g in got] == [False, False, None]


def test_the_probe_references_are_current_jax_records():
    port = _script("torch_probe_fidelity")
    jax_record = _by_name(port.JAX_RECORD)
    assert set(port.REFERENCES) == {r[0] for r in port.RUNS}
    assert {name: ref["jax"] for name, ref in port.REFERENCES.items()} == {
        "re400_192_srt": "re400_192_srt", "re1000_512_mrt_long": "re1000_512_mrt_fine",
        "re10000_512_mrt_les": None}
    for ref in port.REFERENCES.values():
        assert ref["jax"] is None or ref["jax"] in jax_record
    # the bounds are torch_validate.py's, unchanged
    validate = _script("torch_validate")
    assert (port.R2_TOL, port.L2_TOL_PCT) == (validate.R2_TOL, validate.L2_TOL_PCT)
    # the 1.5 M cap runs 1.6 M steps in whole 200 000-step intervals: the
    # reference's steps
    (cap,) = [r[6] for r in port.RUNS if r[0] == "re400_192_srt"]
    assert -(-cap // port.REPORT_INTERVAL) * port.REPORT_INTERVAL == jax_record[
        "re400_192_srt"]["steps"]


def _row(name, steps, r2_ux, l2_pct):
    return {"name": name, "steps": steps, "r2_ux": r2_ux, "l2_pct": l2_pct}


def test_the_probe_gate_holds_re400_to_the_ports_record_bit_for_bit():
    port = _script("torch_probe_fidelity")
    jax_record = _by_name(port.JAX_RECORD)
    own = _by_name(os.path.join(ART, "torch", "validation.json"))
    mine = own["re400_192_srt"]
    row = _row("re400_192_srt", mine["steps"], mine["r2_ux"], mine["l2_pct"])
    res = port.gate(row, jax_record, own)
    assert res["ok"] is True and res["own_equal"] is True
    assert res["ref_r2_ux"] == jax_record["re400_192_srt"]["r2_ux"]
    # without the port's record only JAX's bounds hold it
    assert port.gate(row, jax_record, {})["ok"] is True
    for key in ("r2_ux", "l2_pct"):
        seeded = {"re400_192_srt": dict(mine, **{key: math.nextafter(mine[key], math.inf)})}
        res = port.gate(row, jax_record, seeded)
        assert res["ok"] is False and res["own_equal"] is False, key
    seeded = {"re400_192_srt": dict(mine, steps=mine["steps"] + port.REPORT_INTERVAL)}
    assert port.gate(row, jax_record, seeded)["ok"] is False
    # other steps than the reference's run miss it
    assert port.gate(dict(row, steps=1_400_000), jax_record, {})["ok"] is False


def test_the_probe_gate_bounds_and_the_ungated_row():
    port = _script("torch_probe_fidelity")
    jax_record = _by_name(port.JAX_RECORD)
    ref = jax_record["re1000_512_mrt_fine"]
    near = _row("re1000_512_mrt_long", 8_000_000, ref["r2_ux"] - 0.9e-3, ref["l2_pct"] + 0.45)
    assert port.gate(near, jax_record, {})["ok"] is True
    assert port.gate(dict(near, r2_ux=ref["r2_ux"] - 1.1e-3), jax_record, {})["ok"] is False
    assert port.gate(dict(near, l2_pct=ref["l2_pct"] - 0.55), jax_record, {})["ok"] is False
    les = port.gate(_row("re10000_512_mrt_les", 3_000_000, 0.99, 6.0), jax_record, {})
    assert les["ok"] is None and les["ref_run"] is None and "not gated" in les["reference"]


# --- the validation rollup -------------------------------------------------------

def _log(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def _seed_runs(root):
    """Runs with and without a final row, an empty log, a note's run, and a
    directory the glob skips; the port's records of two runs beside them."""
    interval = {"t": 1.0, "mean_u": 1e-3, "backend": "cuda-pull", "r2_ux": 0.9, "l2": 0.1}
    final = {"t": 2.0, "final": True, "converged": False}
    _log(root / "re1000_512_tang" / "re1000_512_tang_metrics.jsonl", [
        dict(interval, step=100_000),
        dict(final, step=4_000_000, mlups=47611.08374865371, r2_ux=0.9993834083420249,
             l2=0.019984592965456467)])
    _log(root / "re400_192_srt" / "re400_192_srt_metrics.jsonl", [
        dict(interval, step=200_000, backend="torch"),
        dict(final, step=1_600_000, mlups=18308.515635936874, r2_ux=0.9998623148949096,
             l2=0.010382429679173986)])
    _log(root / "re3200_384_mrt" / "re3200_384_mrt_metrics.jsonl",
         [dict(interval, step=100_000)])
    _log(root / "re5000_384_mrt_les" / "re5000_384_mrt_les_metrics.jsonl", [])
    _log(root / "other" / "other_metrics.jsonl", [dict(final, step=1, mlups=1.0, r2_ux=1.0, l2=0.0)])
    art = root.parent.parent
    (art / "validation.json").write_text(json.dumps([
        {"name": "re1000_512_tang", "backend": "cuda-pull", "card": None},
        {"name": "re400_192_srt", "backend": "cuda-pull", "card": None}]))
    # a probe's row over the validation row of the same name
    (art / "probes.json").write_text(json.dumps([
        {"name": "re400_192_srt", "backend": "torch",
         "card": "NVIDIA H100 80GB HBM3, 700.00 W"}]))


def test_the_rollup_gives_the_jax_scripts_rows(tmp_path, monkeypatch):
    jax_mod, port = _script("rollup_validation"), _script("torch_rollup_validation")
    runs = tmp_path / "torch" / "runs" / "validation"
    _seed_runs(runs)
    shutil.copytree(runs, tmp_path / "jax")
    monkeypatch.setattr(jax_mod, "ART", str(tmp_path / "jax"))
    monkeypatch.setattr(port, "ART", str(tmp_path / "torch"))
    assert jax_mod.main() == 0 and port.main() == 0
    with open(tmp_path / "jax" / "validation_rollup.json") as fh:
        want = json.load(fh)
    with open(tmp_path / "torch" / "validation_rollup.json") as fh:
        got = json.load(fh)
    ours = [r for r in got if r["port"] is not None]
    assert [{k: r[k] for k in w} for r, w in zip(ours, want)] == want
    assert [r["run"] for r in ours] == ["re1000_512_tang", "re400_192_srt"]
    tang, srt = ours
    assert tang["note"] == jax_mod.NOTES["re1000_512_tang"]
    assert (tang["port"], tang["backend"], tang["card"]) == (
        os.path.join("runs", "validation", "re1000_512_tang"), "cuda-pull", None)
    assert (srt["backend"], srt["card"]) == ("torch", "NVIDIA H100 80GB HBM3, 700.00 W")
    with open(port.JAX_ROLLUP) as fh:
        jax_rows = {r["run"]: r for r in json.load(fh)}
    for r in ours:
        theirs = jax_rows[r["run"]]
        assert (r["jax_steps"], r["jax_r2_ux"], r["jax_l2_pct"], r["jax_mlups"]) == (
            theirs["steps"], theirs["r2_ux"], theirs["l2_pct"], theirs["mlups"])
        assert r["d_l2_pct"] == round(r["l2_pct"] - theirs["l2_pct"], 3)
    absent = [r for r in got if r["port"] is None]
    assert [r["run"] for r in absent] == sorted(port.NO_SCRIPT)
    assert all(r["jax_steps"] == jax_rows[r["run"]]["steps"] for r in absent)


def test_the_ports_scripts_make_every_jax_rollup_run_a_script_makes():
    port = _script("torch_rollup_validation")
    with open(port.JAX_ROLLUP) as fh:
        jax_runs = {r["run"] for r in json.load(fh)}
    ours = ({r[0] for r in _script("torch_validate").RUNS}
            | {r[0] for r in _script("torch_probe_fidelity").RUNS})
    assert len(ours) == 13 and len(port.NO_SCRIPT) == 6
    assert ours | set(port.NO_SCRIPT) == jax_runs
    assert port.NOTES == _script("rollup_validation").NOTES
    # no JAX script makes the six rows the port lists without a run
    jax_scripted = ({r[0] for r in _script("validate_tpu").RUNS}
                    | {r[0] for r in _script("r5_validate").RUNS}
                    | {r[0] for r in _script("probe_fidelity").RUNS})
    assert jax_scripted == ours and not jax_scripted & set(port.NO_SCRIPT)


# --- weak scaling ----------------------------------------------------------------

def _children_in_process(monkeypatch, mod, run_child):
    """``mod``'s ``subprocess.run`` of a child runs ``run_child(cmd)`` in
    this process, its stdout captured."""
    def run(cmd, **_kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_child(cmd)
        return subprocess.CompletedProcess(cmd, rc, buf.getvalue(), "")
    monkeypatch.setattr(mod, "subprocess", types.SimpleNamespace(run=run))


def test_weak_scaling_rows_carry_the_jax_scripts_keys(tmp_path, monkeypatch):
    jax_mod, port = _script("weak_scaling_cpu"), _script("torch_weak_scaling_cpu")
    for mod, name in ((jax_mod, "jax"), (port, "torch")):
        monkeypatch.setattr(mod, "BLOCK", 16)
        monkeypatch.setattr(mod, "STEPS", 4)
        monkeypatch.setattr(mod, "REPS", 1)
        monkeypatch.setattr(mod, "MESHES", [(1, 1), (2, 2)])
        monkeypatch.setattr(mod, "ART", str(tmp_path / name))
    os.makedirs(tmp_path / "jax")
    _children_in_process(monkeypatch, jax_mod,
                         lambda cmd: jax_mod.child(cmd[cmd.index("--child") + 1]))
    _children_in_process(monkeypatch, port, lambda cmd: port.main(cmd[2:]))
    monkeypatch.setattr(sys, "argv", ["weak_scaling_cpu.py"])
    assert jax_mod.main() == 0
    assert port.main(["--device", "cpu"]) == 0
    with open(tmp_path / "jax" / "weak_scaling_cpu.json") as fh:
        want = json.load(fh)["rows"]
    with open(tmp_path / "torch" / "weak_scaling_cpu.json") as fh:
        table = json.load(fh)
    assert set(table) == {"cpu"}
    got = table["cpu"]["rows"]
    assert table["cpu"]["threads"] == torch.get_num_threads() and table["cpu"]["card"] is None
    assert len(got) == len(want) == 2
    base = got[0]["ns_per_site_step"]
    for w, g in zip(want, got):
        assert set(w) <= set(g)
        for key in ("mesh", "grid", "per_shard", "steps", "devices"):
            assert g[key] == w[key], key
        assert (g["route"], g["control_route"]) == ("sharded", "torch")
        assert g["equal_to_control"] is True
        assert g["overhead_vs_1x1_pct"] == round(100.0 * (g["ns_per_site_step"] / base - 1.0), 1)
        assert g["jax_ns_per_site_step"] > 0


def test_weak_scaling_refuses_a_sharded_state_that_differs(monkeypatch):
    port = _script("torch_weak_scaling_cpu")
    assert port.measure(2, 2, "cpu", steps=4, block=16, reps=1)["equal_to_control"] is True
    unshard = port.unshard_state

    def one_ulp_off(state, device):
        out = unshard(state, device)
        out.f[4, 3, 5] = torch.nextafter(out.f[4, 3, 5], torch.tensor(2.0))
        return out

    monkeypatch.setattr(port, "unshard_state", one_ulp_off)
    with pytest.raises(RuntimeError, match="differs"):
        port.measure(2, 2, "cpu", steps=4, block=16, reps=1)


@pytest.mark.parametrize("script", ["torch_probe_fidelity", "torch_weak_scaling_cpu"])
def test_the_scripts_take_the_card_by_default_and_refuse_without_one(script, monkeypatch):
    mod = _script(script)
    ran = []
    monkeypatch.setattr(mod, "RUNS" if script == "torch_probe_fidelity" else "MESHES", ran)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        mod.main([])
    with pytest.raises((AssertionError, RuntimeError)):
        mod.main(["--device", "cuda"])
