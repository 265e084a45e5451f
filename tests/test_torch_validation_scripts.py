"""The port's slow gates and flagship validation runs
(``scripts/torch_slow_gates.py``, ``scripts/torch_validate.py``) hold the
JAX package's scripts' configurations and bounds unchanged, and a reduced
gate gives the JAX script's record on the CPU."""

from __future__ import annotations

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    """``scripts/<name>.py`` loaded by path, as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_slow_gates_are_the_jax_scripts_gates():
    assert _script("torch_slow_gates").GATES == _script("slow_gates").GATES


def test_validation_runs_are_the_jax_scripts_runs():
    # validate_tpu.py runs every row at report_interval=100_000 on the NEBB
    # lid (scripts/validate_tpu.py:33-36); then every row of r5_validate.py
    # (the BC-closure controls, the re-measured rollup rows, the
    # fine-interval runs and config 3), each with its own cap and interval
    flagship = [(name, nx, re, coll, turb, "nebb", steps, 100_000)
                for name, nx, re, coll, turb, steps in _script("validate_tpu").RUNS]
    r5 = _script("r5_validate").RUNS
    assert "re10000_1024_mrt_les" in [r[0] for r in r5]
    assert _script("torch_validate").RUNS == flagship + r5


def _every(config_cls, interval: int):
    """``config_cls`` with its report interval fixed at ``interval``."""
    def make(**kwargs):
        kwargs["report_interval"] = interval
        return config_cls(**kwargs)
    return make


def test_a_reduced_gate_gives_the_jax_record(tmp_path, monkeypatch):
    j_gates, t_gates = _script("slow_gates"), _script("torch_slow_gates")
    for mod in (j_gates, t_gates):
        monkeypatch.setattr(mod, "SimConfig", _every(mod.SimConfig, 100))
    gate = ("re100_32_srt", dict(nx=32, ny=32, reynolds=100.0, collision="srt"),
            300, 0.9, 0.3, False)
    want = j_gates.run_gate(*gate, str(tmp_path / "jax"))
    got = t_gates.run_gate(*gate, str(tmp_path / "torch"), device="cpu")
    for key in ("gate", "steps", "converged", "require_converged", "r2_min", "l2_max",
                "ok"):
        assert got[key] == want[key], key
    assert got["steps"] == 300 and got["backend"] == "torch" and got["device"] == "cpu"
    assert got["r2_ux"] == pytest.approx(want["r2_ux"], abs=1e-5)
    assert got["l2_combined"] == pytest.approx(want["l2_combined"], abs=1e-5)
