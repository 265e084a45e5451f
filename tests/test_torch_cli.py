"""The port's command line on the CPU (``--device cpu``), against the JAX
package's ``cli.main``, and ``simulate``'s profiler trace.

``run`` writes what the JAX CLI's ``run`` writes (metrics, dashboards, VTK,
checkpoints) and its summary agrees with JAX's on ``jit`` to 1e-10 in
float64; ``datagen``, ``train`` and ``predict`` run end to end at 48^2 with
``cnn_one``; a mesh runs on the CPU; ``bench`` exits non-zero."""

import json
import os

import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import cli as t_cli
from latticeboltzmannsimulations_torch import sim as t_sim
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_tpu import cli as j_cli

RUN = ["run", "--nx", "48", "--re", "100", "--collision", "srt",
       "--max-steps", "300", "--interval", "100", "--precision", "float64"]


@pytest.fixture
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _vtr_arrays(path) -> list:
    """The arrays of a ``.vtr`` file's appended block, as raw bytes, in
    order (each behind its u32 length)."""
    raw = open(path, "rb").read()
    block = raw[raw.index(b'<AppendedData encoding="raw">\n_') + 31:]
    out = []
    while not block.startswith(b"\n  </AppendedData>"):
        n = int(np.frombuffer(block[:4], np.uint32)[0])
        out.append(block[4:4 + n])
        block = block[4 + n:]
    return out


def test_cli_run_full_outputs_match_jax(tmp_path, capsys, one_thread):
    out, j_out = str(tmp_path / "o"), str(tmp_path / "j")
    rc = t_cli.main([*RUN, "--out", out, "--plots", "--vtk", "--checkpoint-every", "100",
                     "--backend", "torch", "--device", "cpu"])
    assert rc == 0
    summary = _last_json(capsys)
    files = os.listdir(out)
    assert "ldc_metrics.jsonl" in files and os.path.isdir(os.path.join(out, "ckpt"))
    assert sorted(f for f in files if f.endswith(".png")) == [
        "ldc_000100.png", "ldc_000200.png", "ldc_000300.png"]
    assert sorted(f for f in files if f.endswith(".vtr")) == ["ldc.0.vtr", "ldc.1.vtr",
                                                              "ldc.2.vtr"]
    assert summary["steps"] == 300 and summary["mlups"] > 0
    assert summary["backend"] == "torch"

    assert j_cli.main([*RUN, "--out", j_out, "--vtk", "--backend", "jit"]) == 0
    want = _last_json(capsys)
    assert (summary["steps"], summary["converged"]) == (want["steps"], want["converged"])
    for key in ("r2_ux", "l2_combined"):
        assert summary[key] == pytest.approx(want[key], abs=1e-10), key
    # float32 files of a float64 run: the arrays agree to a float32 rounding
    for name in ("ldc.0.vtr", "ldc.2.vtr"):
        a, b = (_vtr_arrays(os.path.join(d, name)) for d in (out, j_out))
        assert [len(x) for x in a] == [len(x) for x in b] and a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_allclose(np.frombuffer(x, np.float32),
                                       np.frombuffer(y, np.float32), rtol=2e-7, atol=1e-9)


def test_cli_datagen_train_predict(tmp_path, capsys, one_thread):
    data, weights, out = (str(tmp_path / d) for d in ("data", "weights", "out"))
    assert t_cli.main(["datagen", "--grid", "48", "--batch", "2", "--re-start", "100",
                       "--re-stop", "140", "--re-step", "10", "--max-steps", "200",
                       "--interval", "100", "--mesh", "2x1", "--device", "cpu",
                       "--out", data]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"saved 4 runs to {data}"
    assert sorted(os.listdir(data)) == ["Re_range.npy", "f_final.npy", "feq_initial.npy",
                                        "u_final.npy"]
    assert np.load(os.path.join(data, "f_final.npy")).shape == (4, 9, 48, 48)
    assert t_cli.main(["train", "--preset", "cnn_one", "--data", data, "--out", weights,
                       "--epochs", "1", "--device", "cpu"]) == 0
    assert sorted(os.listdir(weights)) == [f"cnn_one_{c}{ext}" for c in "xy"
                                           for ext in (".json", ".pt", "_loss.png")]
    assert t_cli.main(["predict", "--preset", "cnn_one", "--data", data,
                       "--weights", weights, "--re", "100", "--max-steps", "200",
                       "--out", out, "--device", "cpu"]) == 0
    metrics = _last_json(capsys)
    assert metrics["figure"] == os.path.join(out, "cnn_one_predict_Re100.png")
    assert os.path.exists(metrics["figure"])
    assert {"r2_lbm_ux", "r2_cnn_ux", "l2_lbm", "l2_cnn", "cnn_vs_lbm_l2"} <= set(metrics)
    assert metrics["r2_lbm_ux"] > 0.9


def test_cli_mesh_runs_the_sharded_engine_on_the_cpu(tmp_path, capsys):
    assert t_cli.main(["run", "--nx", "32", "--re", "100", "--max-steps", "100",
                       "--interval", "50", "--mesh", "2x2", "--device", "cpu",
                       "--out", str(tmp_path)]) == 0
    summary = _last_json(capsys)
    assert summary["backend"] == "sharded" and summary["steps"] == 100


def test_cli_refuses_a_mesh_larger_than_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 devices but only 1"):
        t_cli.main(["datagen", "--mesh", "2x1"])


def test_cli_bench_exits_nonzero(capsys):
    assert t_cli.main(["bench"]) != 0
    assert "no headline benchmark" in capsys.readouterr().err


def test_cli_takes_the_port_routes_and_devices_only(tmp_path, capsys):
    for args in (["run", "--backend", "pallas"], ["run", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            t_cli.main(args)
    assert "invalid choice" in capsys.readouterr().err
    # a kernel route off the card is refused by the routing, not run plainly
    with pytest.raises(ValueError, match="CUDA device"):
        t_cli.main(["run", "--nx", "16", "--backend", "cuda-pull", "--device", "cpu",
                    "--out", str(tmp_path)])


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    cfg = TConfig(nx=16, ny=16, reynolds=100.0, max_steps=40, report_interval=20)
    prof = tmp_path / "prof"
    plain = t_sim.simulate(cfg, t_sim.SimOptions(out_dir=str(tmp_path / "a"), verbose=False),
                           device="cpu")
    traced = t_sim.simulate(cfg, t_sim.SimOptions(out_dir=str(tmp_path / "b"), verbose=False,
                                                  profile_dir=str(prof)), device="cpu")
    assert (traced.steps, traced.r2_ux) == (plain.steps, plain.r2_ux)
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    chunks = [e for e in events if e.get("name") == t_sim.CHUNK_SPAN]
    assert len(chunks) == 1 and chunks[0]["dur"] > 0
