"""The port's headline bench (``latticeboltzmannsimulations_torch.bench``):
the process contract of ``tests/test_bench_contract.py`` on the CPU when
asked, no fallback without a card, and the timed work the same as the
plain runner's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from latticeboltzmannsimulations_torch import bench, engine
from latticeboltzmannsimulations_torch.config import SimConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"LBM_BENCH_N": "64", "LBM_BENCH_CHUNK": "5", "LBM_BENCH_CHUNKS": "1"}


def _bench(*args: str, **env_extra: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, **SMALL, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "latticeboltzmannsimulations_torch", "bench", *args],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)


def test_bench_prints_one_json_record_on_the_cpu_when_asked():
    out = _bench("--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}, rec
    assert rec["unit"] == "MLUPS" and rec["value"] > 0, rec
    assert "64x64" in rec["metric"] and "(torch)" in rec["metric"], rec


def test_bench_without_a_card_fails_and_prints_nothing():
    out = _bench(CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert out.stdout == "", out.stdout
    assert "no CUDA device" in out.stderr


def test_measure_times_the_plain_runners_steps():
    cfg = SimConfig(nx=32, ny=32, reynolds=5000.0, collision="mrt",
                    precision="float32").validate()
    res = bench.measure(cfg, "auto", steps_per_chunk=4, n_chunks=2, device="cpu")
    assert (res["route"], res["steps"], res["ms_per_step"]) == ("torch", 8, None)
    assert res["mlups"] > 0 and res["seconds"] > 0
    runner = engine.make_scan_runner(cfg, 4, "cpu")
    want = engine.init_state(cfg, "cpu")
    for _ in range(3):                  # the warm-up chunk and two timed ones
        want = runner(want)
    assert torch.equal(res["state"].f, want.f)
    assert torch.equal(res["state"].rho_lid, want.rho_lid)
