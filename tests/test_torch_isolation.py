"""The port, its scripts (``scripts/torch_*.py``) and chip_smoke.py import
neither JAX (nor flax, optax or msgpack) nor the JAX package: the machine
with the card has none of them.
The port's reader of flax's msgpack files works with all four blocked."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "latticeboltzmannsimulations_torch"
JAX_PACKAGE = "latticeboltzmannsimulations_tpu"

_PROBE = f"""
import importlib, pkgutil, sys
import latticeboltzmannsimulations_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import latticeboltzmannsimulations_torch.bench
import chip_smoke
sys.path.insert(0, "scripts")
for name in ("torch_bench_backends", "torch_slow_gates", "torch_validate"):
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "flax", "optax", "msgpack")
             or k.startswith(("jax.", "jaxlib", "flax.", "optax.", "msgpack.",
                              "{JAX_PACKAGE}")))
print("imported:", bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_name_jax_or_the_jax_package():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
             + sorted(PORT.rglob("*.cuh")) + sorted(PORT.rglob("*.cpp"))
             + sorted((REPO / "scripts").glob("torch_*.py")) + [REPO / "chip_smoke.py"])
    names = {p.name for p in files}
    assert {"tblock.py", "push.py", "tblock_step.cu", "push_step.cu",
            "lbm_cell.cuh", "boundary.py", "mesh.py", "halo.py", "pull_sharded.py",
            "tblock_sharded.py", "pull_sharded_step.cu",
            "tblock_sharded_step.cu", "multihost.py", "halo_rdma.py",
            "halo_exchange.cu", "datagen.py", "models.py", "predict.py",
            "scaling.py", "train.py", "checkpoint.py", "cli.py", "__main__.py",
            "vtk.py", "viz.py", "vortex.py", "engine.py", "lbm_kernel.cpp",
            "flax_msgpack.py", "bench.py", "torch_bench_backends.py",
            "torch_slow_gates.py", "torch_validate.py"} <= names
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|msgpack)\b", re.M)
    for path in files:
        text = path.read_text()
        assert JAX_PACKAGE not in text, path
        assert not jax_import.search(text), path


_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "{pkg}"):
    sys.modules[name] = None  # an import of any of them now raises
from latticeboltzmannsimulations_torch.ml import flax_msgpack, train
tree = flax_msgpack.load(sys.argv[1])
params, meta = train.load_weights("cnn_nine", "x", sys.argv[2])
print(len(tree), len(params), sorted(meta))
"""


def test_flax_files_read_with_jax_flax_and_msgpack_blocked():
    """``ml.flax_msgpack`` and ``load_weights`` read a tracked weight file in
    a process where importing JAX, flax, optax, msgpack or the JAX package
    raises."""
    weights = REPO / "docs" / "artifacts" / "ml_full" / "cnn_nine"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(pkg=JAX_PACKAGE),
         str(weights / "cnn_nine_x.msgpack"), str(weights)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_layers, n_tensors, meta = proc.stdout.split(maxsplit=2)
    assert int(n_tensors) == 2 * int(n_layers) > 0
    assert "scalers" in meta
