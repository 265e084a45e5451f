"""The port and chip_smoke.py import neither JAX (nor flax or optax) nor the
JAX package: the machine with the card has none of them."""

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
import chip_smoke
bad = sorted(k for k in sys.modules
             if k in ("jax", "flax", "optax") or k.startswith(("jax.", "jaxlib", "flax.",
                                                               "optax.", "{JAX_PACKAGE}")))
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
             + [REPO / "chip_smoke.py"])
    names = {p.name for p in files}
    assert {"tblock.py", "push.py", "tblock_step.cu", "push_step.cu",
            "lbm_cell.cuh", "boundary.py", "mesh.py", "halo.py", "pull_sharded.py",
            "tblock_sharded.py", "pull_sharded_step.cu",
            "tblock_sharded_step.cu", "multihost.py", "halo_rdma.py",
            "halo_exchange.cu", "datagen.py", "models.py", "predict.py",
            "scaling.py", "train.py", "checkpoint.py", "cli.py", "__main__.py",
            "vtk.py", "viz.py", "vortex.py", "engine.py", "lbm_kernel.cpp"} <= names
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    for path in files:
        text = path.read_text()
        assert JAX_PACKAGE not in text, path
        assert not jax_import.search(text), path
