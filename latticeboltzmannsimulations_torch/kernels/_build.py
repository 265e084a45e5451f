"""Build the CUDA sources with ``nvcc`` into a shared library with a plain C
interface, and bind it through ``ctypes``.

The library is built at first use, on the machine with the card, into
``latticeboltzmannsimulations_torch/_build/`` (git-ignored), under a name
keyed by a hash of the source and the flags: an edited source builds anew,
an unchanged one loads the library already there.  Plain ``nvcc`` on one
file with no PyTorch headers takes seconds; nothing here needs ``ninja``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pull_step.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under the CUDA home that PyTorch
    finds (``CUDA_HOME`` or ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"pull_step_{digest.hexdigest()[:16]}.so"


def ensure_built() -> tuple[Path, str | None]:
    """Build the library if it is missing.  Returns its path and nvcc's
    output (with ``-Xptxas -v``: registers and spills per kernel), or None
    when the library was already built."""
    path = library_path()
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library, with every argument type declared (an undeclared
    pointer would be passed as a 32-bit int and cut)."""
    path, _ = ensure_built()
    lib = ctypes.CDLL(str(path))
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lbm_pull_step.argtypes = [
        p, p, p, p, p,              # f, rho_lid_prev, cs2_plane, f_out, rho_lid_out
        i, i,                       # nx, ny
        fl, fl, fl, fl, fl, fl,     # u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus
        fl, fl, fl,                 # omega_e, omega_eps, omega_q
        i, i, fl,                   # collision, les, smag_coef
        p,                          # stream
    ]
    lib.lbm_pull_step.restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib
