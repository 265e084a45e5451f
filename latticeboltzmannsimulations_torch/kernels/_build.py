"""Build the CUDA sources with ``nvcc`` into one shared library with a plain
C interface, and bind it through ``ctypes``.

The library is built at first use, on the machine with the card, into
``latticeboltzmannsimulations_torch/_build/`` (git-ignored), under a name
keyed by a hash of every source and header in ``csrc/`` and the flags: an
edited source builds anew, an unchanged tree loads the library already
there.  Each ``.cu`` file is compiled by its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects; no file includes
PyTorch's headers, so the whole build takes seconds and needs no ``ninja``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no multiply and add is contracted into an FMA, so the kernels
# round every operation as the plain PyTorch engine does (each op its own
# IEEE rounding); csrc/lbm_cell.cuh's explicit __fmaf_rn stay FMAs.
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
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
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for path in SOURCES + HEADERS:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lbm_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands all at once; raise with the output of any that
    fails.  Returns their output (with ``-Xptxas -v``: registers and spills
    per kernel)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def ensure_built() -> tuple[Path, str | None]:
    """Build the library if it is missing.  Returns its path and nvcc's
    output, or None when the library was already built."""
    path = library_path()
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        log = _run([[exe, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(SOURCES, objs)])
        lib = Path(tmp) / path.name
        log += _run([[exe, *LINK_FLAGS, "-o", str(lib), *map(str, objs)]])
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    return path, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library, with every argument type declared."""
    path, _ = ensure_built()
    return declare(ctypes.CDLL(str(path)))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of every entry point of
    ``lib`` (an undeclared pointer would be passed as a 32-bit int and
    cut).  Returns ``lib``."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the step's scalars after nx, ny (kernels/pull.py::_scalars)
    physics = [
        fl, fl, fl, fl, fl, fl,     # u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus
        fl, fl, fl,                 # omega_e, omega_eps, omega_q
        i, i, fl,                   # collision, les, smag_coef
    ]
    scalars = [i, i, *physics]      # nx, ny, then the physics
    lib.lbm_pull_step.argtypes = [
        p, p, p, p, p,              # f, rho_lid_prev, cs2_plane, f_out, rho_lid_out
        *scalars,
        p,                          # stream
    ]
    lib.lbm_pull_step_tangential.argtypes = [
        p, p, p, p,                 # f, cs2_plane, f_out, rho_lid_out
        *scalars,
        fl, fl, fl, fl,             # the lid's 0.5 u, (2/3) u, (1/6) u, u / 12
        p,                          # stream
    ]
    lib.lbm_pull_sweep_step.argtypes = [
        p, p, p, p,                 # f, rho_lid_prev, f_out, rho_lid_out
        i, p,                       # n_cav, table of n_cav float4 (pull.cavity_table)
        i, i, fl, fl,               # nx, ny, u_lid, lid_mom
        fl, fl, fl,                 # omega_e, omega_eps, omega_q
        i, i, fl,                   # collision, les, smag_coef
        p,                          # stream
    ]
    lib.lbm_tblock_step.argtypes = [
        p, p, p, p,                 # f, rho_lid_prev, f_out, rho_lid_out
        *scalars,
        i,                          # k_steps
        p,                          # stream
    ]
    lib.lbm_push_step.argtypes = [
        p, p,                       # f, f_out
        *scalars,
        p,                          # stream
    ]
    lib.lbm_push_step_wall.argtypes = [
        p, p,                       # f, f_out
        *scalars,
        i,                          # wall kind (push.WALLS)
        p,                          # stream
    ]
    lib.lbm_pull_sharded_step.argtypes = [
        p, p, p, p, p,              # f, rho_lid_prev, cs2_plane, f_out, rho_lid_out
        i, i, i, i,                 # lx, ly, pitch, y0 of the carry
        i, i, i, i,                 # left, right, top, bottom walls owned
        *physics,
        p,                          # stream
    ]
    lib.lbm_tblock_sharded_step.argtypes = [
        p, p, p, p,                 # f, panel, f_out, panel_out
        i, i, i, i,                 # lx, ly, x_off, y_off
        *scalars,
        i,                          # k_steps
        p,                          # stream
    ]
    lib.lbm_halo_exchange.argtypes = [
        p,                          # table of rectangles (int64, 12 per rectangle)
        i, ctypes.c_longlong,       # rectangles, slots
        i, i,                       # device, its SMs
        p,                          # stream
    ]
    lib.lbm_enable_peer_access.argtypes = [i, i]   # device, peer
    for fn in (lib.lbm_pull_step, lib.lbm_pull_step_tangential, lib.lbm_pull_sweep_step,
               lib.lbm_tblock_step, lib.lbm_push_step, lib.lbm_push_step_wall,
               lib.lbm_pull_sharded_step, lib.lbm_tblock_sharded_step,
               lib.lbm_halo_exchange, lib.lbm_enable_peer_access):
        fn.restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib
