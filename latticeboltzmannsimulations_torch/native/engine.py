"""ctypes binding and on-demand build of the native C++ engine.

Mirrors ``engine.make_fused_step`` on the host CPU: the state is
``(f, rho_lid)``, N steps per call, OpenMP across columns.  An independent
implementation to cross-check the engines against, and a host-side engine
of its own (the JAX package's ``native/``, with tensors in place of NumPy
arrays).

This engine runs on the CPU by nature, so unlike the package's other entry
points it takes no ``device``: it takes and returns CPU float32 tensors, and
a tensor on the card raises rather than being copied to the host.

The library is built with ``g++`` at first use from this package's own
``lbm_kernel.cpp`` into ``latticeboltzmannsimulations_torch/_build/``
(git-ignored), under a name keyed by a hash of the source and the flags;
nothing is built inside the package's source directories.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import engine
from ..config import SimConfig

_SRC = Path(__file__).resolve().parent / "lbm_kernel.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-ffast-math", "-fopenmp", "-shared", "-fPIC")
_COLLISION = {"srt": 0, "trt": 1, "mrt": 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lbm_native_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> Optional[str]:
    """Compile the shared library to ``path``; returns an error string on
    failure.  Built under a temporary name and moved into place, so a
    concurrent loader sees the whole library or none."""
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / path.name
        try:
            proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(out)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:  # no compiler
            return str(e)
        if proc.returncode:
            return proc.stderr
        os.replace(out, path)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        path = library_path()
        if not path.exists():
            err = _build(path)
            if err:
                _build_error = err
                return None
        lib = ctypes.CDLL(str(path))
        fp = ctypes.POINTER(ctypes.c_float)
        lib.lbm_run.argtypes = [
            fp, fp, fp, fp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_float,
        ]
        lib.lbm_run.restype = None
        lib.lbm_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def num_threads() -> int:
    lib = _load()
    return int(lib.lbm_num_threads()) if lib else 0


def _host(t: torch.Tensor, name: str, shape: tuple) -> torch.Tensor:
    """``t`` as a contiguous CPU float32 tensor of ``shape``; raises for a
    tensor elsewhere, of another dtype or shape."""
    if t.device.type != "cpu":
        raise ValueError(f"native_run: {name} is on {t.device}; the native engine "
                         "runs on the CPU and takes CPU tensors")
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"native_run: {name} is {t.dtype} {tuple(t.shape)}, "
                         f"not float32 {shape}")
    return t.contiguous()


def _ptr(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_float))


def native_run(
    cfg: SimConfig,
    f: torch.Tensor,
    rho_lid: torch.Tensor,
    n_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance ``(f (9, nx, ny), rho_lid (nx,))``, CPU float32 tensors, by
    ``n_steps`` fused steps on the CPU; returns new tensors."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    f = _host(f, "f", (9, cfg.nx, cfg.ny))
    rho_lid = _host(rho_lid, "rho_lid", (cfg.nx,))
    f_out = torch.empty_like(f)
    lid_out = torch.empty_like(rho_lid)
    lib.lbm_run(
        _ptr(f), _ptr(rho_lid), _ptr(f_out), _ptr(lid_out),
        cfg.nx, cfg.ny, n_steps,
        ctypes.c_float(cfg.omega), ctypes.c_float(cfg.u_lid),
        _COLLISION[cfg.collision], ctypes.c_float(cfg.trt_magic),
        ctypes.c_float(cfg.mrt_omega_e), ctypes.c_float(cfg.mrt_omega_eps),
        ctypes.c_float(cfg.mrt_omega_q),
        1 if cfg.turbulence == "smagorinsky" else 0,
        ctypes.c_float(cfg.smagorinsky_cs2),
    )
    return f_out, lid_out


class NativeEngine:
    """Stateful convenience wrapper mirroring the scan runner."""

    def __init__(self, cfg: SimConfig):
        cfg.validate()
        if not is_available():
            raise RuntimeError(f"native engine unavailable: {_build_error}")
        self.cfg = cfg
        st = engine.init_state(cfg, "cpu")
        self.f = st.f.to(torch.float32)
        self.rho_lid = st.rho_lid.to(torch.float32)

    def run(self, n_steps: int) -> "NativeEngine":
        self.f, self.rho_lid = native_run(
            self.cfg, self.f, self.rho_lid, n_steps)
        return self

    def observables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(rho, u)`` of the state, by ``engine.observables``."""
        return engine.observables(
            self.cfg, engine.State(f=self.f, rho_lid=self.rho_lid))
