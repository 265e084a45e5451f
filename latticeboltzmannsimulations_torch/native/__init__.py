"""Native CPU engine: C++/OpenMP fused collide-and-stream kernel.

The host-runtime counterpart of the reference's Cython/OpenMP extension
(reference: ``functions.pyx`` + ``setup.py``), compiled on demand with g++
and bound through ctypes (no build-time Python dependency), on CPU
tensors."""

from .engine import (
    NativeEngine,
    build_error,
    is_available,
    native_run,
    num_threads,
)

__all__ = ["NativeEngine", "native_run", "is_available", "build_error", "num_threads"]
