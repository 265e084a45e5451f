"""The cluster window's shapes and its ctypes binding.

The sources beside this file are a design of the port's temporal-block
window (a thread-block cluster holds one window; the halo lies only at the
cluster's edge), measured against the package's window by
``scripts/torch_tblock_designs.py`` and kept out of the package because it
ran slower.  Their entry points take a shape, (part rows, cluster x,
cluster y), after K.  ``using`` points the package's temporal-block
wrappers at a library built from them, so that the package's runners,
their graphs and their launch counts run the design unchanged.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path

from latticeboltzmannsimulations_torch.kernels import tblock, tblock_sharded

DIR = Path(__file__).resolve().parent
SOURCES = ("tblock_step.cu", "tblock_sharded_step.cu", "tblock_window.cuh",
           "tblock_async.cuh")

# Cells of a block's part of the window (tblock_window.cuh: kCells), a part
# of R rows and PART_CELLS / R columns for R in PART_ROWS; a cluster of
# cx x cy blocks holds a window of (R cx) x (PART_CELLS / R cy) cells and
# owns its centre, the window less a K-wide halo on all four sides.
PART_CELLS = 4096
PART_ROWS = (64, 32, 16)
MAX_CLUSTER = 16             # blocks of a cluster (above 8: non-portable)
WINDOW = 64                  # the least window edge along either axis
# Its fastest shape on one H100: a cluster of one 64 x 64 block (PERF.md,
# section 6).
SHAPE = (64, 1, 1)


def shape_reason(shape: tuple, k_steps: int) -> str | None:
    """Why the window cannot take ``shape`` at ``k_steps`` steps, or None."""
    rows, cx, cy = shape
    if rows not in PART_ROWS:
        return f"part rows {rows} must be one of {PART_ROWS}"
    if cx < 1 or cy < 1 or cx * cy > MAX_CLUSTER:
        return f"a cluster of {cx}x{cy} blocks is not one of 1 to {MAX_CLUSTER} blocks"
    wx, wy = rows * cx, PART_CELLS // rows * cy
    if min(wx, wy) < WINDOW:
        return f"the {wx}x{wy} window is narrower than {WINDOW} cells"
    if not 1 <= k_steps < WINDOW // 2:
        return (f"k_steps={k_steps} must lie in [1, {WINDOW // 2 - 1}] for the "
                f"{WINDOW}x{WINDOW} window")
    return None


def tiles(nx: int, ny: int, k_steps: int, shape: tuple) -> tuple:
    """Tiles of one launch along x and y on an nx x ny field (or shard):
    each a cluster's own cells, its window less the halo.  A launch runs as
    many clusters as the card holds at once, or as there are tiles, each
    stepping every so many tiles in turn."""
    rows, cx, cy = shape
    own_x = rows * cx - 2 * k_steps
    own_y = PART_CELLS // rows * cy - 2 * k_steps
    return -(-nx // own_x), -(-ny // own_y)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The design's entry points (and, in a stamped build, its stamp
    setters)."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i, i, fl, fl, fl, fl, fl, fl, fl, fl, fl, i, i, fl]
    lib.lbm_tblock_step.argtypes = [p, p, p, p, *scalars, i, i, i, i, p]
    lib.lbm_tblock_sharded_step.argtypes = [p, p, p, p, i, i, i, i, *scalars, i, i, i, i, p]
    lib.lbm_tblock_max_clusters.argtypes = [i, i, i, p]
    fns = [lib.lbm_tblock_step, lib.lbm_tblock_sharded_step, lib.lbm_tblock_max_clusters]
    for stem in ("tblock_step", "tblock_sharded_step"):
        setter = getattr(lib, f"lbm_stamps_{stem}", None)
        if setter is not None:
            setter.argtypes = [p]
            fns.append(setter)
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def max_active_clusters(lib, shape: tuple) -> int:
    """How many clusters of ``shape`` the card holds at once (0: none, or
    the occupancy query refused the shape)."""
    out = ctypes.c_int(0)
    if lib.lbm_tblock_max_clusters(*shape, ctypes.byref(out)) != 0:
        return 0
    return out.value


def launch(lib, shape, _package_lib, src: tuple, dst: tuple, scalars: tuple,
           k_steps: int, stream) -> None:
    """``tblock._launch`` on the design's entry, in clusters of ``shape``."""
    reason = shape_reason(shape, k_steps)
    if reason is not None:
        raise ValueError(reason)
    err = lib.lbm_tblock_step(*src, *dst, *scalars, k_steps, *shape, stream)
    if err != 0:
        raise RuntimeError(f"cluster tblock_step launch failed: error {err}")
    tblock.launches += 1


def sharded_launch(lib, shape, _package_lib, f_ptr: int, panel_ptr: int, f_out_ptr: int,
                   panel_out_ptr: int, lx: int, ly: int, origin: tuple, scalars: tuple,
                   k_steps: int, stream) -> None:
    """``tblock_sharded._launch`` on the design's entry, in clusters of
    ``shape``."""
    reason = shape_reason(shape, k_steps)
    if reason is not None:
        raise ValueError(reason)
    err = lib.lbm_tblock_sharded_step(f_ptr, panel_ptr, f_out_ptr, panel_out_ptr, lx, ly,
                                      *origin, *scalars, k_steps, *shape, stream)
    if err != 0:
        raise RuntimeError(f"cluster tblock_sharded_step launch failed: error {err}")
    tblock_sharded.launches += 1


@contextlib.contextmanager
def using(lib, shape: tuple = SHAPE):
    """Inside the block the package's temporal-block wrappers launch the
    design's entry points of ``lib`` in clusters of ``shape``; every other
    launch stays on the package's library."""
    saved = tblock._launch, tblock_sharded._launch
    tblock._launch = functools.partial(launch, lib, tuple(shape))
    tblock_sharded._launch = functools.partial(sharded_launch, lib, tuple(shape))
    try:
        yield
    finally:
        tblock._launch, tblock_sharded._launch = saved
