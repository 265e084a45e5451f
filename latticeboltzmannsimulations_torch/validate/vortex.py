"""Vortex-center detection by repeated masked minima of the speed field
(reference: ``MRT.py:504-516``; four-vortex variant
``CNNEight_384/CNN_predict.py:181-212``).

Host-side NumPy diagnostic, a copy of the JAX package's
``validate/vortex.py``.
"""

from __future__ import annotations

import numpy as np


def find_vortex_centers(
    u: np.ndarray, n_vortices: int = 2, bc_offset: int | None = None
):
    """Locate up to ``n_vortices`` velocity minima.

    A band of ``bc_offset`` cells around each wall is masked out (default
    nx/40, the reference's choice at ``MRT.py:507``), the global minimum of
    |u|^2 is taken, then a ``bc_offset``-radius neighborhood around each found
    center is masked before searching for the next.

    Returns a list of (x_norm, y_norm_from_bottom) tuples.
    """
    u = np.asarray(u)
    nx, ny = u.shape[1], u.shape[2]
    if bc_offset is None:
        bc_offset = max(1, nx // 40)
    speed2 = u[0] ** 2 + u[1] ** 2
    masked = speed2.astype(np.float64).copy()
    masked[:bc_offset, :] = np.nan
    masked[nx - bc_offset :, :] = np.nan
    masked[:, :bc_offset] = np.nan
    masked[:, ny - bc_offset :] = np.nan

    centers = []
    for _ in range(n_vortices):
        if np.all(np.isnan(masked)):
            break
        ix, iy = np.unravel_index(np.nanargmin(masked), masked.shape)
        # node-grid normalization i/(n-1) — the convention of the Ghia
        # vortex tables this is compared against — with y flipped to
        # bottom-up (reference: MRT.py:551, which divided by n and biased
        # every position ~half a cell toward the origin)
        centers.append((ix / (nx - 1), (ny - 1 - iy) / (ny - 1)))
        x0, x1 = max(0, ix - bc_offset), min(nx, ix + bc_offset + 1)
        y0, y1 = max(0, iy - bc_offset), min(ny, iy + bc_offset + 1)
        masked[x0:x1, y0:y1] = np.nan
    return centers
