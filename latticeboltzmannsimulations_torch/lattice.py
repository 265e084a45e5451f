"""D2Q9 lattice definition — velocity set, weights, stencils, MRT moment basis.

This is layer L0 of the PyTorch package: pure NumPy constant data shared by
every other layer, a copy of the JAX package's ``lattice.py`` (the port
imports nothing of that package).  Mirrors the reference tables (reference:
``MRT.py:138-183``).

Conventions
-----------
* Arrays are laid out ``(9, X, Y)`` ("planar" / structure-of-arrays): one
  contiguous plane per population.  The planar layout is what the fastest
  reference backend uses (reference: ``MRTTiledPull.py:313-333``); Y is the
  contiguous axis, so neighbouring CUDA threads read neighbouring addresses.
* ``x`` runs left → right, index ``0 .. X-1``.
* ``y`` index ``0`` is the TOP (moving lid); the index grows *downwards*.
  A population with ``cy = +1`` therefore moves towards *decreasing* y index:
  cell ``(x, y)`` receives population ``k`` from cell ``(x - cx[k], y + cy[k])``.
  This matches the reference streaming stencil (reference: ``MRT.py:404-414``).

Direction ordering (identical to the reference, ``MRT.py:138``)::

    k : 0    1     2     3     4     5      6      7      8
    c : rest (1,0) (0,1) (-1,0)(0,-1)(1,1)  (-1,1) (-1,-1)(1,-1)
"""

from __future__ import annotations

import numpy as np

Q = 9  # number of discrete velocities

# Velocity set (reference: MRT.py:138-140).
C = np.array(
    [[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1], [1, 1], [-1, 1], [-1, -1], [1, -1]],
    dtype=np.int32,
)
CX = C[:, 0].copy()
CY = C[:, 1].copy()

# Quadrature weights (reference: MRT.py:144-146).
W = np.full(Q, 1.0 / 36.0)
W[1:5] = 1.0 / 9.0
W[0] = 4.0 / 9.0

# Opposite-direction (bounce-back) index map (reference: MRT.py:152).
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Directional stencil groups (reference: MRT.py:155-160).  Named by the sign of
# the velocity component: e.g. RIGHT = populations moving in +x.
LEFT = np.flatnonzero(CX < 0)     # [3, 6, 7]
CENT_V = np.flatnonzero(CX == 0)  # [0, 2, 4]
RIGHT = np.flatnonzero(CX > 0)    # [1, 5, 8]
UP = np.flatnonzero(CY > 0)       # [2, 5, 6]   (towards the lid, -y index)
CENT_H = np.flatnonzero(CY == 0)  # [0, 1, 3]
DOWN = np.flatnonzero(CY < 0)     # [4, 7, 8]

# Aliases matching the reference's wall naming ("Top" = cy > 0).
TOP_STENCIL = UP
BOT_STENCIL = DOWN

# Lattice speed of sound squared.
CS2 = 1.0 / 3.0

# ---------------------------------------------------------------------------
# MRT Gram-Schmidt moment basis (reference: MRT.py:163-183).
# Moments, in row order: rho, e (energy), eps (energy^2), jx, qx, jy, qy,
# pxx, pxy.
# ---------------------------------------------------------------------------
M_GS = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1],
        [-4, -1, -1, -1, -1, 2, 2, 2, 2],
        [4, -2, -2, -2, -2, 1, 1, 1, 1],
        [0, 1, 0, -1, 0, 1, -1, -1, 1],
        [0, -2, 0, 2, 0, 1, -1, -1, 1],
        [0, 0, 1, 0, -1, 1, 1, -1, -1],
        [0, 0, -2, 0, 2, 1, 1, -1, -1],
        [0, 1, -1, 1, -1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, -1, 1, -1],
    ],
    dtype=np.float64,
)

# Exact rational inverse (reference: MRT.py:174-183).  Regenerated here from
# the orthogonality relation M^-1 = M^T diag(1/|m_k|^2) rather than typed in.
_row_norms = (M_GS * M_GS).sum(axis=1)
M_GS_INV = (M_GS / _row_norms[:, None]).T.copy()

MOMENT_NAMES = ("rho", "e", "eps", "jx", "qx", "jy", "qy", "pxx", "pxy")

# Conserved moments (rho, jx, jy) relax with rate 0.
CONSERVED_MOMENTS = (0, 3, 5)


def mrt_omega_vec(omega_nu: float, omega_e: float = 1.0, omega_eps: float = 1.0,
                  omega_q: float = 1.2) -> np.ndarray:
    """Per-moment relaxation-rate vector (reference: MRT.py:70-75).

    ``omega_nu`` sets the shear viscosity; conserved moments get 0;
    ``omega_e = 1`` encodes the Stokes hypothesis (zero bulk viscosity).
    """
    return np.array(
        [0.0, omega_e, omega_eps, 0.0, omega_q, 0.0, omega_q, omega_nu, omega_nu],
        dtype=np.float64,
    )


def _self_check() -> None:
    ident = M_GS @ M_GS_INV
    assert np.allclose(ident, np.eye(Q), atol=1e-12), "M_GS inverse mismatch"
    assert np.isclose(W.sum(), 1.0)
    assert np.all(C[OPP] == -C)


_self_check()
