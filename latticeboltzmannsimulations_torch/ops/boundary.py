"""Boundary conditions for the lid-driven cavity (the JAX package's
``ops/boundary.py`` in PyTorch).

Walls (index convention of ``lattice.py``):
  * ``x = 0``      left wall   (no slip)
  * ``x = nx-1``   right wall  (no slip)
  * ``y = ny-1``   bottom wall (no slip)
  * ``y = 0``      moving lid, velocity ``(u_lid, 0)``

Schemes (the push engines apply them to the streamed field; the fused pull
engine folds its NEBB rewrite into ``engine._fused_gather_bc``):

``nebb``
    Wet-node non-equilibrium bounce-back on all four walls: incoming
    population ``k`` becomes ``feq_k - feq_kbar + f_kbar`` (reference:
    ``MRTTiledPull.py:434-452``).  Branch order left, right, bottom, lid, so
    corner cells chain as the sequential kernel code does.
``nebb_west_eq``
    The reference NumPy engine's variant: the west wall is set to the pure
    equilibrium, the other walls NEBB (reference: ``MRT.py:450-453``).
``bounce_back``
    Halfway bounce-back on the three static walls with a Bouzidi moving-lid
    correction, from the pre-streaming post-collision field (reference:
    ``MRT.py:433-441``), plus a static closure of the two lid corners.
``nebb_tangential``
    NEBB walls, then the Zou-He tangential lid closure and the Zou-He corner
    rule at unit density at the two lid corners (reference:
    ``MRT.py:461-482``).

Every function returns a new tensor and leaves its inputs alone; the
rewrites run in place on a copy, in the reference's order, so a later
rewrite reads what an earlier one wrote.
"""

from __future__ import annotations

import torch

from .. import lattice
from .equilibrium import lid_row_density, population_sum

_OPP = [int(k) for k in lattice.OPP]


def _nebb_walls(f: torch.Tensor, feq: torch.Tensor, walls) -> None:
    """NEBB rewrite ``f_k = feq_k - feq_kbar + f_kbar`` in place, wall by
    wall, for each ``(populations, index)`` in ``walls``."""
    for pops, idx in walls:
        for k in pops:
            kb = _OPP[k]
            f[(k, *idx)] = feq[(k, *idx)] - feq[(kb, *idx)] + f[(kb, *idx)]


def nebb(f: torch.Tensor, feq: torch.Tensor) -> torch.Tensor:
    """Full NEBB on all four walls, kernel branch order."""
    nx, ny = f.shape[1], f.shape[2]
    f = f.clone()
    _nebb_walls(f, feq, (
        ((1, 5, 8), (0, slice(None))),           # left: incoming +x
        ((3, 6, 7), (nx - 1, slice(None))),      # right: incoming -x
        ((2, 5, 6), (slice(None), ny - 1)),      # bottom: incoming +y
        ((4, 7, 8), (slice(None), 0)),           # lid: incoming -y
    ))
    return f


def nebb_west_eq(f: torch.Tensor, feq: torch.Tensor) -> torch.Tensor:
    """West wall = pure equilibrium (reference: MRT.py:450), the other walls
    NEBB in the MRT.py order."""
    nx, ny = f.shape[1], f.shape[2]
    f = f.clone()
    for k in (1, 5, 8):
        f[k, 0, :] = feq[k, 0, :]
    _nebb_walls(f, feq, (
        ((3, 6, 7), (nx - 1, slice(None))),      # east (MRT.py:451)
        ((2, 5, 6), (slice(None), ny - 1)),      # bottom (MRT.py:452)
        ((4, 7, 8), (slice(None), 0)),           # lid (MRT.py:453)
    ))
    return f


def nebb_tangential(f: torch.Tensor, feq: torch.Tensor, u_lid: float) -> torch.Tensor:
    """NEBB walls + Zou-He tangential lid closure + lid-corner treatment.

    After the four-wall NEBB rewrite the lid row is re-closed with
    ``f4 = f2``, ``f7 = f5 + (f1 - f3)/2 - u_lid/2``,
    ``f8 = f6 - (f1 - f3)/2 + u_lid/2``, and the two lid corners get the
    Zou-He corner rule at unit density (reference: ``MRT.py:461-482``).
    """
    nx = f.shape[1]
    f = nebb(f, feq)
    tang = 0.5 * (f[1, :, 0] - f[3, :, 0]) - 0.5 * u_lid
    f[4, :, 0] = f[2, :, 0]
    f[7, :, 0] = f[5, :, 0] + tang
    f[8, :, 0] = f[6, :, 0] - tang
    # Upper-left corner (0, 0).
    f[1, 0, 0] = f[3, 0, 0] + (2.0 / 3.0) * u_lid
    f[4, 0, 0] = f[2, 0, 0]
    f[8, 0, 0] = f[6, 0, 0] + (1.0 / 6.0) * u_lid
    f[5, 0, 0] = u_lid / 12.0
    f[7, 0, 0] = -u_lid / 12.0
    f[0, 0, 0] = 1.0 - population_sum(f[:, 0, 0], 1)
    # Upper-right corner (nx-1, 0).
    e = nx - 1
    f[3, e, 0] = f[1, e, 0] - (2.0 / 3.0) * u_lid
    f[4, e, 0] = f[2, e, 0]
    f[7, e, 0] = f[5, e, 0] - (1.0 / 6.0) * u_lid
    f[6, e, 0] = -u_lid / 12.0
    f[8, e, 0] = u_lid / 12.0
    f[0, e, 0] = 1.0 - population_sum(f[:, e, 0], 1)
    return f


def bounce_back(f: torch.Tensor, fpost: torch.Tensor, u_lid: float) -> torch.Tensor:
    """Halfway bounce-back walls + Bouzidi moving lid.

    Incoming populations at a wall take the pre-streaming post-collision
    value of their opposite at the same node; the lid adds the momentum term
    -+ u_lid/6 to the diagonal populations (reference: MRT.py:433-441).
    """
    nx, ny = f.shape[1], f.shape[2]
    f = f.clone()
    for k in (1, 5, 8):  # left wall
        f[k, 0, :] = fpost[_OPP[k], 0, :]
    for k in (3, 6, 7):  # right wall
        f[k, nx - 1, :] = fpost[_OPP[k], nx - 1, :]
    for k in (2, 5, 6):  # bottom wall
        f[k, :, ny - 1] = fpost[_OPP[k], :, ny - 1]
    # Bouzidi lid on interior columns (reference: MRT.py:438-441).
    sl = slice(1, nx - 1)
    f[4, sl, 0] = fpost[2, sl, 0]
    f[7, sl, 0] = fpost[5, sl, 0] - u_lid / 6.0
    f[8, sl, 0] = fpost[6, sl, 0] + u_lid / 6.0
    # Lid-corner closure, a deliberate departure from the reference: its
    # interior-only Bouzidi slice leaves f4/f7 at (0, 0) and f4/f8 at
    # (nx-1, 0) holding the wrap value from the bottom row every step.  The
    # corner nodes, where the moving lid meets a static wall, are closed
    # with plain (static) halfway bounce-back.
    f[4, 0, 0] = fpost[2, 0, 0]
    f[7, 0, 0] = fpost[5, 0, 0]
    f[4, nx - 1, 0] = fpost[2, nx - 1, 0]
    f[8, nx - 1, 0] = fpost[6, nx - 1, 0]
    return f


def apply(
    f: torch.Tensor,
    feq: torch.Tensor,
    variant: str,
    u_lid: float,
    fpost: torch.Tensor | None = None,
) -> torch.Tensor:
    if variant == "nebb":
        return nebb(f, feq)
    if variant == "nebb_west_eq":
        return nebb_west_eq(f, feq)
    if variant == "nebb_tangential":
        return nebb_tangential(f, feq, u_lid)
    if variant == "bounce_back":
        if fpost is None:
            raise ValueError("bounce_back needs the pre-streaming field")
        return bounce_back(f, fpost, u_lid)
    raise ValueError(f"unknown boundary variant {variant!r}")


def override_wall_velocity(
    u: torch.Tensor,
    rho: torch.Tensor,
    f_bc: torch.Tensor,
    u_lid: float,
    lid_corners: str = "wall",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Impose wall velocities on the macroscopic fields and the wet-node lid
    density before computing the equilibrium (reference: MRT.py:337-342;
    in-kernel: MRTTiledPull.py:459-469).

    Static walls (left/right/bottom) get u = 0; the lid row gets
    u = (u_lid, 0) and the Zou-He closure density over its known populations.

    ``lid_corners`` resolves who owns the two top corner nodes:
      * ``"wall"`` — they belong to the side walls (u = 0, plain density);
        the GPU kernels' branch order (reference: MRTTiledPull.py:461-469).
      * ``"lid"`` — they move with the lid and get the closure density too;
        the NumPy engine's behavior (reference: MRT.py:337-342).

    Returns new tensors; the inputs are not modified.
    """
    nx = u.shape[1]
    ny = u.shape[2]
    u = u.clone()
    rho = rho.clone()
    u[:, 0, :] = 0.0
    u[:, nx - 1, :] = 0.0
    u[:, :, ny - 1] = 0.0
    sl = slice(1, nx - 1) if lid_corners == "wall" else slice(0, nx)
    u[0, sl, 0] = u_lid
    u[1, sl, 0] = 0.0
    rho[sl, 0] = lid_row_density(f_bc[:, sl, 0])
    return u, rho
