"""Equilibrium distribution and macroscopic moments on the ``(9, X, Y)``
planar layout (the JAX package's ``ops/equilibrium.py`` in PyTorch).

Physics follows the standard incompressible D2Q9 second-order equilibrium
(reference formula: ``MRT.py:228-231``)::

    feq_k = rho * w_k * (1 + 3 c_k.u + 4.5 (c_k.u)^2 - 1.5 |u|^2)
"""

from __future__ import annotations

import torch

from .. import lattice


def equilibrium(rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """feq from density ``rho (X, Y)`` and velocity ``u (2, X, Y)``.

    Unrolled over the 9 directions with Python-scalar coefficients; zero
    velocity components are elided, in the same order of operations as the
    JAX package, so the two agree to rounding.
    """
    ux, uy = u[0], u[1]
    usqr15 = 1.5 * (ux * ux + uy * uy)               # (X, Y)
    planes = []
    for k in range(lattice.Q):
        cx, cy, w = float(lattice.CX[k]), float(lattice.CY[k]), float(lattice.W[k])
        if cx and cy:
            cu = cx * ux + cy * uy
        elif cx:
            cu = cx * ux
        elif cy:
            cu = cy * uy
        else:
            cu = None
        if cu is None:
            planes.append(rho * w * (1.0 - usqr15))
        else:
            planes.append(rho * w * (1.0 + 3.0 * cu + 4.5 * cu * cu - usqr15))
    return torch.stack(planes)


def macroscopics(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Density and velocity moments of ``f (9, X, Y)``.

    rho = sum_k f_k ;  u = sum_k c_k f_k / rho   (reference: MRT.py:292,320-321)
    """
    rho = torch.sum(f, dim=0)
    jx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    jy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    u = torch.stack([jx, jy]) / rho[None]
    return rho, u


def lid_row_density(f_row: torch.Tensor) -> torch.Tensor:
    """Wet-node density at the moving lid (y = 0 row).

    rho = f0+f1+f3 + 2*(f2+f5+f6): center populations plus twice the outgoing
    (upward) ones — the Zou-He closure for a wall normal to -y
    (reference: MRT.py:337, MRT_GPU.py:400-405).

    ``f_row`` has shape ``(9, X)`` (the y=0 slice of the planar field).
    """
    return (
        f_row[0] + f_row[1] + f_row[3]
        + 2.0 * (f_row[2] + f_row[5] + f_row[6])
    )


def momentum_flux_xy(f: torch.Tensor, feq: torch.Tensor) -> torch.Tensor:
    """Off-diagonal non-equilibrium momentum flux Q_xy = sum_k cx cy (f-feq).

    The reference LES model drives the eddy viscosity from this single
    component (reference: MRT_GPU.py:378-382).  Only the four diagonal
    populations contribute (cx*cy = +-1).
    """
    fneq = f - feq
    return fneq[5] - fneq[6] + fneq[7] - fneq[8]
