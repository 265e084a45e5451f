"""Wall velocity overrides on the macroscopic fields (the JAX package's
``ops/boundary.py::override_wall_velocity``).

The population-level NEBB variants of that module serve the push engines,
which this package does not run yet (see ``ROADMAP.md``); the fused pull
engine folds its NEBB rewrite into ``engine._fused_gather_bc``.
"""

from __future__ import annotations

import torch

from .equilibrium import lid_row_density


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
