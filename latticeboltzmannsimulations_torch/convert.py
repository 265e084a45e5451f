"""Carry a state across packages.

For a lattice-Boltzmann run the carried thing is the state: the
populations ``f (9, X, Y)`` and the previous lid-row density
``rho_lid (X,)``.  These two functions move it between NumPy arrays (what
the JAX package's ``State`` holds after ``np.asarray``) and this package's
``State``, so both packages can start from, and be compared on, the same
state.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .engine import State


def state_from_numpy(f: np.ndarray, rho_lid: np.ndarray, device="cuda") -> State:
    """A ``State`` on ``device`` holding copies of ``f`` and ``rho_lid``,
    in their own dtype."""
    f = np.asarray(f)
    rho_lid = np.asarray(rho_lid)
    if f.ndim != 3 or f.shape[0] != 9:
        raise ValueError(f"f must have shape (9, X, Y), got {f.shape}")
    if rho_lid.shape != (f.shape[1],):
        raise ValueError(
            f"rho_lid must have shape ({f.shape[1]},), got {rho_lid.shape}"
        )
    if f.dtype != rho_lid.dtype:
        raise ValueError(f"f is {f.dtype} but rho_lid is {rho_lid.dtype}")
    device = resolve_device(device)
    return State(
        f=torch.tensor(np.ascontiguousarray(f), device=device),
        rho_lid=torch.tensor(np.ascontiguousarray(rho_lid), device=device),
    )


def state_to_numpy(state: State) -> tuple[np.ndarray, np.ndarray]:
    """``(f, rho_lid)`` as NumPy arrays on the host."""
    return state.f.detach().cpu().numpy(), state.rho_lid.detach().cpu().numpy()
