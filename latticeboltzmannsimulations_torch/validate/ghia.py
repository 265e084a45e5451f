"""Centerline profile extraction and fidelity metrics vs the Ghia tables.

Capability parity with the reference validation harness — profile sampling
(reference: ``MRT.py:533-545``), R^2 regression value
(reference: ``MRTtest.py:852-860``) — plus the L2 relative error used as the
build's fidelity gate (BASELINE.md: < 1% at Re=1000).

Host-side NumPy, a copy of the JAX package's ``validate/ghia.py``: this runs
off the hot path, on fields fetched every ``report_interval`` steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ghia_data


def centerline_profiles(u: np.ndarray, u_lid: float):
    """Extract normalized centerline profiles from a velocity field
    ``u (2, nx, ny)`` (framework layout: y index 0 = lid).

    Returns ``(y_bottom_up, ux_mid_column), (x, uy_mid_row)`` with coordinates
    normalized to [0, 1] measured from the bottom-left corner (Ghia's frame)
    and velocities normalized by the lid speed.
    """
    u = np.asarray(u)
    nx, ny = u.shape[1], u.shape[2]
    # On the node grid i/(n-1) an even n has no node at 0.5: column n//2
    # sits at 0.5 + 1/(2(n-1)), half a cell off the true centerline, which
    # folds an O(0.5%) systematic velocity error into every gate at the
    # production sizes (96/160/512 are all even).  Average the two center
    # columns — their midpoint is exactly 0.5.
    if nx % 2 == 0:
        ux = 0.5 * (u[0, nx // 2 - 1, :] + u[0, nx // 2, :]) / u_lid
    else:
        ux = u[0, nx // 2, :] / u_lid      # along y (index 0 = lid)
    y = 1.0 - np.arange(ny) / (ny - 1)     # convert to bottom-up coordinate
    order = np.argsort(y)
    if ny % 2 == 0:
        uy = 0.5 * (u[1, :, ny // 2 - 1] + u[1, :, ny // 2]) / u_lid
    else:
        uy = u[1, :, ny // 2] / u_lid
    x = np.arange(nx) / (nx - 1)
    return (y[order], ux[order]), (x, uy)


def r_squared(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination (same definition sklearn's r2_score uses,
    which the reference calls at ``MRTtest.py:858``)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return 1.0 - ss_res / ss_tot


def l2_error(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Relative L2 error ||pred - true|| / ||true||."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.linalg.norm(y_pred - y_true) / np.linalg.norm(y_true))


@dataclasses.dataclass
class GhiaComparison:
    reynolds: float
    r2_ux: float
    r2_uy: float
    l2_ux: float
    l2_uy: float
    # sampled values at the Ghia stations (for plotting / reporting)
    y_stations: np.ndarray
    ux_ghia: np.ndarray
    ux_lbm: np.ndarray
    x_stations: np.ndarray
    uy_ghia: np.ndarray
    uy_lbm: np.ndarray

    @property
    def l2_combined(self) -> float:
        """Combined u/v centerline L2 error (the BASELINE gate metric)."""
        g = np.concatenate([self.ux_ghia, self.uy_ghia])
        s = np.concatenate([self.ux_lbm, self.uy_lbm])
        return l2_error(g, s)

    def summary(self) -> str:
        return (
            f"Ghia Re={self.reynolds:g}: R2(ux)={self.r2_ux:.4f} "
            f"R2(uy)={self.r2_uy:.4f} L2={100*self.l2_combined:.2f}%"
        )


def compare_to_ghia(
    u: np.ndarray, u_lid: float, reynolds: float, interior_only: bool = True,
    exclude_suspect: bool = True,
) -> GhiaComparison:
    """Sample the simulated centerlines at the Ghia stations (linear
    interpolation) and score them.

    ``interior_only`` drops the wall stations (y=0, y=1 / x=0, x=1) whose
    values are fixed by the boundary conditions, as the reference does by
    slicing off the wall row (``MRT.py:120``).  ``exclude_suspect`` drops
    the stations flagged in ``ghia_data.SUSPECT_STATIONS`` (values
    inconsistent with any smooth profile; see that table's note).
    """
    ys, ux_g = ghia_data.ux_table(reynolds)
    xs, uy_g = ghia_data.uy_table(reynolds)
    if interior_only:
        keep_y = (ys > 0.0) & (ys < 1.0)
        ys, ux_g = ys[keep_y], ux_g[keep_y]
        keep_x = (xs > 0.0) & (xs < 1.0)
        xs, uy_g = xs[keep_x], uy_g[keep_x]
    if exclude_suspect:
        keep_y = np.array(
            [not ghia_data.is_suspect(reynolds, "ux", y) for y in ys])
        ys, ux_g = ys[keep_y], ux_g[keep_y]
        keep_x = np.array(
            [not ghia_data.is_suspect(reynolds, "uy", x) for x in xs])
        xs, uy_g = xs[keep_x], uy_g[keep_x]

    (y_sim, ux_sim), (x_sim, uy_sim) = centerline_profiles(u, u_lid)
    ux_s = np.interp(ys, y_sim, ux_sim)
    uy_s = np.interp(xs, x_sim, uy_sim)

    return GhiaComparison(
        reynolds=reynolds,
        r2_ux=r_squared(ux_g, ux_s),
        r2_uy=r_squared(uy_g, uy_s),
        l2_ux=l2_error(ux_g, ux_s),
        l2_uy=l2_error(uy_g, uy_s),
        y_stations=ys,
        ux_ghia=ux_g,
        ux_lbm=ux_s,
        x_stations=xs,
        uy_ghia=uy_g,
        uy_lbm=uy_s,
    )
