"""Matplotlib diagnostics dashboard — capability parity with the reference's
4-panel figure (reference: ``MRT.py:522-602``): centerline profiles vs the
Ghia tables, streamlines with detected vortex centers, R²-vs-time history,
and a parameter text block.  Saved as ``ldc_<step>.png``.

Host-side only; ``sim.simulate`` renders it every ``report_interval`` on
the fields it fetched.  A copy of the JAX package's ``viz.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .config import SimConfig
from .validate import compare_to_ghia, find_vortex_centers
from .validate.ghia import centerline_profiles
from .validate.ghia_data import has_reynolds


def streamline_panel(ax, u: np.ndarray, n_vortices: int = 4,
                     density: float = 1.4, title: Optional[str] = None):
    """Streamlines + detected vortex centers on the [0, 1]² bottom-up frame.

    The one definition of the display transform (flip to bottom-up,
    transpose to (y, x)) — shared by the run dashboard and the ML
    comparison figure (``ml/predict.comparison_figure``)."""
    u = np.asarray(u)
    nx, ny = u.shape[1], u.shape[2]
    xg = np.arange(nx) / (nx - 1)
    yg = np.arange(ny) / (ny - 1)
    ux_disp = u[0, :, ::-1].T
    uy_disp = u[1, :, ::-1].T
    speed = np.sqrt(ux_disp**2 + uy_disp**2)
    ax.streamplot(xg, yg, ux_disp, uy_disp, color=speed, cmap="viridis",
                  density=density, linewidth=0.8)
    for cx_, cy_ in find_vortex_centers(u, n_vortices=n_vortices):
        ax.plot(cx_, cy_, "r+", ms=12, mew=2)
    if title is not None:
        ax.set_title(title)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_aspect("equal")


def dashboard(
    cfg: SimConfig,
    rho: np.ndarray,
    u: np.ndarray,
    step: int,
    r2_history: Optional[Sequence[tuple]] = None,
    out_dir: str = "output",
    prefix: str = "ldc",
) -> str:
    """Render and save the 4-panel diagnostics figure; returns the PNG path."""
    # matplotlib is an optional [viz] extra — import lazily so a base install
    # (torch+numpy only) can import the package; Agg keeps rendering headless.
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rho = np.asarray(rho)
    u = np.asarray(u)
    ghia = compare_to_ghia(u, cfg.u_lid, cfg.reynolds) if has_reynolds(
        cfg.reynolds
    ) else None

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    (ax_ux, ax_uy), (ax_stream, ax_r2) = axes

    # Panel 1: Ux on the mid-column vs Ghia (reference: MRT.py:534-538).
    # centerline_profiles averages the two center columns on even grids
    # (node n//2 sits half a cell off x=0.5) — the same sampling the R²/L2
    # gates use, so the plotted profile is the scored one.
    (y, ux_c), (x_c, uy_c) = centerline_profiles(u, cfg.u_lid)
    ax_ux.plot(ux_c, y, "-", lw=1.5, label="LBM")
    if ghia is not None:
        ax_ux.plot(ghia.ux_ghia, ghia.y_stations, "ko", ms=4, label="Ghia 1982")
        ax_ux.set_title(f"Ux mid-column  R²={ghia.r2_ux:.4f}")
    else:
        ax_ux.set_title("Ux mid-column")
    ax_ux.set_xlabel("Ux / U_lid")
    ax_ux.set_ylabel("y")
    ax_ux.legend()
    ax_ux.grid(alpha=0.3)

    # Panel 2: Uy on the mid-row vs Ghia (reference: MRT.py:539-545).
    ax_uy.plot(x_c, uy_c, "-", lw=1.5, label="LBM")
    if ghia is not None:
        ax_uy.plot(ghia.x_stations, ghia.uy_ghia, "ko", ms=4, label="Ghia 1982")
        ax_uy.set_title(f"Uy mid-row  R²={ghia.r2_uy:.4f}")
    else:
        ax_uy.set_title("Uy mid-row")
    ax_uy.set_xlabel("x")
    ax_uy.set_ylabel("Uy / U_lid")
    ax_uy.legend()
    ax_uy.grid(alpha=0.3)

    # Panel 3: streamlines + vortex centers (reference: MRT.py:546-558).
    streamline_panel(ax_stream, u, title=f"streamlines, step {step}")

    # Panel 4: R² history + parameter block (reference: MRT.py:570-601).
    if r2_history:
        steps = [h[0] for h in r2_history]
        vals = [h[1] for h in r2_history]
        ax_r2.plot(steps, vals, "o-")
        ax_r2.set_ylim(min(0.0, min(vals)), 1.02)
    ax_r2.set_title("R² (Ux vs Ghia) history")
    ax_r2.set_xlabel("step")
    ax_r2.grid(alpha=0.3)
    ax_r2.text(
        0.02, 0.02, cfg.describe(), transform=ax_r2.transAxes,
        fontsize=8, va="bottom", family="monospace",
    )

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{prefix}_{step:06d}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
