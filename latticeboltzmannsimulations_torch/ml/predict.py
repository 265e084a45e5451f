"""Surrogate inference: the serving path of the JAX package's
``ml/predict.py`` (the reference's ``CNN_predict.py`` capability,
``CNNEight_384/CNN_predict.py:116-265``): build the input for an arbitrary
Reynolds number, predict both velocity components, un-scale them, and
compare them side by side with a fresh LBM solution: streamline panels,
4-vortex detection on both fields, and centerline overlays against the Ghia
tables (``comparison_figure``, matplotlib).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import engine
from ..config import SimConfig, resolve_device
from ..validate import compare_to_ghia
from ..validate.ghia import centerline_profiles
from ..validate.ghia_data import has_reynolds
from .models import PRESETS, CavityCNN, make_model
from .scaling import MaxScaler, MinMaxScaler


def _restore_scaler(d: Optional[dict]):
    if d is None:
        return None
    if "scale" in d:
        return MaxScaler.from_dict(d)
    return MinMaxScaler.from_dict(d)


def build_input(
    preset_name: str,
    reynolds: float,
    feq_initial: np.ndarray,
    scalers: Dict[str, Optional[dict]],
    u_lid: float = 0.08,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Assemble the (1, H, W, 10) fnet and optional aux planes for one Re
    (reference: ``CNN_predict.py:40-41,101-108``)."""
    preset = PRESETS[preset_name]
    s_re = _restore_scaler(scalers.get("re"))
    s_feq = _restore_scaler(scalers.get("feq"))
    s_vel = _restore_scaler(scalers.get("vel"))

    feq = np.transpose(np.asarray(feq_initial), (1, 2, 0))  # (H, W, 9)
    if s_feq is not None:
        feq = s_feq.transform(feq)
    re_s = float(s_re.transform(np.array([reynolds]))[0])
    h, w = feq.shape[:2]
    fnet = np.empty((1, h, w, 10), np.float32)
    fnet[0, ..., :9] = feq
    fnet[0, ..., 9] = re_s

    aux = None
    if preset.aux_bc_at_input or preset.aux_bc_at_head:
        bc = np.zeros((h, w, 2), np.float32)
        bc[:, 0, 0] = u_lid
        if s_vel is not None:
            bc = s_vel.transform(bc)
        aux = bc[None]
    return fnet, aux


Weights = Union[CavityCNN, Dict[str, torch.Tensor]]


def _module(preset_name: str, weights: Weights, device: torch.device) -> CavityCNN:
    """The model on ``device``: a ``CavityCNN`` as given (moved there), or
    one of the preset built around a state dict."""
    if isinstance(weights, CavityCNN):
        return weights.to(device)
    model = make_model(preset_name)
    model.load_state_dict(weights)
    return model.to(device)


def predict_velocity(
    preset_name: str,
    model_x: Weights,
    model_y: Weights,
    fnet: np.ndarray,
    aux: Optional[np.ndarray],
    scalers: Dict[str, Optional[dict]],
    device="cuda",
) -> np.ndarray:
    """Predict and un-scale both components; returns ``u (2, H, W)``
    (framework layout) for the first input of the batch.  ``model_x`` and
    ``model_y`` are the two ``CavityCNN``s, or their state dicts (see
    ``models.state_dict_from_flax``), in place of the JAX package's flax
    parameters; a module is moved to ``device``.  Runs in the models'
    precision."""
    device = resolve_device(device)
    args = [torch.from_numpy(np.asarray(fnet, np.float32)).to(device)]
    if aux is not None:
        args.append(torch.from_numpy(np.asarray(aux, np.float32)).to(device))
    with torch.no_grad():
        ux, uy = (_module(preset_name, m, device)(*args)[0, ..., 0].cpu().numpy()
                  for m in (model_x, model_y))
    u = np.stack([ux, uy])
    s_vel = _restore_scaler(scalers.get("vel"))
    if s_vel is not None:
        u = s_vel.inverse_transform(u)
    return u.astype(np.float32)


def lbm_reference(cfg: SimConfig, device="cuda") -> np.ndarray:
    """Fresh LBM solution for comparison; returns ``u (2, nx, ny)``.

    Routed through the simulation's backend router (``sim._select_backend``)
    so the comparison runs on the CUDA kernel on the card for float32 NEBB;
    the kernels are held to the fused step, so the trajectory is the same.
    Convergence semantics match ``engine.run_to_convergence`` (no mass
    correction).
    """
    from ..sim import _first_device, _placement, _select_backend

    cfg.validate()
    where = _placement(cfg, device)
    routed = _select_backend(cfg, "auto", where)
    chunk = max(1, cfg.report_interval)
    runner = routed.make_runner(chunk)
    state = routed.prep(engine.init_state(cfg, _first_device(where)))
    mean_past, hits, steps = np.inf, 0, 0
    u = None
    while steps < cfg.max_steps:
        state = runner(state)
        steps += chunk
        _, u = routed.observe(cfg, state)
        mean_u = float(np.mean(u.cpu().numpy(), dtype=np.float64))
        if not np.isfinite(mean_u):
            raise FloatingPointError(
                f"LBM reference diverged at step {steps}")
        if abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol:
            hits += 1
            if hits > cfg.convergence_hits:
                break
        else:
            hits = 0
        mean_past = mean_u
    return u.cpu().numpy()


def comparison_figure(
    cfg: SimConfig,
    u_lbm: np.ndarray,
    u_cnn: np.ndarray,
    out_path: str,
) -> dict:
    """Side-by-side streamlines + vortices, and centerline overlays vs Ghia
    (reference: ``CNN_predict.py:163-265``).  Returns the metric dict."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..viz import streamline_panel

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))

    for ax, u, title in ((axes[0, 0], u_lbm, "LBM"),
                         (axes[0, 1], u_cnn, "CNN")):
        streamline_panel(ax, u, density=1.3,
                         title=f"{title} streamlines, Re={cfg.reynolds:g}")

    # Same center-column averaging as the R²/L2 gates (even grids have no
    # node on the centerline — validate/ghia.centerline_profiles).
    (y_l, ux_l), (x_l, uy_l) = centerline_profiles(u_lbm, cfg.u_lid)
    (y_c, ux_c), (x_c, uy_c) = centerline_profiles(u_cnn, cfg.u_lid)
    axes[1, 0].plot(ux_l, y_l, label="LBM")
    axes[1, 0].plot(ux_c, y_c, "--", label="CNN")
    axes[1, 1].plot(x_l, uy_l, label="LBM")
    axes[1, 1].plot(x_c, uy_c, "--", label="CNN")

    metrics = {}
    if has_reynolds(cfg.reynolds):
        gl = compare_to_ghia(u_lbm, cfg.u_lid, cfg.reynolds)
        gc = compare_to_ghia(u_cnn, cfg.u_lid, cfg.reynolds)
        axes[1, 0].plot(gl.ux_ghia, gl.y_stations, "ko", ms=4, label="Ghia")
        axes[1, 1].plot(gc.x_stations, gc.uy_ghia, "ko", ms=4, label="Ghia")
        metrics = {"r2_lbm_ux": gl.r2_ux, "r2_cnn_ux": gc.r2_ux,
                   "l2_lbm": gl.l2_combined, "l2_cnn": gc.l2_combined}
        axes[1, 0].set_title(
            f"Ux mid-column  R2 LBM={gl.r2_ux:.3f} CNN={gc.r2_ux:.3f}")
        axes[1, 1].set_title("Uy mid-row")
    for ax in axes[1]:
        ax.legend()
        ax.grid(alpha=0.3)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    metrics["figure"] = out_path
    metrics["cnn_vs_lbm_l2"] = float(
        np.linalg.norm(u_cnn - u_lbm) / (np.linalg.norm(u_lbm) + 1e-12)
    )
    return metrics
