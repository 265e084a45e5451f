"""Surrogate inference: the serving path of the JAX package's
``ml/predict.py`` (the reference's ``CNN_predict.py`` capability,
``CNNEight_384/CNN_predict.py:116-265``): build the input for an arbitrary
Reynolds number, predict both velocity components, un-scale them, and a
fresh LBM solution to compare them with.

``comparison_figure`` (matplotlib) is not ported yet: it comes with the
plots of ROADMAP.md queue 1 (viz).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import engine
from ..config import SimConfig, resolve_device
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
