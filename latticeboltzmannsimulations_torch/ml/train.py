"""Surrogate training: the data half of the JAX package's ``ml/train.py``,
which the serving path needs (reference: common structure of ``CNN_*.py``:
load .npy -> scale -> fnet assembly -> 80/20 split).  NumPy only.

The training loop, its optimisers, training checkpoints and weight files
are not ported yet (ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .datagen import DatasetArrays, drop_failed
from .models import CNNPreset
from .scaling import MaxScaler, MinMaxScaler


# ---------------------------------------------------------------------------
# Input assembly (reference: CNNEight_384/CNN_Eight.py:19-99)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreparedData:
    fnet: np.ndarray          # (N, H, W, 10) scaled feq planes + Re plane
    aux: Optional[np.ndarray]  # (N, H, W, 2) lid-BC velocity planes or None
    targets: Dict[str, np.ndarray]  # component -> (N, H, W, 1) scaled
    scalers: Dict[str, dict]  # serializable scaler state
    u_lid: float


def _make_scalers(preset: CNNPreset):
    if preset.scaling == "max":
        return {k: MaxScaler() for k in ("re", "feq", "vel")}
    rng = preset.scale_range
    if preset.scaling == "minmax":
        return {"re": MinMaxScaler(rng), "feq": None, "vel": None}
    if preset.scaling == "minmax_all":
        return {k: MinMaxScaler(rng) for k in ("re", "feq", "vel")}
    raise ValueError(preset.scaling)


def prepare_inputs(ds: DatasetArrays, preset: CNNPreset,
                   u_lid: float = 0.08) -> PreparedData:
    """Scale and assemble the network inputs.

    fnet = concat(feq_initial broadcast over runs [9ch], Re plane [1ch]);
    aux = lid-row velocity planes velBCx/velBCy (zero except the lid row)
    (reference: ``CNN_Eight.py:23-25,86-91``).

    Quarantined (diverged, zero-filled) cavities are dropped here so they
    can never reach training regardless of how the dataset was assembled.
    """
    ds = drop_failed(ds)
    n = len(ds.re_range)
    scalers = _make_scalers(preset)

    feq = np.transpose(ds.feq_initial, (1, 2, 0))       # (H, W, 9)
    if scalers["feq"] is not None:
        feq = scalers["feq"].fit_transform(feq)
    re_scaled = scalers["re"].fit_transform(
        np.asarray(ds.re_range, np.float64)
    ).astype(np.float32)

    h, w = feq.shape[:2]
    fnet = np.empty((n, h, w, 10), np.float32)
    fnet[..., :9] = feq[None]
    fnet[..., 9] = re_scaled[:, None, None]

    vel = np.transpose(ds.u_final, (0, 2, 3, 1))        # (N, H, W, 2)
    if scalers["vel"] is not None:
        vel = scalers["vel"].fit_transform(vel)
    targets = {"x": vel[..., :1], "y": vel[..., 1:2]}

    aux = None
    if preset.aux_bc_at_input or preset.aux_bc_at_head:
        bc = np.zeros((h, w, 2), np.float32)
        bc[:, 0, 0] = u_lid  # lid row (y index 0), x-velocity
        if scalers["vel"] is not None:
            bc = scalers["vel"].transform(bc)
        aux = np.broadcast_to(bc, (n, h, w, 2)).copy()

    return PreparedData(
        fnet=fnet, aux=aux, targets=targets,
        scalers={k: (s.to_dict() if s is not None else None)
                 for k, s in scalers.items()},
        u_lid=u_lid,
    )


def train_val_split(n: int, val_frac: float = 0.2, seed: int = 4):
    """Deterministic shuffle split (reference: train_test_split
    ``random_state=4``, ``CNN_Eight.py:98``)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(round(n * val_frac)))
    return perm[n_val:], perm[:n_val]
