"""Single static configuration object consumed by every layer.

The same frozen (hashable) dataclass as the JAX package's ``config.py``:
the same fields, the same derived values and the same validation, so one
configuration describes the same run in both packages.  Only ``dtype``
differs: it names a ``torch`` dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import lattice


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Lid-driven-cavity D2Q9 simulation configuration.

    Defaults reproduce the reference's canonical run (reference:
    ``MRT.py:41-55``: Re=1000, 160x160, uLB=0.08, SRT).
    """

    # --- grid & flow ---
    nx: int = 160
    ny: int = 160
    reynolds: float = 1000.0
    u_lid: float = 0.08  # lid velocity in lattice units; < 0.1 for accuracy

    # --- numerics ---
    collision: str = "srt"          # 'srt' | 'trt' | 'mrt'
    boundary: str = "nebb"  # 'nebb' | 'nebb_west_eq' | 'nebb_tangential' | 'bounce_back'
    precision: str = "float32"      # 'float32' | 'float64'

    # TRT "magic parameter" Lambda (reference: MRT.py:66, delTRT = 1/3.5).
    trt_magic: float = 1.0 / 3.5

    # MRT non-hydrodynamic relaxation rates (reference: MRT.py:70-75).
    mrt_omega_e: float = 1.0
    mrt_omega_eps: float = 1.0
    mrt_omega_q: float = 1.2

    # --- turbulence (Smagorinsky LES) ---
    turbulence: str = "none"         # 'none' | 'smagorinsky'
    smagorinsky_cs2: float = 0.025   # fixed Cs^2 (reference hard override, MRT_GPU.py:376)
    van_driest: bool = False         # wall damping of Cs (reference: MRT_GPU.py:372-375)

    # --- run control ---
    max_steps: int = 3000
    report_interval: int = 1000      # reference "Pinterval" (MRT.py:33)
    convergence_tol: float = 1e-8    # |d mean(u)| / uLB  (reference: MRTtest.py:915-921)
    convergence_hits: int = 5        # stop once hits EXCEED this (N+1
    #                                  consecutive passes — the trajectory
    #                                  contract pins this exact semantics)

    # --- parallelism ---
    # Device mesh shape (mx, my); only (1, 1) runs in this package so far.
    mesh_shape: Tuple[int, int] = (1, 1)

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.precision]

    @property
    def nu(self) -> float:
        """Lattice viscosity (reference: MRT.py:53)."""
        return self.u_lid * self.ny / self.reynolds

    @property
    def omega(self) -> float:
        """SRT relaxation rate, omega = 2/(6 nu + 1) (reference: MRT.py:55)."""
        return 2.0 / (6.0 * self.nu + 1.0)

    @property
    def tau(self) -> float:
        return 1.0 / self.omega

    @property
    def trt_omega_plus(self) -> float:
        return self.omega

    @property
    def trt_omega_minus(self) -> float:
        """omega^- from the magic parameter (reference: MRT.py:65-67)."""
        return 1.0 / (0.5 + self.trt_magic / (self.tau - 0.5))

    def mrt_omegas(self) -> np.ndarray:
        return lattice.mrt_omega_vec(
            self.omega, self.mrt_omega_e, self.mrt_omega_eps, self.mrt_omega_q
        )

    @property
    def tau_min_stable(self) -> float:
        """Stability guideline tau >= 0.5 + uLB/8 (reference: MRT.py:61)."""
        return 0.5 + self.u_lid / 8.0

    def validate(self) -> "SimConfig":
        if self.collision not in ("srt", "trt", "mrt"):
            raise ValueError(f"unknown collision operator {self.collision!r}")
        if self.boundary not in ("nebb", "nebb_west_eq", "nebb_tangential",
                                 "bounce_back"):
            raise ValueError(f"unknown boundary scheme {self.boundary!r}")
        if self.turbulence not in ("none", "smagorinsky"):
            raise ValueError(f"unknown turbulence model {self.turbulence!r}")
        if self.nx < 4 or self.ny < 4:
            raise ValueError("grid too small")
        if not math.isfinite(self.omega) or self.omega <= 0 or self.omega >= 2:
            raise ValueError(
                f"omega={self.omega:.4f} outside (0, 2): unstable configuration"
            )
        return self

    def describe(self) -> str:
        return (
            f"cavity {self.nx}x{self.ny} Re={self.reynolds:g} uLB={self.u_lid} "
            f"{self.collision.upper()}/{self.boundary} tau={self.tau:.4f} "
            f"turb={self.turbulence} mesh={self.mesh_shape}"
        )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) needs a card: without one this raises rather than carry on
    quietly on the CPU, which only an explicit ``device="cpu"`` selects."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
