"""High-level simulation driver: the time loop with per-interval metrics,
convergence, mass correction, Ghia gating and backend selection, as the JAX
package's ``sim.py`` runs it on one device.

Backends:

* ``"cuda-pull"`` — the hand-written CUDA kernel (``kernels/pull.py``), one
  launch per step.  ``backend="auto"`` picks it on a CUDA device for a
  float32 NEBB configuration.
* ``"torch"`` — the plain fused engine (``engine.py``), for what the kernel
  does not take: float64, the tangential lid.

Outputs the JAX driver has and this one does not yet (plots, VTK,
checkpoints, resume, profiler traces) raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from . import engine
from .config import SimConfig, resolve_device
from .io.metrics import MetricsLogger, mlups
from .kernels import pull
from .validate import compare_to_ghia
from .validate.ghia_data import has_reynolds


@dataclasses.dataclass
class SimOptions:
    """Output & runtime switches (reference knobs ``MRT.py:33-38``)."""

    out_dir: str = "output"
    project: str = "ldc"
    save_plots: bool = False
    save_vtk: bool = False
    metrics_jsonl: bool = True
    checkpoint_every: int = 0     # steps; 0 = off
    resume_from: Optional[str] = None
    backend: str = "auto"         # 'auto' | 'cuda-pull' | 'torch'
    verbose: bool = True
    # The wet-node corner treatment (faithful to the reference kernels) leaks
    # a little mass each step — negligible over the reference's 3000-step
    # runs but a ~5%/10M-step density drift that biases long validation runs.
    # This rescales f to the initial mean density every report interval
    # (velocity is invariant under a uniform rescale of f).
    mass_correction: bool = True
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class SimSummary:
    steps: int
    converged: bool
    elapsed_s: float
    mlups: float
    r2_ux: Optional[float]
    l2_combined: Optional[float]
    out_dir: str
    backend: str
    r2_uy: Optional[float]


# Options of the JAX driver that this package does not run yet, with the
# ROADMAP.md item (queue 1) that ports each.
_NOT_PORTED = {
    "save_plots": "queue 1 item 9 (viz)",
    "save_vtk": "queue 1 item 9 (io/vtk)",
    "checkpoint_every": "queue 1 item 9 (io/checkpoint)",
    "resume_from": "queue 1 item 9 (io/checkpoint)",
    "profile_dir": "queue 1 item 9 (profiler traces)",
}


def _select_backend(cfg: SimConfig, backend: str, device: torch.device):
    """Pick the runner factory and name it, as the JAX driver's single-device
    routing does: the kernel on the card for float32 NEBB, the plain fused
    engine for what the kernel does not take.  An explicit ``"cuda-pull"``
    that the kernel cannot serve raises; this is the one place that routes,
    for ``simulate`` and ``run_to_convergence`` alike."""
    if cfg.mesh_shape != (1, 1):
        raise NotImplementedError(
            f"mesh {cfg.mesh_shape}: the sharded engines are not ported yet "
            "(ROADMAP.md queue 1 item 12)"
        )
    if cfg.boundary not in ("nebb", "nebb_tangential"):
        raise NotImplementedError(
            f"boundary {cfg.boundary!r} runs on the push engine, which is not "
            "ported yet (ROADMAP.md queue 1 item 8)"
        )
    reason = pull.unsupported_reason(cfg)
    if backend == "cuda-pull" and device.type != "cuda":
        reason = f"the CUDA kernel runs on a CUDA device, not {device}"
    if backend == "cuda-pull" and reason is not None:
        raise ValueError(f"backend 'cuda-pull' cannot run this configuration: {reason}")
    if backend == "cuda-pull" or (
        backend == "auto" and device.type == "cuda" and reason is None
    ):
        return (lambda n: pull.make_scan_runner(cfg, n, device)), "cuda-pull"
    if backend in ("auto", "torch"):
        return (lambda n: engine.make_scan_runner(cfg, n, device)), "torch"
    raise ValueError(f"unknown backend {backend!r}")


def run_to_convergence(cfg: SimConfig, state: engine.State | None = None,
                       callback=None, device="cuda",
                       backend: str = "auto") -> engine.RunResult:
    """``engine.run_to_convergence`` stepping through the backend that
    ``simulate`` would pick (``backend`` as in ``SimOptions``)."""
    cfg.validate()
    device = resolve_device(device)
    runner_factory, _ = _select_backend(cfg, backend, device)
    return engine.run_to_convergence(
        cfg, state, callback, device,
        runner=runner_factory(max(1, cfg.report_interval)))


def simulate(cfg: SimConfig, opts: Optional[SimOptions] = None,
             device="cuda") -> SimSummary:
    """Run a cavity simulation to convergence with full diagnostics."""
    opts = opts or SimOptions()
    cfg.validate()
    for name, item in _NOT_PORTED.items():
        if getattr(opts, name):
            raise NotImplementedError(
                f"SimOptions.{name} is not ported yet (ROADMAP.md {item})"
            )
    device = resolve_device(device)
    runner_factory, backend = _select_backend(cfg, opts.backend, device)
    os.makedirs(opts.out_dir, exist_ok=True)
    chunk = max(1, cfg.report_interval)
    runner = runner_factory(chunk)
    state = engine.init_state(cfg, device)
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[cfg.dtype]

    metrics = MetricsLogger(
        os.path.join(opts.out_dir, f"{opts.project}_metrics.jsonl")
        if opts.metrics_jsonl else None
    )
    if opts.verbose:
        print(f"[{backend}] {cfg.describe()}")

    mean_past, hits = np.inf, 0
    converged = False
    step = 0
    t0 = time.perf_counter()
    while step < cfg.max_steps:
        state = runner(state)
        step += chunk
        rho, u = engine.observables(cfg, state)
        rho_h, u_h = rho.cpu().numpy(), u.cpu().numpy()
        mean_u = float(u_h.mean(dtype=np.float64))
        if not np.isfinite(mean_u):
            raise FloatingPointError(f"simulation diverged at step {step}")

        if opts.mass_correction:
            scale = 1.0 / rho_h.mean(dtype=np.float64)
            if abs(scale - 1.0) > 1e-12:
                # rounded to the working precision first, as the JAX driver's
                # cfg.dtype(scale) is
                s = float(np_dtype(scale))
                state = engine.State(f=state.f * s, rho_lid=state.rho_lid * s)

        rec = {"mean_u": mean_u, "backend": backend}
        if has_reynolds(cfg.reynolds):
            cmp_ = compare_to_ghia(u_h, cfg.u_lid, cfg.reynolds)
            rec.update(r2_ux=cmp_.r2_ux, l2=cmp_.l2_combined)
        metrics.log(step, **rec)
        if opts.verbose:
            extra = f" R2={rec['r2_ux']:.4f}" if "r2_ux" in rec else ""
            print(f"  step {step}: mean_u={mean_u:.3e}{extra}")

        if abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol:
            hits += 1
            if hits > cfg.convergence_hits:
                converged = True
                break
        else:
            hits = 0
        mean_past = mean_u
    elapsed = time.perf_counter() - t0

    _, u = engine.observables(cfg, state)
    u_h = u.cpu().numpy()
    r2 = r2_uy = l2 = None
    if has_reynolds(cfg.reynolds):
        cmp_ = compare_to_ghia(u_h, cfg.u_lid, cfg.reynolds)
        r2, r2_uy, l2 = cmp_.r2_ux, cmp_.r2_uy, cmp_.l2_combined
    summary = SimSummary(
        steps=step, converged=converged, elapsed_s=elapsed,
        mlups=mlups(cfg.nx, cfg.ny, step, elapsed),
        r2_ux=r2, l2_combined=l2, out_dir=opts.out_dir, backend=backend,
        r2_uy=r2_uy,
    )
    metrics.log(step, final=True, mlups=summary.mlups,
                converged=converged, **({"r2_ux": r2, "l2": l2} if r2 is not None else {}))
    metrics.close()
    if opts.verbose:
        print(
            f"done: {step} steps, converged={converged}, "
            f"{summary.mlups:.1f} MLUPS"
            + (f", R2(ux)={r2:.4f}, L2={100 * l2:.2f}%" if r2 is not None else "")
        )
    return summary
