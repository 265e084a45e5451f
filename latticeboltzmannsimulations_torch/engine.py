"""Time-loop engine (layer L3): the fused pull step in plain PyTorch.

The production step of the JAX package's ``engine.py``: an algebraic
reduction of the pull scheme.  Because NEBB's ``feq_k - feq_kbar`` equals
``6 rho w_k (c_k . u_wall)``, which vanishes at static walls and closes at
the lid with only the previous lid density, the whole step needs just
``(f, rho_lid)`` as state and is one pass over the 9 planes (reference:
``MRTTiledPull.py:379-515``).

This module is also the plain version of the CUDA kernel in
``kernels/pull.py``: the tests hold it to the JAX engine, and the kernel is
held to it on the card.  The push and pull oracles of the JAX engine are not
ported yet (see ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import SimConfig, resolve_device
from .ops import boundary as bc_ops
from .ops import collision as coll
from .ops.equilibrium import equilibrium, macroscopics
from .ops.streaming import gather_pull


class State(NamedTuple):
    """Carried state of the fused pull engine."""

    f: torch.Tensor        # (9, X, Y) post-collision populations
    rho_lid: torch.Tensor  # (X,) lid-row density from the previous step


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def initial_fields(cfg: SimConfig, device="cuda"):
    """rho = 1, u = 0 except lid row moving at u_lid (reference: MRT.py:260-268)."""
    device = resolve_device(device)
    rho = torch.ones((cfg.nx, cfg.ny), dtype=cfg.dtype, device=device)
    u = torch.zeros((2, cfg.nx, cfg.ny), dtype=cfg.dtype, device=device)
    u[0, 1 : cfg.nx - 1, 0] = cfg.u_lid  # corners stay with the walls
    return rho, u


def init_state(cfg: SimConfig, device="cuda") -> State:
    rho, u = initial_fields(cfg, device)
    f = equilibrium(rho, u)
    return State(f=f, rho_lid=rho[:, 0].clone())


def _check_device(state: State, device: torch.device) -> None:
    """A runner built for one device refuses a state on another, so a CPU
    state never runs quietly where a card was asked for."""
    for t in state:
        if t.device != device:
            raise ValueError(
                f"state lies on {t.device}, but the runner was built for {device}"
            )


# ---------------------------------------------------------------------------
# Collision dispatch
# ---------------------------------------------------------------------------

def _collide(cfg: SimConfig, f_bc, feq, rho, omega=None, cs2_field=None):
    """Apply the configured collision operator, optionally with the
    Smagorinsky effective relaxation time.

    ``omega`` overrides the config-derived shear relaxation rate (one step
    serves a whole Reynolds sweep).  ``cs2_field`` overrides the Van Driest
    Cs^2 plane with a precomputed one.
    """
    om0 = cfg.omega if omega is None else omega
    tau0 = cfg.tau if omega is None else 1.0 / om0
    if cfg.turbulence == "smagorinsky":
        if cs2_field is not None:
            cs2 = cs2_field
        elif cfg.van_driest:
            # Wall-damped Cs^2 field (reference: MRT_GPU.py:372-375); the
            # viscous length uses the lid friction scaling u_tau ~ u_lid.
            cs2 = coll.van_driest_cs2(
                cfg.nx, cfg.ny, cfg.u_lid / cfg.nu, dtype=f_bc.dtype,
                device=f_bc.device,
            )
        else:
            cs2 = cfg.smagorinsky_cs2
        tau_eff = coll.smagorinsky_tau(f_bc, feq, rho, tau0, cs2)
        omega_eff = 1.0 / tau_eff  # (X, Y) field
    else:
        omega_eff = om0

    if cfg.collision == "srt":
        return coll.srt_collide(f_bc, feq, omega_eff)
    if cfg.collision == "trt":
        # omega^- from the magic parameter and the BASE tau, also under LES
        # (the LES-modified tau does not enter the magic-parameter closure).
        omega_minus = 1.0 / (0.5 + cfg.trt_magic / (tau0 - 0.5))
        return coll.trt_collide(f_bc, feq, omega_eff, omega_minus)
    if cfg.collision == "mrt":
        return coll.mrt_collide(
            f_bc, omega_eff, cfg.mrt_omega_e, cfg.mrt_omega_eps, cfg.mrt_omega_q
        )
    raise ValueError(cfg.collision)


# ---------------------------------------------------------------------------
# Fused production step
# ---------------------------------------------------------------------------

def _static_walls(g, nx: int, ny: int) -> None:
    """In-register bounce-back on the three static walls, in place, in the
    order left, right, bottom (corner values chain through that order)."""
    # Left wall x=0: f1<-f3, f5<-f7, f8<-f6.
    g[1, 0, :] = g[3, 0, :]
    g[5, 0, :] = g[7, 0, :]
    g[8, 0, :] = g[6, 0, :]
    # Right wall: f3<-f1, f6<-f8, f7<-f5.
    g[3, nx - 1, :] = g[1, nx - 1, :]
    g[6, nx - 1, :] = g[8, nx - 1, :]
    g[7, nx - 1, :] = g[5, nx - 1, :]
    # Bottom wall y=ny-1: f2<-f4, f5<-f7, f6<-f8.
    g[2, :, ny - 1] = g[4, :, ny - 1]
    g[5, :, ny - 1] = g[7, :, ny - 1]
    g[6, :, ny - 1] = g[8, :, ny - 1]


def _fused_gather_bc(cfg: SimConfig, f, rho_lid_prev):
    """Gather + reduced NEBB.  Returns the boundary-corrected populations.

    With the previous step's wall velocities (zero on static walls and the
    two lid corners, ``(u_lid, 0)`` on the interior lid row) every wall
    rewrite is a pure bounce-back except the lid's diagonal pair, which picks
    up ``-+ rho_prev u_lid / 6``  (w_7 = w_8 = 1/36, c_x = -+1).
    """
    nx, ny = cfg.nx, cfg.ny
    g = gather_pull(f)
    _static_walls(g, nx, ny)
    # Lid y=0: f4<-f2; f7<-f5 - rho_prev*uLB/6; f8<-f6 + rho_prev*uLB/6,
    # with zero momentum term at the two corners (their previous u was 0).
    mom = rho_lid_prev * (cfg.u_lid / 6.0)
    mom[0] = 0.0
    mom[nx - 1] = 0.0
    g[4, :, 0] = g[2, :, 0]
    g[7, :, 0] = g[5, :, 0] - mom
    g[8, :, 0] = g[6, :, 0] + mom
    return g


def _fused_gather_bc_tangential(cfg: SimConfig, f):
    """Gather + reduced static walls + Zou-He tangential lid closure.

    The static walls reduce to bounce-back exactly as in
    ``_fused_gather_bc``; the lid closure needs only the post-gather
    populations and ``u_lid``, so it carries no previous-step lid density.
    Corner cells use the Zou-He corner rule at unit density.
    """
    nx, ny = cfg.nx, cfg.ny
    u_lid = cfg.u_lid
    g = gather_pull(f)
    _static_walls(g, nx, ny)
    # Zou-He tangential lid closure (full row; corners fixed below).
    tang = 0.5 * (g[1, :, 0] - g[3, :, 0]) - 0.5 * u_lid
    g[4, :, 0] = g[2, :, 0]
    g[7, :, 0] = g[5, :, 0] + tang
    g[8, :, 0] = g[6, :, 0] - tang
    # Zou-He corner rule at unit density.
    g[1, 0, 0] = g[3, 0, 0] + (2.0 / 3.0) * u_lid
    g[4, 0, 0] = g[2, 0, 0]
    g[8, 0, 0] = g[6, 0, 0] + (1.0 / 6.0) * u_lid
    g[5, 0, 0] = u_lid / 12.0
    g[7, 0, 0] = -u_lid / 12.0
    g[0, 0, 0] = 1.0 - g[1:, 0, 0].sum(dim=0)
    e = nx - 1
    g[3, e, 0] = g[1, e, 0] - (2.0 / 3.0) * u_lid
    g[4, e, 0] = g[2, e, 0]
    g[7, e, 0] = g[5, e, 0] - (1.0 / 6.0) * u_lid
    g[6, e, 0] = -u_lid / 12.0
    g[8, e, 0] = u_lid / 12.0
    g[0, e, 0] = 1.0 - g[1:, e, 0].sum(dim=0)
    return g


def _fused_bc(cfg: SimConfig, f, rho_lid_prev):
    """Boundary dispatch for the fused pull engine: reduced NEBB
    (production) or the tangential Zou-He lid variant."""
    if cfg.boundary == "nebb_tangential":
        return _fused_gather_bc_tangential(cfg, f)
    return _fused_gather_bc(cfg, f, rho_lid_prev)


def _fused_macros(cfg: SimConfig, g):
    """Macros + wall overrides for the fused step (GPU-kernel corner rules)."""
    rho, u = macroscopics(g)
    u, rho = bc_ops.override_wall_velocity(u, rho, g, cfg.u_lid, "wall")
    return rho, u


def make_fused_step(cfg: SimConfig) -> Callable[[State], State]:
    def step(state: State) -> State:
        g = _fused_bc(cfg, state.f, state.rho_lid)
        rho, u = _fused_macros(cfg, g)
        feq = equilibrium(rho, u)
        f_new = _collide(cfg, g, feq, rho)
        return State(f=f_new, rho_lid=rho[:, 0].clone())

    return step


def make_fused_step_omega(cfg: SimConfig) -> Callable[[State, float], State]:
    """Fused step with the shear relaxation rate as an argument, so one step
    serves every Reynolds number of a sweep (reference:
    ``MRT_GPU_datagen.py:55-57``)."""

    def step(state: State, omega) -> State:
        g = _fused_gather_bc(cfg, state.f, state.rho_lid)
        rho, u = _fused_macros(cfg, g)
        feq = equilibrium(rho, u)
        f_new = _collide(cfg, g, feq, rho, omega=omega)
        return State(f=f_new, rho_lid=rho[:, 0].clone())

    return step


# ---------------------------------------------------------------------------
# Observables & runners
# ---------------------------------------------------------------------------

def observables(cfg: SimConfig, state: State):
    """Macroscopic (rho, u) as the reference engines report them: the
    boundary-corrected pre-collision moments with wall overrides applied
    (reference: MRTTiledPull.py:454-472)."""
    g = _fused_bc(cfg, state.f, state.rho_lid)
    return _fused_macros(cfg, g)


def make_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``n_steps`` plain fused steps per call (the JAX package's
    ``lax.scan`` runner as a loop)."""
    device = resolve_device(device)
    step = make_fused_step(cfg)

    def run(state: State) -> State:
        _check_device(state, device)
        for _ in range(n_steps):
            state = step(state)
        return state

    return run


class RunResult(NamedTuple):
    state: State
    steps: int
    converged: bool
    mean_u_history: list


def run_to_convergence(
    cfg: SimConfig,
    state: State | None = None,
    callback=None,
    device="cuda",
    runner=None,
) -> RunResult:
    """Chunked driver: ``report_interval`` steps per call, then one scalar
    fetch for the convergence test |d mean(u)| / uLB < tol sustained for
    ``convergence_hits`` + 1 consecutive checks (the stop fires once hits
    *exceed* the threshold; reference: MRTtest.py:915-921).

    ``runner`` advances a state by ``report_interval`` steps; by default it
    is this module's plain ``make_scan_runner``.  The package-level
    ``run_to_convergence`` (``sim.run_to_convergence``) passes the runner
    that ``simulate`` picks: the CUDA kernel for a float32 NEBB run on the
    card.  ``callback(step, state, rho, u)`` runs every interval.
    """
    cfg.validate()
    device = resolve_device(device)
    if state is None:
        state = init_state(cfg, device)
    chunk = max(1, cfg.report_interval)
    if runner is None:
        runner = make_scan_runner(cfg, chunk, device)

    mean_u_past = np.inf
    hits = 0
    history = []
    steps_done = 0
    converged = False
    while steps_done < cfg.max_steps:
        state = runner(state)
        steps_done += chunk
        rho, u = observables(cfg, state)
        # f64 host reduction: at f32 the device mean's rounding floor sits near
        # the 1e-8 convergence tolerance.
        mean_u = float(np.mean(u.cpu().numpy(), dtype=np.float64))
        history.append(mean_u)
        if not np.isfinite(mean_u):
            raise FloatingPointError(
                f"simulation diverged at step {steps_done} (mean u = {mean_u})"
            )
        if callback is not None:
            callback(steps_done, state, rho, u)
        if abs(mean_u - mean_u_past) / cfg.u_lid < cfg.convergence_tol:
            hits += 1
            if hits > cfg.convergence_hits:
                converged = True
                break
        else:
            hits = 0
        mean_u_past = mean_u
    return RunResult(state=state, steps=steps_done, converged=converged,
                     mean_u_history=history)
