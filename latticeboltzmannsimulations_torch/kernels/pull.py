"""The fused pull collide-and-stream step as a hand-written CUDA kernel.

Counterpart of the JAX package's ``kernels/pallas_pull.py`` (``make_step``,
``make_scan_runner``): the same ``State`` contract, ``(f, rho_lid)`` in and
out.  The kernel is ``csrc/pull_step.cu``; its plain PyTorch version is the
fused engine step, ``engine.make_fused_step``.

A step on CUDA tensors launches the kernel or raises; a step on CPU tensors
runs the plain version (that is what the CPU tests exercise).  There is no
fallback from one to the other.

``launches`` counts the kernel's launches in this process, so a run can show
that its steps went through the kernel.
"""

from __future__ import annotations

import math

import torch

from ..config import SimConfig, resolve_device
from ..engine import State, make_fused_step
from ..ops.collision import van_driest_cs2
from . import _build

launches = 0

_COLLISION = {"srt": 0, "trt": 1, "mrt": 2}
_LES_NONE, _LES_SCALAR, _LES_PLANE = 0, 1, 2


def unsupported_reason(cfg: SimConfig) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can."""
    if cfg.precision != "float32":
        return "the CUDA kernel is float32; use the plain engine for float64"
    if cfg.boundary != "nebb":
        return (f"the CUDA kernel implements the reduced NEBB walls, not "
                f"{cfg.boundary!r}")
    if cfg.mesh_shape != (1, 1):
        return "the CUDA kernel runs on one device"
    return None


def _check_cfg(cfg: SimConfig) -> None:
    cfg.validate()
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)


def _cs2_plane(cfg: SimConfig, device: torch.device) -> torch.Tensor | None:
    """The staged Van Driest Cs^2 plane, computed once per runner, by the
    same function the plain version calls every step."""
    if cfg.turbulence == "smagorinsky" and cfg.van_driest:
        return van_driest_cs2(cfg.nx, cfg.ny, cfg.u_lid / cfg.nu,
                              dtype=torch.float32, device=device)
    return None


def _check_tensor(name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")


def _check_state(cfg: SimConfig, f: torch.Tensor, rho_lid: torch.Tensor,
                 device: torch.device) -> None:
    """What the kernel takes, checked on either device, so the CPU path
    holds a caller to the same contract as the card."""
    _check_tensor("f", f, (9, cfg.nx, cfg.ny), device)
    _check_tensor("rho_lid", rho_lid, (cfg.nx,), device)


def _scalars(cfg: SimConfig) -> tuple:
    """The kernel's scalar arguments, from ``nx`` to ``smag_coef``.  Derived
    values are computed in double here and rounded once to float32, as the
    plain version's Python-scalar arithmetic is."""
    if cfg.turbulence != "smagorinsky":
        les = _LES_NONE
    else:
        les = _LES_PLANE if cfg.van_driest else _LES_SCALAR
    tau0 = cfg.tau
    return (cfg.nx, cfg.ny, cfg.u_lid, cfg.u_lid / 6.0, cfg.omega, tau0,
            tau0 * tau0, cfg.trt_omega_minus, cfg.mrt_omega_e,
            cfg.mrt_omega_eps, cfg.mrt_omega_q, _COLLISION[cfg.collision], les,
            18.0 * math.sqrt(2.0) * cfg.smagorinsky_cs2)


def _launch(lib, f_ptr: int, rho_ptr: int, cs2_ptr: int | None, f_out_ptr: int,
            rho_out_ptr: int, scalars: tuple, stream: int) -> None:
    global launches
    err = lib.lbm_pull_step(f_ptr, rho_ptr, cs2_ptr, f_out_ptr, rho_out_ptr,
                            *scalars, stream)
    if err != 0:
        raise RuntimeError(
            f"pull_step launch failed: {lib.lbm_error_string(err).decode()}"
        )
    launches += 1


def pull_step(cfg: SimConfig, f: torch.Tensor, rho_lid: torch.Tensor,
              f_out: torch.Tensor, rho_lid_out: torch.Tensor,
              cs2_plane: torch.Tensor | None = None) -> None:
    """Launch the kernel once on the current stream:
    ``(f, rho_lid) -> (f_out, rho_lid_out)``.  Does not synchronise.

    All tensors are contiguous float32 on one CUDA device; ``f_out`` must not
    be ``f`` (the pull gather reads neighbours that an in-place update would
    already have overwritten).  ``cs2_plane`` is the Van Driest Cs^2 plane,
    required exactly when the configuration damps Cs^2 at the walls.
    """
    _check_cfg(cfg)
    device = f.device
    _check_state(cfg, f, rho_lid, device)
    _check_state(cfg, f_out, rho_lid_out, device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {device}")
    if f_out.data_ptr() == f.data_ptr() or rho_lid_out.data_ptr() == rho_lid.data_ptr():
        raise ValueError("the pull step cannot run in place; give it two buffers")
    if (cfg.turbulence == "smagorinsky" and cfg.van_driest) != (cs2_plane is not None):
        raise ValueError("cs2_plane is required for, and only for, Van Driest damping")
    cs2_ptr = None
    if cs2_plane is not None:
        _check_tensor("cs2_plane", cs2_plane, (cfg.nx, cfg.ny), device)
        cs2_ptr = cs2_plane.data_ptr()
    with torch.cuda.device(device):
        _launch(_build.load_library(), f.data_ptr(), rho_lid.data_ptr(),
                cs2_ptr, f_out.data_ptr(), rho_lid_out.data_ptr(),
                _scalars(cfg), torch.cuda.current_stream(device).cuda_stream)


def make_step(cfg: SimConfig, device="cuda"):
    """One fused step ``State -> State``, the same trajectory as
    ``engine.make_fused_step``: the CUDA kernel for a state on the card, the
    plain version for a state on the CPU.  Each call allocates its output."""
    _check_cfg(cfg)
    device = resolve_device(device)
    plain = make_fused_step(cfg)
    cs2 = _cs2_plane(cfg, device) if device.type == "cuda" else None

    def step(state: State) -> State:
        _check_state(cfg, state.f, state.rho_lid, device)
        if device.type == "cpu":
            return plain(state)
        out = State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
        pull_step(cfg, state.f, state.rho_lid, out.f, out.rho_lid, cs2)
        return out

    return step


def make_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``n_steps`` fused steps per call.  On the card each call allocates two
    buffers once and ping-pongs between them, one kernel launch per step, on
    the current stream and without synchronising; the input state is never
    written, and the returned state owns its tensors."""
    _check_cfg(cfg)
    device = resolve_device(device)
    plain = make_fused_step(cfg)
    cs2 = _cs2_plane(cfg, device) if device.type == "cuda" else None
    cs2_ptr = cs2.data_ptr() if cs2 is not None else None
    scalars = _scalars(cfg)

    def run(state: State) -> State:
        _check_state(cfg, state.f, state.rho_lid, device)
        if device.type == "cpu":
            for _ in range(n_steps):
                state = plain(state)
            return state
        if n_steps == 0:
            return state
        lib = _build.load_library()
        bufs = [State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
                for _ in range(2)]
        ptrs = [(b.f.data_ptr(), b.rho_lid.data_ptr()) for b in bufs]
        src = (state.f.data_ptr(), state.rho_lid.data_ptr())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for i in range(n_steps):
                dst = ptrs[i % 2]
                _launch(lib, *src, cs2_ptr, *dst, scalars, stream)
                src = dst
        return bufs[(n_steps - 1) % 2]

    return run
