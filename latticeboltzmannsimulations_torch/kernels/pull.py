"""The fused pull collide-and-stream step as a hand-written CUDA kernel.

Counterpart of the JAX package's ``kernels/pallas_pull.py`` (``make_step``,
``make_scan_runner``): the same ``State`` contract, ``(f, rho_lid)`` in and
out.  The kernel is ``csrc/pull_step.cu``; its plain PyTorch version is the
fused engine step, ``engine.make_fused_step``.  A configuration with the
tangential lid (``boundary="nebb_tangential"``, which the JAX driver runs on
its XLA-fused engine) launches the source's second instantiation, the entry
``lbm_pull_step_tangential``; its plain version is the same engine step,
whose gather then takes ``engine._fused_gather_bc_tangential``.

The sweep form (``make_step_omega``, ``make_scan_runner_omega``,
``make_sweep_runner``: the JAX ``make_step(traced_omega=True, n_cav=...)``)
takes the relaxation rate as an argument and advances ``n_cav`` independent
cavities stacked along x, each with its own rate, in one launch per step:
the entry ``lbm_pull_sweep_step`` of the same source, over the same cell
routine.  Its plain version is ``engine.make_stacked_step_omega``.

A step on CUDA tensors launches the kernel or raises; a step on CPU tensors
runs the plain version (that is what the CPU tests exercise).  There is no
fallback from one to the other.  On the card the runners
(``make_scan_runner``, ``make_sweep_runner``) replay their chunk as CUDA
graphs (``kernels/graphs.py``), as the JAX runners run theirs in one
compiled dispatch; ``_eager_scan_runner`` and ``_eager_sweep_runner`` launch
the same steps one by one from the host, the form the graphs are held to.

``launches`` counts the one-cavity NEBB kernel's launches in this process,
``tangential_launches`` the tangential one's and ``sweep_launches`` the
sweep form's, so a run can show that its steps went through the kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SimConfig, resolve_device
from ..engine import State, make_fused_step, make_stacked_step_omega
from ..ops.collision import van_driest_cs2
from . import _build, graphs

launches = 0
tangential_launches = 0
sweep_launches = 0

_COLLISION = {"srt": 0, "trt": 1, "mrt": 2}
_LES_NONE, _LES_SCALAR, _LES_PLANE = 0, 1, 2


# The limits of the sweep form: cavities on gridDim.z, columns in an int.
MAX_CAVITIES = 65535
MAX_COLUMNS = 2**31 - 1


def unsupported_reason(cfg: SimConfig, traced_omega: bool = False,
                       n_cav: int = 1) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can;
    ``traced_omega`` and ``n_cav`` ask for the sweep form, which is
    reduced NEBB only, as the JAX package's traced-omega step is."""
    if cfg.precision != "float32":
        return "the CUDA kernel is float32; use the plain engine for float64"
    if cfg.boundary not in ("nebb", "nebb_tangential"):
        return (f"the CUDA kernel implements the reduced NEBB walls and the "
                f"tangential lid, not {cfg.boundary!r}")
    if cfg.boundary != "nebb" and (traced_omega or n_cav > 1):
        return (f"the sweep form (a traced omega, stacked cavities) implements "
                f"the reduced NEBB walls, not {cfg.boundary!r}")
    if cfg.mesh_shape != (1, 1):
        return "the CUDA kernel runs on one device"
    if n_cav > 1 and not traced_omega:
        return "stacked cavities (n_cav > 1) need a traced omega"
    if traced_omega and cfg.turbulence == "smagorinsky" and cfg.van_driest:
        return ("Van Driest damping depends on the Reynolds number through the "
                "viscous length, so it cannot ride a traced-omega sweep")
    if not 1 <= n_cav <= MAX_CAVITIES:
        return f"the sweep form takes 1 to {MAX_CAVITIES} cavities, not {n_cav}"
    if n_cav * cfg.nx > MAX_COLUMNS:
        return (f"{n_cav} cavities of {cfg.nx} columns exceed the kernel's "
                f"{MAX_COLUMNS} columns")
    return None


def _check_cfg(cfg: SimConfig, traced_omega: bool = False, n_cav: int = 1) -> None:
    cfg.validate()
    reason = unsupported_reason(cfg, traced_omega, n_cav)
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
                 device: torch.device, n_cav: int = 1) -> None:
    """What the kernel takes, checked on either device, so the CPU path
    holds a caller to the same contract as the card (``n_cav`` cavities
    stacked along x for the sweep form)."""
    _check_tensor("f", f, (9, n_cav * cfg.nx, cfg.ny), device)
    _check_tensor("rho_lid", rho_lid, (n_cav * cfg.nx,), device)


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


def _lid_scalars(cfg: SimConfig) -> tuple | None:
    """The tangential lid's constants after ``_scalars``: ``0.5 u``, ``(2/3)
    u``, ``(1/6) u`` and ``u / 12``, computed in double as the plain
    version's Python scalars are and rounded once to float32; None for the
    reduced NEBB lid."""
    if cfg.boundary != "nebb_tangential":
        return None
    u = cfg.u_lid
    return (0.5 * u, (2.0 / 3.0) * u, (1.0 / 6.0) * u, u / 12.0)


def _launch(lib, f_ptr: int, rho_ptr: int, cs2_ptr: int | None, f_out_ptr: int,
            rho_out_ptr: int, scalars: tuple, stream: int,
            lid: tuple | None = None) -> None:
    """One launch of the NEBB kernel, or with ``lid`` (``_lid_scalars``) of
    the tangential one, which reads no ``rho_ptr``."""
    global launches, tangential_launches
    if lid is None:
        name = "pull_step"
        err = lib.lbm_pull_step(f_ptr, rho_ptr, cs2_ptr, f_out_ptr, rho_out_ptr,
                                *scalars, stream)
    else:
        name = "pull_step_tangential"
        err = lib.lbm_pull_step_tangential(f_ptr, cs2_ptr, f_out_ptr, rho_out_ptr,
                                           *scalars, *lid, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.lbm_error_string(err).decode()}"
        )
    if lid is None:
        launches += 1
    else:
        tangential_launches += 1


def pull_step(cfg: SimConfig, f: torch.Tensor, rho_lid: torch.Tensor,
              f_out: torch.Tensor, rho_lid_out: torch.Tensor,
              cs2_plane: torch.Tensor | None = None) -> None:
    """Launch the kernel once on the current stream:
    ``(f, rho_lid) -> (f_out, rho_lid_out)``.  Does not synchronise.

    All tensors are contiguous float32 on one CUDA device; ``f_out`` must not
    be ``f`` (the pull gather reads neighbours that an in-place update would
    already have overwritten).  ``cs2_plane`` is the Van Driest Cs^2 plane,
    required exactly when the configuration damps Cs^2 at the walls.  With
    the tangential lid the kernel is ``lbm_pull_step_tangential``, which
    reads no ``rho_lid``.
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
                _scalars(cfg), torch.cuda.current_stream(device).cuda_stream,
                _lid_scalars(cfg))


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


def _state_ptrs(state) -> tuple:
    return state[0].data_ptr(), state[1].data_ptr()


def make_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``n_steps`` fused steps per call.  On the card each call is one
    replay of the chunk's CUDA graphs (``graphs.PingPong``, one kernel
    launch per step captured), on the current stream and without
    synchronising: the input is copied into the first of two state buffers
    that the runner holds from its first call on (``2 * (9 * nx * ny +
    nx)`` floats), and the result is copied out of them.  The input state
    is never written, and the returned state owns its tensors.  On the CPU
    the plain version step by step."""
    _check_cfg(cfg)
    device = resolve_device(device)
    if device.type == "cpu":
        plain = make_fused_step(cfg)

        def run_plain(state: State) -> State:
            _check_state(cfg, state.f, state.rho_lid, device)
            for _ in range(n_steps):
                state = plain(state)
            return state

        return run_plain
    # The runner holds the Van Driest plane itself, not only its address:
    # the graphs read it on every replay, and a plane freed after the runner
    # is built would leave the kernel reading whatever the allocator puts
    # there next.
    cs2 = _cs2_plane(cfg, device)
    scalars, lid = _scalars(cfg), _lid_scalars(cfg)

    def launch(one: graphs.Launch, bufs) -> None:
        _launch(_build.load_library(), *_state_ptrs(bufs[one.src]),
                None if cs2 is None else cs2.data_ptr(),
                *_state_ptrs(bufs[one.dst]), scalars,
                torch.cuda.current_stream(device).cuda_stream, lid)

    chunk = (graphs.PingPong(device, [(9, cfg.nx, cfg.ny), (cfg.nx,)],
                             graphs.plan(n_steps), launch) if n_steps else None)

    def run(state: State) -> State:
        _check_state(cfg, state.f, state.rho_lid, device)
        if chunk is None:
            return state
        return State(*chunk(state))

    return run


def _eager_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``make_scan_runner``'s steps on the card launched one by one from the
    host, into two buffers allocated per call: the form its graphs are held
    to (``chip_smoke.py``, the card tests)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    cs2 = _cs2_plane(cfg, device)
    scalars, lid = _scalars(cfg), _lid_scalars(cfg)

    def run(state: State) -> State:
        _check_state(cfg, state.f, state.rho_lid, device)
        if n_steps == 0:
            return state
        cs2_ptr = None if cs2 is None else cs2.data_ptr()
        lib = _build.load_library()
        bufs = [State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
                for _ in range(2)]
        ptrs = [(b.f.data_ptr(), b.rho_lid.data_ptr()) for b in bufs]
        src = (state.f.data_ptr(), state.rho_lid.data_ptr())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for i in range(n_steps):
                dst = ptrs[i % 2]
                _launch(lib, *src, cs2_ptr, *dst, scalars, stream, lid)
                src = dst
        return bufs[(n_steps - 1) % 2]

    return run


def cavity_table(cfg: SimConfig, omegas) -> np.ndarray:
    """The sweep form's per-cavity scalars, one float32 row ``(omega, tau0,
    tau0^2, omega^-)`` per cavity, from each cavity's omega rounded to
    float32: ``tau0 = 1 / omega`` and the TRT ``omega^-`` from the base
    ``tau0`` (also under LES), in float32 arithmetic, as the JAX package's
    traced-omega kernel computes them from its float32 SMEM vector.  The
    one-cavity and the stacked forms both read this table, so a stack
    equals its cavities run one at a time bit for bit."""
    om = np.asarray(omegas, dtype=np.float32).reshape(-1)
    one, half = np.float32(1.0), np.float32(0.5)
    tau0 = one / om
    omega_minus = one / (half + np.float32(cfg.trt_magic) / (tau0 - half))
    return np.stack([om, tau0, tau0 * tau0, omega_minus], axis=1)


def _sweep_scalars(cfg: SimConfig) -> tuple:
    """``lbm_pull_sweep_step``'s scalars after the table: ``_scalars``
    without the four per-cavity values."""
    s = _scalars(cfg)
    return (*s[:4], *s[8:])


def _launch_sweep(lib, f_ptr: int, rho_ptr: int, f_out_ptr: int, rho_out_ptr: int,
                  n_cav: int, table_ptr: int, scalars: tuple, stream: int) -> None:
    global sweep_launches
    err = lib.lbm_pull_sweep_step(f_ptr, rho_ptr, f_out_ptr, rho_out_ptr, n_cav,
                                  table_ptr, *scalars, stream)
    if err != 0:
        raise RuntimeError(
            f"pull_sweep_step launch failed: {lib.lbm_error_string(err).decode()}"
        )
    sweep_launches += 1


def _host_omegas(omegas, n_cav: int) -> np.ndarray:
    """The omegas as host values: a number, a sequence, an array or a
    tensor (one on the card is copied to the host, which waits for it)."""
    if isinstance(omegas, torch.Tensor):
        omegas = omegas.detach().cpu().numpy()
    om = np.asarray(omegas, dtype=np.float64).reshape(-1)
    if om.shape != (n_cav,):
        raise ValueError(f"{om.size} omegas for {n_cav} cavities")
    return om


def make_sweep_runner(cfg: SimConfig, n_cav: int, n_steps: int, device="cuda"):
    """``n_steps`` steps of ``n_cav`` independent cavities stacked along x,
    ``run(state, omegas) -> state``, each cavity with its own omega: ``f (9,
    n_cav * nx, ny)``, ``rho_lid (n_cav * nx,)``, as the JAX package's
    ``make_sweep_runner``.  On the card one replay of the chunk's CUDA
    graphs per call, as ``make_scan_runner``'s (two stacked state buffers
    held from the first call on, ``2 * n_cav * (9 * nx * ny + nx)``
    floats; the input never written), reading a cavity table that the
    runner holds: a call whose omegas differ from the last one's copies
    their table into it on the stream before the replay, from pinned memory
    (a pageable upload waits for the queued work), so the same graphs run
    the new rates.  On the CPU the plain version,
    ``engine.make_stacked_step_omega``."""
    _check_cfg(cfg, traced_omega=True, n_cav=n_cav)
    device = resolve_device(device)
    if device.type == "cpu":
        plain = make_stacked_step_omega(cfg, n_cav)

        def run_plain(state: State, omegas) -> State:
            _check_state(cfg, state.f, state.rho_lid, device, n_cav)
            om = torch.from_numpy(cavity_table(cfg, _host_omegas(omegas, n_cav))[:, 0].copy())
            for _ in range(n_steps):
                state = plain(state, om)
            return state

        return run_plain
    scalars = _sweep_scalars(cfg)
    table = torch.zeros((n_cav, 4), dtype=torch.float32, device=device)
    copied = {"key": None}

    def launch(one: graphs.Launch, bufs) -> None:
        _launch_sweep(_build.load_library(), *_state_ptrs(bufs[one.src]),
                      *_state_ptrs(bufs[one.dst]), n_cav, table.data_ptr(), scalars,
                      torch.cuda.current_stream(device).cuda_stream)

    width = n_cav * cfg.nx
    chunk = (graphs.PingPong(device, [(9, width, cfg.ny), (width,)],
                             graphs.plan(n_steps), launch) if n_steps else None)

    def run(state: State, omegas) -> State:
        _check_state(cfg, state.f, state.rho_lid, device, n_cav)
        rows = cavity_table(cfg, _host_omegas(omegas, n_cav))
        if chunk is None:
            return state
        key = rows.tobytes()
        if copied["key"] != key:
            with torch.cuda.device(device):
                table.copy_(torch.from_numpy(rows).pin_memory(), non_blocking=True)
            copied["key"] = key
        return State(*chunk(state))

    return run


def _eager_sweep_runner(cfg: SimConfig, n_cav: int, n_steps: int, device="cuda"):
    """``make_sweep_runner``'s steps on the card launched one by one from
    the host, into buffers allocated per call, the table uploaded once per
    new set of omegas: the form its graphs are held to."""
    _check_cfg(cfg, traced_omega=True, n_cav=n_cav)
    device = resolve_device(device)
    scalars = _sweep_scalars(cfg)
    cached = {"key": None, "table": None}

    def upload(table: np.ndarray) -> torch.Tensor:
        key = table.tobytes()
        if cached["key"] != key:
            host = torch.from_numpy(table).pin_memory()
            cached["table"] = host.to(device, non_blocking=True)
            cached["key"] = key
        return cached["table"]

    def run(state: State, omegas) -> State:
        _check_state(cfg, state.f, state.rho_lid, device, n_cav)
        table = cavity_table(cfg, _host_omegas(omegas, n_cav))
        if n_steps == 0:
            return state
        lib = _build.load_library()
        with torch.cuda.device(device):
            table_ptr = upload(table).data_ptr()
            bufs = [State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
                    for _ in range(min(2, n_steps))]
            ptrs = [(b.f.data_ptr(), b.rho_lid.data_ptr()) for b in bufs]
            src = (state.f.data_ptr(), state.rho_lid.data_ptr())
            stream = torch.cuda.current_stream(device).cuda_stream
            for i in range(n_steps):
                dst = ptrs[i % 2]
                _launch_sweep(lib, *src, *dst, n_cav, table_ptr, scalars, stream)
                src = dst
        return bufs[(n_steps - 1) % 2]

    return run


def make_scan_runner_omega(cfg: SimConfig, n_steps: int, device="cuda"):
    """``n_steps`` steps of one cavity with omega as an argument, ``run(state,
    omega) -> state``: one kernel build for every Reynolds number of a sweep
    (the JAX package's ``make_scan_runner_omega``).  The sweep form with one
    cavity."""
    sweep = make_sweep_runner(cfg, 1, n_steps, device)

    def run(state: State, omega) -> State:
        return sweep(state, [omega])

    return run


def make_step_omega(cfg: SimConfig, device="cuda"):
    """One step ``(state, omega) -> state`` of one cavity, the same
    trajectory as ``engine.make_fused_step_omega`` with a float32 omega (the
    JAX package's ``make_step(traced_omega=True)``)."""
    return make_scan_runner_omega(cfg, 1, device)
