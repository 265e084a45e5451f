"""The fused push collide-and-stream step as a hand-written CUDA kernel.

Counterpart of the JAX package's ``kernels/pallas_push.py``
(``make_push_step``, ``make_push_scan_runner``): one step on the plain
pre-collision field ``f``, in the reference NumPy engine's order (moments,
wall-velocity override, feq, collision, push stream, walls with this step's
feq).  The kernel is ``csrc/push_step.cu``; its plain PyTorch version is the
push oracle, ``engine.make_push_oracle_step``.  It serves three walls: the
full NEBB (``boundary="nebb"``, the entry ``lbm_push_step``, as the JAX
package's push kernel), and the two walls that the JAX package runs only on
its push oracle, ``nebb_west_eq`` and ``bounce_back`` (the entry
``lbm_push_step_wall``, the wall kind its argument).  For NEBB it is taken
only when asked for (``backend="cuda-push"``), the pull kernels staying the
production path; for the other two ``backend="auto"`` takes it on the card
(``sim._select_backend``).

A step on CUDA tensors launches the kernel or raises; a step on CPU tensors
runs the plain version.  There is no fallback from one to the other.  On
the card the runner replays its chunk as CUDA graphs
(``kernels/graphs.py``); ``_eager_push_scan_runner`` launches the same
steps one by one from the host, the form the graphs are held to.

``launches`` counts the NEBB kernel's launches in this process,
``west_eq_launches`` and ``bounce_back_launches`` the other two walls'.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, resolve_device
from ..engine import State, _check_device, make_push_oracle_step
from . import _build, graphs, pull

launches = 0
west_eq_launches = 0
bounce_back_launches = 0

# The push kernel's walls by csrc/push_step.cu's enum Wall: NEBB through the
# entry lbm_push_step, the other two through lbm_push_step_wall.
WALLS = {"nebb": 0, "nebb_west_eq": 1, "bounce_back": 2}


def unsupported_reason(cfg: SimConfig) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can."""
    if cfg.precision != "float32":
        return "the CUDA kernel is float32; use the push oracle for float64"
    if cfg.boundary not in WALLS:
        return (f"the push kernel implements the NEBB, NEBB west-equilibrium and "
                f"bounce-back walls, not {cfg.boundary!r}")
    if cfg.mesh_shape != (1, 1):
        return "the CUDA kernel runs on one device"
    if cfg.turbulence == "smagorinsky" and cfg.van_driest:
        return ("the push kernel has no Van Driest Cs^2 plane; use the push "
                "oracle, or for NEBB the one-step pull kernel")
    if -(-cfg.ny // 32) > 65535:
        return f"ny={cfg.ny} needs more than 65535 tiles of 32 rows"
    return None


def _check_cfg(cfg: SimConfig) -> None:
    cfg.validate()
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)


def _check_f(cfg: SimConfig, f: torch.Tensor, device: torch.device) -> None:
    pull._check_tensor("f", f, (9, cfg.nx, cfg.ny), device)


def _launch(lib, boundary: str, f_ptr: int, f_out_ptr: int, scalars: tuple,
            stream: int) -> None:
    """One launch of the entry of ``boundary``'s walls, counted."""
    global launches, west_eq_launches, bounce_back_launches
    if boundary == "nebb":
        err = lib.lbm_push_step(f_ptr, f_out_ptr, *scalars, stream)
    else:
        err = lib.lbm_push_step_wall(f_ptr, f_out_ptr, *scalars, WALLS[boundary], stream)
    if err != 0:
        raise RuntimeError(
            f"push_step launch failed ({boundary}): {lib.lbm_error_string(err).decode()}"
        )
    if boundary == "nebb":
        launches += 1
    elif boundary == "nebb_west_eq":
        west_eq_launches += 1
    else:
        bounce_back_launches += 1


def push_step(cfg: SimConfig, f: torch.Tensor, f_out: torch.Tensor) -> None:
    """Launch the kernel once on the current stream: ``f -> f_out``.  Does
    not synchronise.  Both are contiguous float32 on one CUDA device, and
    ``f_out`` is not ``f`` (blocks read their halos while others write)."""
    _check_cfg(cfg)
    device = f.device
    _check_f(cfg, f, device)
    pull._check_tensor("f_out", f_out, (9, cfg.nx, cfg.ny), device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {device}")
    if f_out.data_ptr() == f.data_ptr():
        raise ValueError("the push step cannot run in place; give it two buffers")
    with torch.cuda.device(device):
        _launch(_build.load_library(), cfg.boundary, f.data_ptr(), f_out.data_ptr(),
                pull._scalars(cfg), torch.cuda.current_stream(device).cuda_stream)


def make_push_step(cfg: SimConfig, device="cuda"):
    """One push step ``f -> f``, the same trajectory as
    ``engine.make_push_oracle_step``: the CUDA kernel for a field on the
    card, the plain version for a field on the CPU.  Each call allocates its
    output."""
    _check_cfg(cfg)
    device = resolve_device(device)
    plain = make_push_oracle_step(cfg)

    def step(f: torch.Tensor) -> torch.Tensor:
        _check_f(cfg, f, device)
        if device.type == "cpu":
            return plain(f)
        out = torch.empty_like(f)
        push_step(cfg, f, out)
        return out

    return step


def make_push_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``n_steps`` push steps per call ``f -> f``.  On the card each call is
    one replay of the chunk's CUDA graphs (``graphs.PingPong``), on the
    current stream and without synchronising: the input is copied into the
    first of two fields that the runner holds from its first call on (``2 *
    9 * nx * ny`` floats), and the result is copied out.  The input is never
    written, and the returned field is the caller's.  On the CPU the plain
    version step by step."""
    _check_cfg(cfg)
    device = resolve_device(device)
    if device.type == "cpu":
        plain = make_push_oracle_step(cfg)

        def run_plain(f: torch.Tensor) -> torch.Tensor:
            _check_f(cfg, f, device)
            for _ in range(n_steps):
                f = plain(f)
            return f

        return run_plain
    scalars = pull._scalars(cfg)

    def launch(one: graphs.Launch, bufs) -> None:
        _launch(_build.load_library(), cfg.boundary, bufs[one.src][0].data_ptr(),
                bufs[one.dst][0].data_ptr(), scalars,
                torch.cuda.current_stream(device).cuda_stream)

    chunk = (graphs.PingPong(device, [(9, cfg.nx, cfg.ny)], graphs.plan(n_steps), launch)
             if n_steps else None)

    def run(f: torch.Tensor) -> torch.Tensor:
        _check_f(cfg, f, device)
        if chunk is None:
            return f
        return chunk((f,))[0]

    return run


def _eager_push_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``make_push_scan_runner``'s steps on the card launched one by one
    from the host, into two buffers allocated per call: the form its
    graphs are held to (``chip_smoke.py``, the card tests)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    scalars = pull._scalars(cfg)

    def run(f: torch.Tensor) -> torch.Tensor:
        _check_f(cfg, f, device)
        if n_steps == 0:
            return f
        lib = _build.load_library()
        bufs = [torch.empty_like(f) for _ in range(2)]
        src = f.data_ptr()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for i in range(n_steps):
                dst = bufs[i % 2].data_ptr()
                _launch(lib, cfg.boundary, src, dst, scalars, stream)
                src = dst
        return bufs[(n_steps - 1) % 2]

    return run


def make_scan_runner(cfg: SimConfig, n_steps: int, device="cuda"):
    """``make_push_scan_runner`` on a ``State``, for the driver: the lid
    density slot holds the placeholder ``f[0, :, 0]``, as on the push
    oracle's path."""
    runner = make_push_scan_runner(cfg, n_steps, device)
    device = resolve_device(device)

    def run(state: State) -> State:
        _check_device(state, device)
        f = runner(state.f)
        return State(f=f, rho_lid=f[0, :, 0])

    return run
