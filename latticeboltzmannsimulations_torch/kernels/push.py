"""The fused push collide-and-stream step as a hand-written CUDA kernel.

Counterpart of the JAX package's ``kernels/pallas_push.py``
(``make_push_step``, ``make_push_scan_runner``): one step on the plain
pre-collision field ``f``, in the reference NumPy engine's order (moments,
wall-velocity override, feq, collision, push stream, full NEBB with this
step's feq).  The kernel is ``csrc/push_step.cu``; its plain PyTorch version
is the push oracle, ``engine.make_push_oracle_step``.  Like the JAX
package's push kernel it is taken only when asked for
(``backend="cuda-push"``); the pull kernels stay the production path.

A step on CUDA tensors launches the kernel or raises; a step on CPU tensors
runs the plain version.  There is no fallback from one to the other.  On
the card the runner replays its chunk as CUDA graphs
(``kernels/graphs.py``); ``_eager_push_scan_runner`` launches the same
steps one by one from the host, the form the graphs are held to.

``launches`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, resolve_device
from ..engine import State, _check_device, make_push_oracle_step
from . import _build, graphs, pull

launches = 0


def unsupported_reason(cfg: SimConfig) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can."""
    if cfg.boundary != "nebb":
        return (f"the push kernel implements the NEBB walls, not "
                f"{cfg.boundary!r}; the push oracle runs the others")
    reason = pull.unsupported_reason(cfg)
    if reason is not None:
        return reason
    if cfg.turbulence == "smagorinsky" and cfg.van_driest:
        return ("the push kernel has no Van Driest Cs^2 plane; use the "
                "one-step pull kernel")
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


def _launch(lib, f_ptr: int, f_out_ptr: int, scalars: tuple, stream: int) -> None:
    global launches
    err = lib.lbm_push_step(f_ptr, f_out_ptr, *scalars, stream)
    if err != 0:
        raise RuntimeError(
            f"push_step launch failed: {lib.lbm_error_string(err).decode()}"
        )
    launches += 1


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
        _launch(_build.load_library(), f.data_ptr(), f_out.data_ptr(),
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
        _launch(_build.load_library(), bufs[one.src][0].data_ptr(),
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
                _launch(lib, src, dst, scalars, stream)
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
