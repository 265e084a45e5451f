"""K fused pull steps per launch (temporal blocking) as a hand-written CUDA
kernel.

Counterpart of the JAX package's ``kernels/pallas_pull_tblock.py``
(``make_block_step``, ``make_scan_runner``): the same ``State`` contract,
``(f, rho_lid)`` in and out, advanced by ``k_steps`` steps per launch.  The
kernel is ``csrc/tblock_step.cu``; its plain PyTorch version is ``k_steps``
steps of the fused engine step, ``engine.make_fused_step``.  A runner's
``n mod k_steps`` remaining steps go through the one-step kernel
(``kernels/pull.py``), as the JAX runner's go through ``make_step``.

A block step on CUDA tensors launches the kernel or raises; on CPU tensors
it runs the plain version (that is what the CPU tests exercise).  There is
no fallback from one to the other.  On the card the runner replays its
chunk as CUDA graphs (``kernels/graphs.py``); ``_eager_scan_runner``
launches the same steps one by one from the host, the form the graphs are
held to.

``launches`` counts this kernel's launches in this process (the remainder
steps count in ``pull.launches``).
"""

from __future__ import annotations

import torch

from ..config import SimConfig, resolve_device
from ..engine import State, make_fused_step
from . import _build, graphs, pull

launches = 0

# Window edge of the kernel (csrc/tblock_window.cuh: kWin): each block
# stages a WINDOW x WINDOW window and owns its (WINDOW - 2K)^2 centre.
WINDOW = 64
# Steps per launch of the runners by default: the fastest of the K that
# chip_smoke.py times (4 to 16) at 1024^2 and 2048^2 on one H100 (PERF.md,
# section 6).
K_STEPS = 5
_MAX_Y_TILES = 65535  # the limit of gridDim.y


def unsupported_reason(cfg: SimConfig, k_steps: int = K_STEPS) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can."""
    if cfg.boundary != "nebb":
        return (f"the temporal-block kernel implements the reduced NEBB walls, "
                f"not {cfg.boundary!r}; the one-step kernel takes the "
                f"tangential lid")
    reason = pull.unsupported_reason(cfg)
    if reason is not None:
        return reason
    if cfg.turbulence == "smagorinsky" and cfg.van_driest:
        return ("the temporal-block kernel has no Van Driest Cs^2 plane; "
                "use the one-step kernel")
    if not 1 <= k_steps < WINDOW // 2:
        return (f"k_steps={k_steps} must lie in [1, {WINDOW // 2 - 1}] for the "
                f"{WINDOW}x{WINDOW} window")
    own = WINDOW - 2 * k_steps
    if -(-cfg.ny // own) > _MAX_Y_TILES:
        return f"ny={cfg.ny} needs more than {_MAX_Y_TILES} tiles of {own} rows"
    return None


def _check_cfg(cfg: SimConfig, k_steps: int) -> None:
    cfg.validate()
    reason = unsupported_reason(cfg, k_steps)
    if reason is not None:
        raise ValueError(reason)


def _launch(lib, src: tuple, dst: tuple, scalars: tuple, k_steps: int,
            stream: int) -> None:
    global launches
    err = lib.lbm_tblock_step(*src, *dst, *scalars, k_steps, stream)
    if err != 0:
        raise RuntimeError(
            f"tblock_step launch failed: {lib.lbm_error_string(err).decode()}"
        )
    launches += 1


def tblock_step(cfg: SimConfig, f: torch.Tensor, rho_lid: torch.Tensor,
                f_out: torch.Tensor, rho_lid_out: torch.Tensor,
                k_steps: int = K_STEPS) -> None:
    """Launch the kernel once on the current stream: ``k_steps`` fused steps
    ``(f, rho_lid) -> (f_out, rho_lid_out)``.  Does not synchronise.

    All tensors are contiguous float32 on one CUDA device; the outputs must
    not be the inputs (blocks read their windows' halos while others write).
    """
    _check_cfg(cfg, k_steps)
    device = f.device
    pull._check_state(cfg, f, rho_lid, device)
    pull._check_state(cfg, f_out, rho_lid_out, device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {device}")
    if f_out.data_ptr() == f.data_ptr() or rho_lid_out.data_ptr() == rho_lid.data_ptr():
        raise ValueError("the temporal-block step cannot run in place; give "
                         "it two buffers")
    with torch.cuda.device(device):
        _launch(_build.load_library(), (f.data_ptr(), rho_lid.data_ptr()),
                (f_out.data_ptr(), rho_lid_out.data_ptr()), pull._scalars(cfg),
                k_steps, torch.cuda.current_stream(device).cuda_stream)


def make_block_step(cfg: SimConfig, k_steps: int = K_STEPS, device="cuda"):
    """``k_steps`` fused steps per call ``State -> State``: one launch of
    the kernel for a state on the card, the plain version for a state on
    the CPU.  Each call allocates its output."""
    _check_cfg(cfg, k_steps)
    device = resolve_device(device)
    plain = make_fused_step(cfg)

    def step(state: State) -> State:
        pull._check_state(cfg, state.f, state.rho_lid, device)
        if device.type == "cpu":
            for _ in range(k_steps):
                state = plain(state)
            return state
        out = State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
        tblock_step(cfg, state.f, state.rho_lid, out.f, out.rho_lid, k_steps)
        return out

    return step


def make_scan_runner(cfg: SimConfig, n_steps: int, device="cuda",
                     k_steps: int = K_STEPS):
    """``n_steps`` fused steps per call: ``n_steps // k_steps`` launches of
    this kernel, then ``n_steps % k_steps`` launches of the one-step kernel.
    On the card each call is one replay of the chunk's CUDA graphs, both
    kinds of launch captured in order (``graphs.PingPong``), on the current
    stream and without synchronising: the input is copied into the first of
    two state buffers that the runner holds from its first call on (``2 *
    (9 * nx * ny + nx)`` floats), and the result is copied out of them.  The
    input state is never written, and the returned state owns its tensors.
    On the CPU the plain version step by step."""
    _check_cfg(cfg, k_steps)
    device = resolve_device(device)
    if device.type == "cpu":
        plain = make_fused_step(cfg)

        def run_plain(state: State) -> State:
            pull._check_state(cfg, state.f, state.rho_lid, device)
            for _ in range(n_steps):
                state = plain(state)
            return state

        return run_plain
    scalars = pull._scalars(cfg)

    def launch(one: graphs.Launch, bufs) -> None:
        lib = _build.load_library()
        src, dst = pull._state_ptrs(bufs[one.src]), pull._state_ptrs(bufs[one.dst])
        stream = torch.cuda.current_stream(device).cuda_stream
        if one.block:
            _launch(lib, src, dst, scalars, k_steps, stream)
        else:
            pull._launch(lib, *src, None, *dst, scalars, stream)

    chunk = (graphs.PingPong(device, [(9, cfg.nx, cfg.ny), (cfg.nx,)],
                             graphs.plan(n_steps, k_steps), launch) if n_steps else None)

    def run(state: State) -> State:
        pull._check_state(cfg, state.f, state.rho_lid, device)
        if chunk is None:
            return state
        return State(*chunk(state))

    return run


def _eager_scan_runner(cfg: SimConfig, n_steps: int, device="cuda",
                       k_steps: int = K_STEPS):
    """``make_scan_runner``'s launches on the card issued one by one from
    the host, into two buffers allocated per call: the form its graphs are
    held to (``chip_smoke.py``, the card tests)."""
    _check_cfg(cfg, k_steps)
    device = resolve_device(device)
    n_blocks, rem = divmod(n_steps, k_steps)
    scalars = pull._scalars(cfg)

    def run(state: State) -> State:
        pull._check_state(cfg, state.f, state.rho_lid, device)
        if n_steps == 0:
            return state
        lib = _build.load_library()
        bufs = [State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
                for _ in range(2)]
        ptrs = [(b.f.data_ptr(), b.rho_lid.data_ptr()) for b in bufs]
        src = (state.f.data_ptr(), state.rho_lid.data_ptr())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for i in range(n_blocks + rem):
                dst = ptrs[i % 2]
                if i < n_blocks:
                    _launch(lib, src, dst, scalars, k_steps, stream)
                else:
                    pull._launch(lib, *src, None, *dst, scalars, stream)
                src = dst
        return bufs[(n_blocks + rem - 1) % 2]

    return run
