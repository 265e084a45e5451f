"""K fused pull steps per launch on each shard (temporal blocking) as a
hand-written CUDA kernel, and the sharded runner over a mesh that launches
it.

Counterpart of the JAX package's ``kernels/pallas_pull_tblock_sharded.py``
(``make_sharded_tblock_runner``): the same ``ShardedState`` contract as the
plain sharded engine (``parallel/halo.py``).  The kernel is
``csrc/tblock_sharded_step.cu``; its plain version is ``plain_block``: K
steps of ``parallel.halo.masked_step`` on the shard's K-deep padded carry,
with the exchange done once and the walls keyed to the global cell, so the
ring keeps the shard's own cells exact for K steps.

Each shard carries its block padded with a K-deep halo ring,
``(9, lx + 2K, ly + 2K)``, and its lid density as an ``(lx + 2K,)`` panel,
in two buffers each.  Every K steps the halo is refreshed and each shard
launches the kernel once.  The refresh (``parallel.halo.refresh_phases``)
fills each ring from the neighbours and each panel's x halo, and copies the
panel of the shard that owns the lid over the rest of its column.  Under
``halo_impl="ppermute"`` (the JAX runner's default) it is strip copies in
phases; under ``halo_impl="rdma"`` one launch per card of the exchange
kernel (``kernels/halo_rdma.py``), which writes every rectangle straight
into the receiving carries.  A last copy of the panels over their columns
after the final block keeps every ``iy``'s lid density the same.  On a
mesh that spans processes (``parallel.multihost``) each process runs its
own shards and the strips between processes travel over
``torch.distributed`` (or, under ``"rdma"``, through carries mapped by CUDA
IPC).  A runner's ``n mod K`` remaining steps go through the one-step
sharded kernel (``kernels/pull_sharded.py``), as the JAX runner's go
through its per-step sharded kernel.

On a mesh whose shards all lie on one card the runner replays its blocks
as CUDA graphs (``kernels/graphs.py``), and its remainder runner its
steps; elsewhere, and in ``_eager_sharded_runner``, the form the graphs are
held to, the host issues every block.  A shard on a CUDA device launches
the kernel or raises; on the CPU it runs the plain version (what the CPU
tests exercise).  There is no fallback from one to the other.
``launches`` counts this kernel's launches (the remainder steps count in
``pull_sharded.launches``, the copies in ``parallel.halo.copies``, the
exchange kernel's launches in ``halo_rdma.launches``).
"""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig
from ..parallel import halo
from ..parallel.mesh import Mesh, block_shape, local_blocks
from . import _build, graphs, halo_rdma, pull, pull_sharded, tblock

launches = 0

# The transports of the x phase, with the JAX runner's names.
HALO_IMPLS = ("ppermute", "rdma")

WINDOW = tblock.WINDOW
# Steps per launch by default: the single-device kernel's (tblock.K_STEPS).
K_STEPS = tblock.K_STEPS
_MAX_Y_TILES = 65535  # the limit of gridDim.y


def unsupported_reason(cfg: SimConfig, k_steps: int = K_STEPS) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can."""
    reason = pull_sharded.unsupported_reason(cfg)
    if reason is not None:
        return reason
    if cfg.turbulence == "smagorinsky" and cfg.van_driest:
        return ("the sharded temporal-block kernel has no Van Driest Cs^2 "
                "plane; use the one-step sharded kernel")
    if not 1 <= k_steps < WINDOW // 2:
        return (f"k_steps={k_steps} must lie in [1, {WINDOW // 2 - 1}] for the "
                f"{WINDOW}x{WINDOW} window")
    lx, ly = block_shape(cfg.nx, cfg.ny, cfg.mesh_shape)
    if lx < k_steps or ly < k_steps:
        return (f"the shard {lx}x{ly} is narrower than the K={k_steps} halo; "
                "lower k_steps")
    if -(-ly // (WINDOW - 2 * k_steps)) > _MAX_Y_TILES:
        return f"ly={ly} needs more than {_MAX_Y_TILES} tiles"
    return None


def _check_cfg(cfg: SimConfig, k_steps: int) -> None:
    cfg.validate()
    reason = unsupported_reason(cfg, k_steps)
    if reason is not None:
        raise ValueError(reason)


def plain_block(cfg: SimConfig, fp: torch.Tensor, panel: torch.Tensor,
                origin: tuple, k_steps: int):
    """The plain version of the kernel: ``k_steps`` fused steps of the whole
    carry ``fp (9, lx + 2K, ly + 2K)`` (its ring filled by the exchange),
    each computing every cell but the outermost ring from the step before,
    with the walls and the lid density keyed to each cell's global cell
    (``origin`` = global coordinate of the shard's first cell).  Staleness
    creeps in one cell per step from the ring, so the shard's own cells are
    exact after K steps.  Returns the carry and the per-cell lid density
    ``(lx + 2K, ly + 2K)`` after K steps."""
    px, py = fp.shape[1], fp.shape[2]
    dev = fp.device
    gx = (origin[0] - k_steps + torch.arange(px, device=dev)) % cfg.nx
    gy = (origin[1] - k_steps + torch.arange(py, device=dev)) % cfg.ny
    m = halo.WallMasks(left=gx[1:-1] == 0, right=gx[1:-1] == cfg.nx - 1,
                       bottom=gy[1:-1] == cfg.ny - 1, lid=gy[1:-1] == 0)
    rl = panel[:, None].expand(px, py).clone()
    for _ in range(k_steps):
        f_new, rho = halo.masked_step(cfg, fp, rl[1:-1, 1:-1], m)
        fp = fp.clone()
        fp[:, 1:-1, 1:-1] = f_new
        rl = rl.clone()
        rl[1:-1, 1:-1] = torch.where(m.lid[None, :], rho, rl[1:-1, 1:-1])
    return fp, rl


def _block_call(cfg: SimConfig, fp: torch.Tensor, panel: torch.Tensor,
                origin: tuple, fp_out: torch.Tensor, panel_out: torch.Tensor,
                k_steps: int):
    """Check one shard's block and return it as a call with its arguments
    fixed: the launch on a CUDA device (on the device's current stream at
    the call), the plain version on the CPU."""
    _check_cfg(cfg, k_steps)
    device = fp.device
    k = k_steps
    lx, ly = fp.shape[1] - 2 * k, fp.shape[2] - 2 * k
    for name, t, shape in (("fp", fp, (9, lx + 2 * k, ly + 2 * k)),
                           ("fp_out", fp_out, (9, lx + 2 * k, ly + 2 * k)),
                           ("panel", panel, (lx + 2 * k,)),
                           ("panel_out", panel_out, (lx + 2 * k,))):
        pull._check_tensor(name, t, shape, device)
    if fp_out.data_ptr() == fp.data_ptr() or panel_out.data_ptr() == panel.data_ptr():
        raise ValueError("the temporal-block step cannot run in place; give "
                         "it two buffers")
    if device.type == "cpu":
        return functools.partial(_plain, cfg, fp, panel, origin, fp_out, panel_out, k)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {device}")
    return functools.partial(
        pull_sharded.on_current_stream, _launch, device, _build.load_library(),
        fp.data_ptr(), panel.data_ptr(), fp_out.data_ptr(), panel_out.data_ptr(), lx, ly,
        origin, pull._scalars(cfg), k)


def _plain(cfg, fp, panel, origin, fp_out, panel_out, k) -> None:
    f_new, rl = plain_block(cfg, fp, panel, origin, k)
    fp_out[:, k:-k, k:-k] = f_new[:, k:-k, k:-k]
    if origin[1] == 0:
        panel_out[k:-k] = rl[k:-k, k]


def block_step(cfg: SimConfig, fp: torch.Tensor, panel: torch.Tensor,
               origin: tuple, fp_out: torch.Tensor, panel_out: torch.Tensor,
               k_steps: int = K_STEPS) -> None:
    """``k_steps`` steps of one shard: the carry ``fp (9, lx + 2K, ly + 2K)``
    and the panel ``(lx + 2K,)``, their rings filled -> the shard's cells of
    ``fp_out`` and, where the shard owns the lid, of ``panel_out``.
    ``origin`` is the global coordinate of the shard's first cell.  On the
    card one launch on the current stream, not synchronised; on the CPU the
    plain version."""
    pull_sharded.run_calls([(fp.device, _block_call(cfg, fp, panel, origin, fp_out,
                                                    panel_out, k_steps))])


def _launch(lib, f_ptr: int, panel_ptr: int, f_out_ptr: int, panel_out_ptr: int,
            lx: int, ly: int, origin: tuple, scalars: tuple, k_steps: int,
            stream: int) -> None:
    global launches
    err = lib.lbm_tblock_sharded_step(f_ptr, panel_ptr, f_out_ptr, panel_out_ptr,
                                      lx, ly, *origin, *scalars, k_steps, stream)
    if err != 0:
        raise RuntimeError(
            f"tblock_sharded_step launch failed: {lib.lbm_error_string(err).decode()}"
        )
    launches += 1


def _check_halo_impl(halo_impl: str) -> None:
    if halo_impl not in HALO_IMPLS:
        raise ValueError(f"unknown halo_impl {halo_impl!r}; one of {HALO_IMPLS}")


def make_sharded_runner(cfg: SimConfig, n_steps: int, mesh: Mesh,
                        k_steps: int = K_STEPS, halo_impl: str = "ppermute"):
    """``n_steps`` sharded steps per call on a ``ShardedState``:
    ``n_steps // k_steps`` blocks of one exchange and one launch per shard
    of this process, then ``n_steps % k_steps`` steps of the one-step
    sharded kernel (``pull_sharded.make_sharded_runner``).  ``halo_impl``
    is the refresh's transport (one of ``HALO_IMPLS``): strip copies phase
    after phase, or one exchange launch per card.  The input is never
    written, and the returned blocks are new.

    On a mesh of one process whose shards all lie on one card
    (``graphs.one_card``) the blocks of a call are one replay of CUDA
    graphs, each block's refresh (its copies or its exchange launch) and
    shard launches captured, and the remainder steps one replay of the
    one-step runner's.  The runner holds two sets of K-deep carries and lid
    panels from its first call on (``2 * shards * (9 * (lx + 2K) * (ly +
    2K) + lx + 2K)`` floats), the refreshes over them, and the one-step
    runner's buffers.  Outside the replay a call copies the blocks and lid
    densities into the first set, and after it the panels of the ``iy = 0``
    shards over their columns and the blocks and lid densities out.  On
    the CPU and on a mesh that spans several cards or processes the host
    issues every block (``_eager_sharded_runner``); on a mesh that spans
    processes every process calls it at once, with its own blocks."""
    _check_halo_impl(halo_impl)
    _check_cfg(cfg, k_steps)
    card = graphs.one_card([mesh.device(*s) for s in mesh.local_shards()],
                           mesh.spans_processes)
    if card is None:
        return _eager_sharded_runner(cfg, n_steps, mesh, k_steps, halo_impl)
    lx, ly = halo.check_mesh(cfg, mesh)
    n_blocks, rem = divmod(n_steps, k_steps)
    single = pull_sharded.make_sharded_runner(cfg, rem, mesh) if rem else None
    k = k_steps
    lay = halo.Layout.tight(lx, ly, k)

    def build(alloc):
        carries = [local_blocks(mesh, lambda ix, iy: alloc((9, lx + 2 * k, ly + 2 * k)))
                   for _ in range(2)]
        panels = [local_blocks(mesh, lambda ix, iy: alloc((lx + 2 * k,))) for _ in range(2)]
        # the refresh: y, x, corners, the panels' x halos and their copy
        # over each column
        if halo_impl == "rdma":
            exchange = [halo_rdma.make_halo_exchange(mesh, carries[src], panels[src], lay)
                        for src in (0, 1)]
        else:
            exchange = [halo.transfers(mesh, halo.refresh_phases(carries[src], panels[src],
                                                                 lay)) for src in (0, 1)]
        blocks = [[(mesh.device(ix, iy), _block_call(
            cfg, carries[src][ix][iy], panels[src][ix][iy], (ix * lx, iy * ly),
            carries[1 - src][ix][iy], panels[1 - src][ix][iy], k))
            for ix, iy in mesh.local_shards()] for src in (0, 1)]

        def launch(one: graphs.Launch) -> None:
            exchange[one.src]()
            pull_sharded.run_calls(blocks[one.src])

        return (carries, panels, exchange), launch

    chunk = graphs.Chunk(card, graphs.plan(n_blocks), build) if n_blocks else None

    def run(state: halo.ShardedState) -> halo.ShardedState:
        halo.check_sharded_state(cfg, state, mesh)
        if chunk is not None:
            carries, panels, _ = chunk.buffers
            halo.copy_into(carries[0], state.f, lay.cells)
            halo.copy_into(panels[0], state.rho_lid, lambda p: p[k:k + lx])
            chunk.replay()
            out = chunk.plan.result
            # the launches write the lid density of the iy = 0 shards: copy
            # it over the columns, as every refresh does before a block
            halo.Transfer(mesh, halo.replicate_moves(panels[out]))()
            state = halo.ShardedState(halo.unpad_blocks(carries[out], lay),
                                      halo.unpad_rows(panels[out], k))
        if single is not None:
            state = single(state)
        return state

    return run


def _eager_sharded_runner(cfg: SimConfig, n_steps: int, mesh: Mesh,
                          k_steps: int = K_STEPS, halo_impl: str = "ppermute"):
    """``make_sharded_runner``'s blocks issued one by one from the host, its
    remainder through ``pull_sharded._eager_sharded_runner``: the runner on
    the CPU and on a mesh of several cards or processes, and the form its
    graphs are held to on one card.  Each call pads its input into fresh
    buffers, fixes the exchange and the arguments of the launches for both
    buffers once, and returns new blocks."""
    _check_halo_impl(halo_impl)
    _check_cfg(cfg, k_steps)
    lx, ly = halo.check_mesh(cfg, mesh)
    n_blocks, rem = divmod(n_steps, k_steps)
    single = pull_sharded._eager_sharded_runner(cfg, rem, mesh) if rem else None
    k = k_steps
    lay = halo.Layout.tight(lx, ly, k)

    def run(state: halo.ShardedState) -> halo.ShardedState:
        halo.check_sharded_state(cfg, state, mesh)
        if n_blocks:
            carries = [halo.pad_blocks(state.f, lay)]
            carries.append(halo.empty_blocks(carries[0]))
            panels = [halo.pad_rows(state.rho_lid, k)]
            panels.append(halo.empty_blocks(panels[0]))
            exchange, blocks, kernels = [], [], []
            try:
                for src in (0, 1):
                    dst = 1 - src
                    # the refresh: y, x, corners, the panels' x halos and
                    # their copy over each column
                    if halo_impl == "rdma":
                        kernels.append(halo_rdma.make_halo_exchange(
                            mesh, carries[src], panels[src], lay))
                        exchange.append(kernels[-1])
                    else:
                        exchange.append(halo.transfers(
                            mesh, halo.refresh_phases(carries[src], panels[src], lay)))
                    blocks.append([(mesh.device(ix, iy), _block_call(
                        cfg, carries[src][ix][iy], panels[src][ix][iy], (ix * lx, iy * ly),
                        carries[dst][ix][iy], panels[dst][ix][iy], k))
                        for ix, iy in mesh.local_shards()])
                for i in range(n_blocks):
                    exchange[i % 2]()
                    pull_sharded.run_calls(blocks[i % 2])
            finally:
                for kernel in kernels:
                    kernel.close()
            out = n_blocks % 2
            # the launches write the lid density of the iy = 0 shards: copy
            # it over the columns, as every refresh does before a block
            halo.Transfer(mesh, halo.replicate_moves(panels[out]))()
            state = halo.ShardedState(halo.unpad_blocks(carries[out], lay),
                                      halo.unpad_rows(panels[out], k))
        if single is not None:
            state = single(state)
        return state

    return run
