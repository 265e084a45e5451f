"""The fused pull step of one shard as a hand-written CUDA kernel, and the
sharded runner over a mesh that launches it.

Counterpart of the JAX package's ``kernels/pallas_pull_sharded.py``
(``make_sharded_pallas_runner``): the same ``ShardedState`` contract as the
plain sharded engine (``parallel/halo.py``).  The kernel is
``csrc/pull_sharded_step.cu``; its plain version is
``parallel.halo.local_step`` on the same padded carry.

Each shard carries its block inside a one-cell halo ring, in two buffers
per shard of the layout ``layout(lx, ly)``: ``(9, lx + 2, pitch)``, the
cells' rows starting on a 128-byte line (``parallel.halo.Layout.aligned``).
A step is the halo refresh and one launch per shard, which reads one
buffer and writes the other's cells.  On a mesh of one process whose shards
are CUDA devices the refresh is one launch per card of the exchange kernel
(``kernels/halo_rdma.make_halo_exchange``: y and x strips and corners,
written straight into the receiving carries); elsewhere it is the two-phase
exchange of strip copies (``parallel.halo.halo_moves``, four per shard),
and on a mesh that spans processes (``parallel.multihost``) the strips
between processes travel over ``torch.distributed``
(``parallel.halo.Transfer``), one phase at a time: a host-ordered IPC
exchange every step would cost more than the sends.  On a mesh whose
shards all lie on one card the runner replays its chunk as CUDA graphs
(``kernels/graphs.py``); elsewhere, and in ``_eager_sharded_runner``, the
form the graphs are held to, the host issues every step.  A shard on a
CUDA device launches the kernel or raises; a shard on the CPU runs the
plain version (what the CPU tests exercise).  There is no fallback from
one to the other.

``launches`` counts the kernel's launches in this process; the exchange
kernel's launches count in ``halo_rdma.launches``, the copies of the
exchange in ``parallel.halo.copies``, its strips sent to other processes in
``parallel.halo.sends``.
"""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig
from ..parallel import halo
from ..parallel.mesh import Mesh, local_blocks
from . import _build, graphs, halo_rdma, pull

launches = 0


def unsupported_reason(cfg: SimConfig) -> str | None:
    """Why the kernel cannot run this configuration, or None if it can."""
    if cfg.precision != "float32":
        return "the CUDA kernel is float32; use the plain sharded engine for float64"
    if cfg.boundary != "nebb":
        return (f"the CUDA kernel implements the reduced NEBB walls, not "
                f"{cfg.boundary!r}")
    mx, my = cfg.mesh_shape
    if cfg.nx % mx or cfg.ny % my:
        return f"grid {cfg.nx}x{cfg.ny} must divide the mesh shape {cfg.mesh_shape}"
    return None


def _check_cfg(cfg: SimConfig) -> None:
    cfg.validate()
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)


def layout(lx: int, ly: int) -> halo.Layout:
    """The kernel's carry of an ``(lx, ly)`` shard."""
    return halo.Layout.aligned(lx, ly, 1)


def _shard_call(cfg: SimConfig, lay: halo.Layout, fp: torch.Tensor,
                rho_lid: torch.Tensor, flags, cs2: torch.Tensor | None,
                fp_out: torch.Tensor, rho_lid_out: torch.Tensor):
    """Check one shard's step and return it as a call with its arguments
    fixed: the launch on a CUDA device (on the device's current stream at
    the call), the plain version on the CPU."""
    device = fp.device
    lx, ly = lay.lx, lay.ly
    if lay.depth != 1:
        raise ValueError(f"the one-step kernel takes a one-cell halo, not {lay.depth}")
    for name, t, shape in (("fp", fp, (9, lx + 2, lay.pitch)),
                           ("fp_out", fp_out, (9, lx + 2, lay.pitch)),
                           ("rho_lid", rho_lid, (lx,)),
                           ("rho_lid_out", rho_lid_out, (lx,))):
        pull._check_tensor(name, t, shape, device)
    if fp_out.data_ptr() == fp.data_ptr() or rho_lid_out.data_ptr() == rho_lid.data_ptr():
        raise ValueError("the pull step cannot run in place; give it two buffers")
    if (cfg.turbulence == "smagorinsky" and cfg.van_driest) != (cs2 is not None):
        raise ValueError("cs2 is required for, and only for, Van Driest damping")
    if cs2 is not None:
        pull._check_tensor("cs2", cs2, (lx, ly), device)
    if device.type == "cpu":
        return functools.partial(_plain, cfg, lay, fp, rho_lid, flags, cs2, fp_out,
                                 rho_lid_out)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {device}")
    return functools.partial(
        on_current_stream, _launch, device, _build.load_library(), fp.data_ptr(),
        rho_lid.data_ptr(), None if cs2 is None else cs2.data_ptr(), fp_out.data_ptr(),
        rho_lid_out.data_ptr(), lay, flags, pull._scalars(cfg)[2:])


def on_current_stream(launch, device: torch.device, *args) -> None:
    """``launch(*args, stream)`` on ``device``'s current stream at the call:
    inside a CUDA graph's capture, the capturing stream."""
    launch(*args, torch.cuda.current_stream(device).cuda_stream)


def _plain(cfg, lay, fp, rho_lid, flags, cs2, fp_out, rho_lid_out) -> None:
    f_new, rho_row = halo.local_step(cfg, lay.padded(fp), rho_lid, flags, cs2)
    lay.cells(fp_out).copy_(f_new)
    if flags[2]:
        rho_lid_out.copy_(rho_row)


def shard_step(cfg: SimConfig, lay: halo.Layout, fp: torch.Tensor,
               rho_lid: torch.Tensor, flags, cs2: torch.Tensor | None,
               fp_out: torch.Tensor, rho_lid_out: torch.Tensor) -> None:
    """One step of one shard: the carry ``fp`` of layout ``lay`` (a
    one-cell ring, ``layout(lx, ly)`` in the runner) with its halo ring
    filled and the shard's ``(lx,)`` lid density -> the cells of ``fp_out``
    and, where the shard owns the lid (``flags[2]``), ``rho_lid_out``.
    ``flags`` = (left, right, lid, bottom) walls owned.  On the card one
    launch on the current stream, not synchronised; on the CPU the plain
    version."""
    run_calls([(fp.device, _shard_call(cfg, lay, fp, rho_lid, flags, cs2, fp_out,
                                       rho_lid_out))])


def run_calls(calls) -> None:
    """Run ``(device, call)`` pairs in order, each CUDA one with its device
    current."""
    for device, call in calls:
        if device.type == "cuda":
            with torch.cuda.device(device):
                call()
        else:
            call()


def _launch(lib, f_ptr: int, rho_ptr: int, cs2_ptr: int | None, f_out_ptr: int,
            rho_out_ptr: int, lay: halo.Layout, flags, scalars: tuple,
            stream: int) -> None:
    global launches
    err = lib.lbm_pull_sharded_step(f_ptr, rho_ptr, cs2_ptr, f_out_ptr,
                                    rho_out_ptr, lay.lx, lay.ly, lay.pitch, lay.y0,
                                    *map(int, flags), *scalars, stream)
    if err != 0:
        raise RuntimeError(
            f"pull_sharded_step launch failed: {lib.lbm_error_string(err).decode()}"
        )
    launches += 1


def _exchange(mesh: Mesh, carries, lay: halo.Layout):
    """The refresh of ``carries``' one-cell halo as one call: the exchange
    kernel on a mesh of one process on CUDA devices, else the two phases of
    strip copies (and sends across processes)."""
    if mesh.on_cuda and not mesh.spans_processes:
        return halo_rdma.make_halo_exchange(mesh, carries, None, lay)
    return halo.transfers(mesh, halo.refresh_phases(carries, None, lay))


def make_sharded_runner(cfg: SimConfig, n_steps: int, mesh: Mesh):
    """``n_steps`` sharded steps per call on a ``ShardedState``: per step the
    halo refresh, then one launch per shard of this process.  The input is
    never written, and the returned blocks are new.

    On a mesh of one process whose shards all lie on one card
    (``graphs.one_card``) a call is one replay of the chunk's CUDA graphs,
    each step's exchange launch and shard launches captured.  The runner
    holds two sets of carries and lid rows from its first call on (``2 *
    shards * (9 * (lx + 2) * pitch + lx)`` floats) and the exchanges over
    them.  Outside the replay a call copies the blocks and lid densities
    into the first set, and after it the lid density of the ``iy = 0``
    shards over their columns and the blocks and lid densities out
    (``halo.copies`` counts these copies, as every other).  On the CPU and
    on a mesh that spans several cards or processes, whose streams are
    ordered by events across cards and by host barriers across processes,
    the host issues every step (``_eager_sharded_runner``); on a mesh that
    spans processes every process calls it at once, with its own blocks."""
    _check_cfg(cfg)
    card = graphs.one_card([mesh.device(*s) for s in mesh.local_shards()],
                           mesh.spans_processes)
    if card is None:
        return _eager_sharded_runner(cfg, n_steps, mesh)
    lay = layout(*halo.check_mesh(cfg, mesh))
    cs2 = halo.cs2_blocks(cfg, mesh, torch.float32)

    def build(alloc):
        carries = [local_blocks(mesh, lambda ix, iy: alloc((9, lay.lx + 2, lay.pitch)))
                   for _ in range(2)]
        rows = [local_blocks(mesh, lambda ix, iy: alloc((lay.lx,))) for _ in range(2)]
        exchange = [_exchange(mesh, c, lay) for c in carries]
        steps = [[(mesh.device(ix, iy), _shard_call(
            cfg, lay, carries[src][ix][iy], rows[src][ix][iy],
            halo.edge_flags(mesh.shape, ix, iy), None if cs2 is None else cs2[ix][iy],
            carries[1 - src][ix][iy], rows[1 - src][ix][iy])) for ix, iy in mesh.local_shards()]
            for src in (0, 1)]

        def launch(one: graphs.Launch) -> None:
            exchange[one.src]()
            run_calls(steps[one.src])

        return (carries, rows, exchange), launch

    chunk = graphs.Chunk(card, graphs.plan(n_steps), build) if n_steps else None

    def run(state: halo.ShardedState) -> halo.ShardedState:
        halo.check_sharded_state(cfg, state, mesh)
        if chunk is None:
            return state
        carries, rows, _ = chunk.buffers
        halo.copy_into(carries[0], state.f, lay.cells)
        halo.copy_into(rows[0], state.rho_lid)
        chunk.replay()
        out = chunk.plan.result
        halo.Transfer(mesh, halo.replicate_moves(rows[out]))()
        return halo.ShardedState(halo.unpad_blocks(carries[out], lay),
                                 halo.unpad_rows(rows[out], 0))

    return run


def _eager_sharded_runner(cfg: SimConfig, n_steps: int, mesh: Mesh):
    """``make_sharded_runner``'s steps issued one by one from the host: the
    runner on the CPU and on a mesh of several cards or processes, and the
    form its graphs are held to on one card.  Each call pads its input into
    fresh buffers, fixes the views of the exchange and the arguments of the
    launches for both buffers once, and returns new blocks."""
    _check_cfg(cfg)
    lay = layout(*halo.check_mesh(cfg, mesh))
    cs2 = halo.cs2_blocks(cfg, mesh, torch.float32)

    def run(state: halo.ShardedState) -> halo.ShardedState:
        halo.check_sharded_state(cfg, state, mesh)
        if n_steps == 0:
            return state
        carries = [halo.pad_blocks(state.f, lay)]
        carries.append(halo.empty_blocks(carries[0]))
        rows = [halo.pad_rows(state.rho_lid, 0)]
        rows.append(halo.empty_blocks(rows[0]))
        exchange, steps = [], []
        for src in (0, 1):
            dst = 1 - src
            exchange.append(_exchange(mesh, carries[src], lay))
            steps.append([(mesh.device(ix, iy), _shard_call(
                cfg, lay, carries[src][ix][iy], rows[src][ix][iy],
                halo.edge_flags(mesh.shape, ix, iy), None if cs2 is None else cs2[ix][iy],
                carries[dst][ix][iy], rows[dst][ix][iy])) for ix, iy in mesh.local_shards()])
        for i in range(n_steps):
            exchange[i % 2]()
            run_calls(steps[i % 2])
        out = n_steps % 2
        halo.Transfer(mesh, halo.replicate_moves(rows[out]))()
        return halo.ShardedState(halo.unpad_blocks(carries[out], lay), rows[out])

    return run
