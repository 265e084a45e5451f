"""The x-ring halo exchange of the sharded temporal-block runner as a
hand-written CUDA kernel that writes each strip straight into the carry that
receives it.

Counterpart of the JAX package's ``kernels/halo_rdma.py``
(``make_x_halo_exchange``), which ``tblock_sharded.make_sharded_runner``
takes with ``halo_impl="rdma"`` in place of the x phase of the exchange.
The kernel is ``csrc/halo_x_exchange.cu``: one launch per device copies
every x strip that the device's shards send (f's 9 planes and the
lid-density panel), from a table of strips fixed once per carry set.  Its
plain version is the x phase of ``parallel.halo.halo_moves`` plus
``parallel.halo.row_halo_moves``, copied in order (``parallel.halo.Transfer``,
which across processes sends and receives over ``torch.distributed``).

A destination may be

(a) a carry on the same card;
(b) a carry on a peer card of the same process: peer access is enabled,
    the writer's stream waits for the destination card's work so far (which
    may still read its halo) and the destination card's next work waits
    for the writer, the ordering the TPU kernel's barrier semaphore buys;
(c) a carry of another process, mapped into this one through CUDA IPC
    (``torch.multiprocessing.reductions``, which carries the caching
    allocator's block offset; the handles travel with ``all_gather_object``).
    The exchange is then host-ordered: synchronise, ``barrier`` (no
    neighbour still reads a halo about to be written), launch, synchronise,
    ``barrier`` (every strip has landed before anyone computes).  Each
    process keeps its carries alive while the exchange lives; ``close``
    unmaps the neighbours' carries, after which the processes meet at a
    barrier, so no carry is freed while another process maps it.

On CUDA devices the exchange launches the kernel or raises; on the CPU it
runs the plain version.  There is no fallback from one to the other.
``launches`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

from ..parallel import halo
from ..parallel.mesh import Blocks, Mesh
from . import _build

launches = 0

Row = Tuple[int, int, int, int, int, int]


def _run(view: torch.Tensor) -> Tuple[int, int, int]:
    """``(planes, plane stride, floats per plane)`` of a strip that is one
    contiguous run per plane (a panel strip is one plane)."""
    if view.dtype != torch.float32:
        raise ValueError(f"the exchange kernel is float32, not {view.dtype}")
    planes, stride, plane = (1, 0, view) if view.dim() == 1 else (
        view.shape[0], view.stride(0), view[0])
    if not plane.is_contiguous():
        raise ValueError("the exchange kernel takes strips that are one contiguous "
                         "run per plane: the tight carry (halo.Layout.tight)")
    return planes, stride, plane.numel()


def strip_rows(pairs: List[halo.Pair]) -> List[Row]:
    """The kernel's table rows for (destination, source) views: source and
    destination addresses, planes, their plane strides, floats per plane."""
    rows = []
    for dst, src in pairs:
        planes, src_stride, count = _run(src)
        dst_planes, dst_stride, dst_count = _run(dst)
        if (planes, count) != (dst_planes, dst_count):
            raise ValueError(f"a strip of {tuple(src.shape)} into one of {tuple(dst.shape)}")
        rows.append((src.data_ptr(), dst.data_ptr(), planes, src_stride, dst_stride, count))
    return rows


def _launch(lib, table: torch.Tensor, rows: List[Row], stream: Optional[int]) -> None:
    global launches
    err = lib.lbm_halo_x_exchange(table.data_ptr(), len(rows), max(r[2] for r in rows),
                                  max(r[5] for r in rows), stream)
    if err != 0:
        raise RuntimeError(
            f"halo_x_exchange launch failed: {lib.lbm_error_string(err).decode()}")
    launches += 1


def x_moves(carries: Blocks, panels: Blocks, layout: halo.Layout) -> List[halo.Move]:
    """What the kernel copies, and its plain version in order: the x phase
    of ``halo.halo_moves`` and the panels' ``halo.row_halo_moves``."""
    return halo.halo_moves(carries, layout)[1] + halo.row_halo_moves(panels, layout.depth)


class XHaloExchange:
    """The x phase of the exchange on one set of carries and panels, with
    its strips, tables and mappings fixed once.  Call it to run the phase;
    ``close`` it when the carries are done with."""

    def __init__(self, mesh: Mesh, carries: Blocks, panels: Blocks,
                 layout: halo.Layout):
        moves = x_moves(carries, panels, layout)
        local = {mesh.device(*s) for s in mesh.local_shards()}
        self._mapped: Dict[tuple, torch.Tensor] = {}
        self._groups = []
        self._plain = None
        if all(d.type == "cpu" for d in local):
            self._plain = halo.Transfer(mesh, moves)
            return
        if any(d.type != "cuda" for d in local):
            raise ValueError(f"the exchange kernel takes CUDA devices, not {local}")
        self._cross = mesh.spans_processes
        self._devices = sorted(local, key=str)
        kinds = {id(carries): ("carry", carries), id(panels): ("panel", panels)}
        if self._cross:
            self._mapped = _map_neighbours(mesh, moves, kinds)
        lib = _build.load_library()
        # per writing device: its (destination, source) views, the cards it
        # writes into, and those of them this process orders by events
        by_device: Dict[torch.device, Tuple[list, set, set]] = {}
        for dst, src in moves:
            if not mesh.is_local(*src.shard):
                continue
            if mesh.is_local(*dst.shard):
                view = dst.view()
            else:
                view = self._mapped[(kinds[id(dst.blocks)][0], dst.shard)][dst.index]
            device = mesh.device(*src.shard)
            pairs, writes, peers = by_device.setdefault(device, ([], set(), set()))
            pairs.append((view, src.view()))
            if view.device != device:
                writes.add(view.device)
                if mesh.is_local(*dst.shard):
                    peers.add(view.device)
        for device, (pairs, writes, peers) in by_device.items():
            for other in writes:
                err = lib.lbm_enable_peer_access(device.index, other.index)
                if err != 0:
                    raise RuntimeError(f"{device} cannot write into {other}: "
                                       f"{lib.lbm_error_string(err).decode()}")
            rows = strip_rows(pairs)
            table = torch.tensor(rows, dtype=torch.int64, device=device)
            self._groups.append((device, table, rows, sorted(peers, key=str)))
        self._lib = lib

    def __call__(self) -> None:
        if self._plain is not None:
            self._plain()
            return
        if self._cross:
            self._synchronize()
            dist.barrier()
        for device, table, rows, peers in self._groups:
            stream = torch.cuda.current_stream(device)
            for peer in peers:   # the peer's work so far, which may read its halo
                stream.wait_event(torch.cuda.current_stream(peer).record_event())
            with torch.cuda.device(device):
                _launch(self._lib, table, rows, stream.cuda_stream)
            written = stream.record_event() if peers else None
            for peer in peers:   # the peer's next work reads what landed
                torch.cuda.current_stream(peer).wait_event(written)
        if self._cross:
            self._synchronize()
            dist.barrier()

    def _synchronize(self) -> None:
        for device in self._devices:
            torch.cuda.synchronize(device)

    def close(self) -> None:
        """Unmap the other processes' carries, and meet them at a barrier so
        that none frees a carry another still maps."""
        if self._mapped:
            self._mapped.clear()
            self._synchronize()
        if self._plain is None and self._cross:
            dist.barrier()


def ipc_plan(mesh: Mesh, moves, kinds) -> Tuple[Dict[int, List[tuple]], Dict[tuple, int]]:
    """Which tensors of this process each other process writes strips into
    (``{writer rank: [(kind, shard), ...]}``, the offers), and on which
    card this process opens each tensor of another process that it writes
    into (``{(kind, shard): card index}``).  ``kinds`` maps ``id`` of the
    carries and of the panels to ``(kind, blocks)``.

    A handle opens once per process (torch caches the mapping by handle),
    so a process whose shards on two cards write into one carry of another
    process cannot have it mapped for both: such a layout raises
    ``ValueError``, on every rank alike, before any handle moves."""
    offers: Dict[int, List[tuple]] = {}
    cards: Dict[tuple, set] = {}
    for dst, src in moves:
        key = (kinds[id(dst.blocks)][0], dst.shard)
        writer = mesh.owner(*src.shard)
        if writer == mesh.owner(*dst.shard):
            continue
        cards.setdefault((writer, key), set()).add(mesh.device(*src.shard).index)
        if mesh.is_local(*dst.shard) and key not in offers.setdefault(writer, []):
            offers[writer].append(key)
    for (writer, key), writing in cards.items():
        if len(writing) > 1:
            raise ValueError(
                f"the exchange kernel maps the {key[0]} of shard {key[1]} once into "
                f"rank {writer}, but that rank writes into it from cards "
                f"{sorted(writing)}: place the x neighbours of a shard of another "
                "process on one card of the rank (make_pod_mesh's devices_per_rank)")
    return offers, {key: next(iter(writing)) for (writer, key), writing in cards.items()
                    if writer == mesh.rank}


def _map_neighbours(mesh: Mesh, moves, kinds) -> Dict[tuple, torch.Tensor]:
    """The carries and panels of other processes that this one writes
    into, mapped into it through CUDA IPC as ``ipc_plan`` lays out: each
    process offers the tensors it receives strips into, once to each
    process that writes them, and opens the ones offered to it on the card
    that writes them (CUDA maps an IPC handle into the address space of the
    card it is opened on, with peer access to the card that holds the
    memory).  The mapped tensors name that writing card as their device."""
    if "expandable_segments:True" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""):
        raise ValueError("CUDA IPC of the carries needs the default caching allocator, "
                         "not expandable_segments")
    plan, writing_card = ipc_plan(mesh, moves, kinds)
    blocks = dict(kinds.values())
    offers = {writer: {(kind, (ix, iy)): reduce_tensor(blocks[kind][ix][iy])[1]
                       for kind, (ix, iy) in keys}
              for writer, keys in plan.items()}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, offers)
    mapped = {}
    for offered in gathered:
        for key, args in offered.get(mesh.rank, {}).items():
            args = list(args)
            args[6] = writing_card[key]    # rebuild_cuda_tensor's storage_device
            mapped[key] = rebuild_cuda_tensor(*args)
    return mapped


def make_x_halo_exchange(mesh: Mesh, carries: Blocks, panels: Blocks,
                         layout: halo.Layout) -> XHaloExchange:
    """The x phase of the exchange on ``carries`` (of the tight ``layout``,
    K = ``layout.depth`` deep) and their ``(lx + 2K,)`` lid-density
    ``panels``, fixed for this set of buffers: a runner with two buffers
    makes one for each.  On a mesh that spans processes every process makes
    it at once (the IPC handles are exchanged here)."""
    return XHaloExchange(mesh, carries, panels, layout)
