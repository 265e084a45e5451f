"""The halo refresh of the sharded runners as a hand-written CUDA kernel that
writes each rectangle straight into the carry that receives it.

Counterpart of the JAX package's ``kernels/halo_rdma.py``
(``make_x_halo_exchange``).  The kernel is ``csrc/halo_exchange.cu``: one
launch per card copies every rectangle that the card's shards send, from a
table fixed once per carry set.

* ``make_halo_exchange`` refreshes a mesh's whole halo: y strips, x strips,
  corners and, with lid-density panels, each panel's x halo and its copy
  over the column (``parallel.halo.refresh_moves``).  Its plain version is
  ``parallel.halo.refresh_phases`` copied phase after phase
  (``parallel.halo.Transfer``, which across processes sends and receives
  over ``torch.distributed``).  Both sharded runners take it on CUDA
  devices: ``tblock_sharded`` under ``halo_impl="rdma"``, ``pull_sharded``
  on a mesh of one process.
* ``make_x_halo_exchange`` keeps the JAX function's x-only contract (the x
  phase of the exchange and the panels' x halos, ``x_moves``) over the same
  kernel.

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
    ``barrier`` (every rectangle has landed before anyone computes).  Each
    process keeps its carries alive while the exchange lives; ``close``
    unmaps the neighbours' carries, after which the processes meet at a
    barrier, so no carry is freed while another process maps it.

The table and the launch arguments are fixed when the exchange is made,
so a call on one card is one ``ctypes`` call, on the card's current stream
at the call: inside a CUDA graph's capture (a mesh of one card, whose
runners replay their chunks, ``kernels/graphs.py``) that is the capturing
stream.  On CUDA devices the exchange launches the kernel or raises; on the
CPU it runs the plain version.  There is no fallback from one to the other.
``launches`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

from ..parallel import halo
from ..parallel.mesh import Blocks, Mesh
from . import _build

launches = 0

# A table row: source and destination addresses, planes, rows, floats per
# row, source plane and row strides, destination plane and row strides,
# whether the two share their 16-byte phase on every row, slots per row and
# the first slot (csrc/halo_exchange.cu).
Row = Tuple[int, ...]
# Rows at least this many floats long go by 16-byte lines where both sides
# keep one phase; shorter ones (y strips, corners) one float a slot, so that
# a warp's lanes take neighbouring floats of neighbouring rows.
VECTOR_MIN = 32
_MAX_SLOTS = 2**31 - 1
_MAX_RECTS = 227 * 1024 // (12 * 8)   # the table in a block's shared memory


def _rect(view: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """``(planes, rows, floats per row, plane stride, row stride)`` of a view
    whose last axis is contiguous (a panel strip is one row)."""
    if view.dtype != torch.float32:
        raise ValueError(f"the exchange kernel is float32, not {view.dtype}")
    if not 1 <= view.dim() <= 3 or view.stride(-1) != 1:
        raise ValueError("the exchange kernel takes rectangles of up to 3 axes "
                         f"whose last axis is contiguous, not {tuple(view.shape)} "
                         f"with strides {view.stride()}")
    shape = (1,) * (3 - view.dim()) + tuple(view.shape)
    strides = (0,) * (3 - view.dim()) + view.stride()
    return (*shape, strides[0], strides[1])


def rect_rows(pairs: List[halo.Pair]) -> List[Row]:
    """The kernel's table rows for (destination, source) views, with each
    rectangle's first slot in the launch's flat index."""
    rows, first = [], 0
    for dst, src in pairs:
        planes, nrows, count, src_plane, src_row = _rect(src)
        d_planes, d_rows, d_count, dst_plane, dst_row = _rect(dst)
        if (planes, nrows, count) != (d_planes, d_rows, d_count):
            raise ValueError(f"a rectangle of {tuple(src.shape)} into one of "
                             f"{tuple(dst.shape)}")
        if nrows == 1 or src_row == dst_row == count:
            # rows that follow each other on both sides: one run per plane
            nrows, count, src_row, dst_row = 1, nrows * count, 0, 0
        if planes * nrows * count == 0:
            continue
        src_at, dst_at = src.data_ptr(), dst.data_ptr()
        vector = (count >= VECTOR_MIN and (src_at - dst_at) % 16 == 0
                  and (planes == 1 or (src_plane - dst_plane) % 4 == 0)
                  and (nrows == 1 or (src_row - dst_row) % 4 == 0))
        slots = (count + 6) // 4 if vector else count
        rows.append((src_at, dst_at, planes, nrows, count, src_plane, src_row,
                     dst_plane, dst_row, int(vector), slots, first))
        first += planes * nrows * slots
    if first > _MAX_SLOTS or len(rows) > _MAX_RECTS:
        raise ValueError(f"{len(rows)} rectangles of {first} slots exceed the exchange "
                         f"kernel's {_MAX_RECTS} rectangles or {_MAX_SLOTS} slots")
    return rows


def n_slots(rows: List[Row]) -> int:
    """The slots of a table: the flat index the launch covers."""
    last = rows[-1]
    return last[11] + last[2] * last[3] * last[10]


def _launch(lib, table_ptr: int, n_rects: int, slots: int, device: int, sms: int,
            stream: Optional[int]) -> None:
    global launches
    err = lib.lbm_halo_exchange(table_ptr, n_rects, slots, device, sms, stream)
    if err != 0:
        raise RuntimeError(
            f"halo_exchange launch failed: {lib.lbm_error_string(err).decode()}")
    launches += 1


def x_moves(carries: Blocks, panels: Blocks, layout: halo.Layout) -> List[halo.Move]:
    """What the x-only exchange copies, and its plain version in order: the
    x phase of ``halo.halo_moves`` and the panels' ``halo.row_halo_moves``."""
    return halo.halo_moves(carries, layout)[1] + halo.row_halo_moves(panels, layout.depth)


class HaloExchange:
    """An exchange on one set of carries (and panels), with its rectangles,
    tables, launch arguments and mappings fixed once.  ``moves()`` gives
    what the kernel copies, in any order; ``phases()`` its plain version,
    copied phase after phase (each made only where it runs).  Call it to
    run the exchange; ``close`` it when the carries are done with."""

    def __init__(self, mesh: Mesh, moves: Callable[[], List[halo.Move]],
                 phases: Callable[[], List[List[halo.Move]]], carries: Blocks,
                 panels: Optional[Blocks]):
        local = {mesh.device(*s) for s in mesh.local_shards()}
        self._mapped: Dict[tuple, torch.Tensor] = {}
        self._groups = []
        self._plain = None
        if all(d.type == "cpu" for d in local):
            self._plain = halo.transfers(mesh, phases())
            return
        if any(d.type != "cuda" for d in local):
            raise ValueError(f"the exchange kernel takes CUDA devices, not {local}")
        moves = moves()
        self._cross = mesh.spans_processes
        self._devices = sorted(local, key=str)
        kinds = {id(carries): ("carry", carries)}
        if panels is not None:
            kinds[id(panels)] = ("panel", panels)
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
        self._tables = []
        for device, (pairs, writes, peers) in by_device.items():
            for other in writes:
                err = lib.lbm_enable_peer_access(device.index, other.index)
                if err != 0:
                    raise RuntimeError(f"{device} cannot write into {other}: "
                                       f"{lib.lbm_error_string(err).decode()}")
            rows = rect_rows(pairs)
            if not rows:
                continue
            # from pinned memory, so that the upload does not wait for the
            # work already queued on the card
            staged = torch.tensor(rows, dtype=torch.int64).pin_memory()
            table = staged.to(device, non_blocking=True)
            self._tables += [staged, table]
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            launch = functools.partial(_launch, lib, table.data_ptr(), len(rows),
                                       n_slots(rows), device.index, sms)
            self._groups.append((launch, device, sorted(peers, key=str)))

    def __call__(self) -> None:
        if self._plain is not None:
            self._plain()
            return
        if self._cross:
            self._synchronize()
            dist.barrier()
        for launch, device, peer_devices in self._groups:
            stream = torch.cuda.current_stream(device)
            peers = [torch.cuda.current_stream(p) for p in peer_devices]
            for peer in peers:   # the peer's work so far, which may read its halo
                stream.wait_event(peer.record_event())
            launch(stream.cuda_stream)
            if peers:
                written = stream.record_event()
                for peer in peers:   # the peer's next work reads what landed
                    peer.wait_event(written)
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
    """Which tensors of this process each other process writes rectangles
    into (``{writer rank: [(kind, shard), ...]}``, the offers), and on which
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
                f"{sorted(writing)}: place every neighbour of a shard of another "
                "process (x, y and diagonal: the refresh writes the corners straight "
                "from the diagonal neighbour, so a layout whose x and diagonal "
                "neighbours sit on two cards of one rank is refused too) on one card "
                "of the rank (make_pod_mesh's devices_per_rank)")
    return offers, {key: next(iter(writing)) for (writer, key), writing in cards.items()
                    if writer == mesh.rank}


def _map_neighbours(mesh: Mesh, moves, kinds) -> Dict[tuple, torch.Tensor]:
    """The carries and panels of other processes that this one writes
    into, mapped into it through CUDA IPC as ``ipc_plan`` lays out: each
    process offers the tensors it receives rectangles into, once to each
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


def make_halo_exchange(mesh: Mesh, carries: Blocks, panels: Optional[Blocks],
                       layout: halo.Layout) -> HaloExchange:
    """The refresh of the whole halo of ``carries`` (of ``layout``, any
    depth, tight or aligned) and, where given, of their
    ``(lx + 2*depth,)`` lid-density ``panels`` (their x halos and their
    copy from each column's ``iy = 0`` shard over the rest of it), fixed
    for this set of buffers: a runner with two buffers makes one for each.
    On a mesh that spans processes every process makes it at once (the IPC
    handles are exchanged here)."""
    return HaloExchange(mesh, lambda: halo.refresh_moves(carries, panels, layout),
                        lambda: halo.refresh_phases(carries, panels, layout), carries, panels)


def make_x_halo_exchange(mesh: Mesh, carries: Blocks, panels: Blocks,
                         layout: halo.Layout) -> HaloExchange:
    """The x phase of the exchange on ``carries`` (of ``layout``, K =
    ``layout.depth`` deep) and the x halos of their ``(lx + 2K,)``
    lid-density ``panels`` (the JAX function's contract), over the same
    kernel, fixed for this set of buffers."""
    def moves():
        return x_moves(carries, panels, layout)

    return HaloExchange(mesh, moves, lambda: [moves()], carries, panels)
