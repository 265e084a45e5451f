"""The device mesh and the placement of the lattice on it.

The counterpart of the JAX package's ``parallel/mesh.py``.  The lattice
``f (9, X, Y)`` is split over a 2-D mesh ``(mx, my)``: X over ``mx``, Y over
``my``, the populations replicated, so shard ``(ix, iy)`` owns all 9 planes
of the block ``[ix*lx, (ix+1)*lx) x [iy*ly, (iy+1)*ly)`` on its device.  An
X-indexed row such as the lid density ``(X,)`` is split over ``mx`` and
replicated over ``my``.

The JAX package's named shardings become the slicing below
(``lattice_sharding`` and ``field_sharding`` -> ``shard_lattice``,
``row_sharding`` -> ``shard_rows``), with their reverses, which gather the
blocks back into one tensor.  A device may appear in a mesh more than once
(several shards on one card, or on the CPU), which is how one card or the
CPU runs a larger mesh.

A mesh may span processes (``multihost.make_pod_mesh``): it then records
the rank that owns each shard and this process's rank.  A process holds the
blocks of its own shards only, and ``None`` in place of the others';
``unshard_*`` gathers the blocks to rank 0 through the process group
(``torch.distributed``).  A mesh built by ``make_mesh`` lives in one process.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import resolve_device

MESH_AXES = ("mx", "my")

# A tensor per shard, indexed [ix][iy]; None for a shard another process
# owns.
Blocks = Tuple[Tuple[Optional[torch.Tensor], ...], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``mx x my`` grid of devices; shard ``(ix, iy)`` lives on
    ``devices[ix][iy]`` of the process of rank ``ranks[ix][iy]`` (every
    shard in this process, of rank ``rank``, when ``ranks`` is None)."""

    shape: Tuple[int, int]
    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0

    def shards(self) -> Iterator[Tuple[int, int]]:
        """Every shard's ``(ix, iy)``, x-major."""
        mx, my = self.shape
        for ix in range(mx):
            for iy in range(my):
                yield ix, iy

    def owner(self, ix: int, iy: int) -> int:
        """The rank of the process that holds shard ``(ix, iy)``."""
        return self.rank if self.ranks is None else self.ranks[ix][iy]

    def is_local(self, ix: int, iy: int) -> bool:
        return self.owner(ix, iy) == self.rank

    def local_shards(self) -> List[Tuple[int, int]]:
        """The shards this process holds, x-major."""
        return [s for s in self.shards() if self.is_local(*s)]

    @property
    def spans_processes(self) -> bool:
        return any(self.owner(*s) != self.rank for s in self.shards())

    def device(self, ix: int, iy: int) -> torch.device:
        return self.devices[ix][iy]

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.device(*self.local_shards()[0])

    @property
    def on_cuda(self) -> bool:
        return all(d.type == "cuda" for row in self.devices for d in row)


def make_mesh(mesh_shape: Tuple[int, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D device mesh for spatial decomposition.

    ``mesh_shape = (mx, my)`` needs ``mx * my`` devices, taken in order,
    x-major.  With ``devices=None`` they are the first ``mx * my`` visible
    CUDA devices; without enough of them this raises, and nothing falls back
    to the CPU.  An explicit list may name one device several times.
    """
    mx, my = mesh_shape
    if mx < 1 or my < 1:
        raise ValueError(f"mesh {mesh_shape}: both axes need at least one shard")
    n = mx * my
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh {mesh_shape} needs {n} CUDA devices and none is "
                "available; pass devices (e.g. ['cpu'] * n) to run it elsewhere"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [as_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, have {len(devices)}")
    grid = tuple(tuple(devices[ix * my + iy] for iy in range(my)) for ix in range(mx))
    return Mesh((mx, my), grid)


def as_device(d) -> torch.device:
    """An explicit device; a bare ``"cuda"`` is the current card (which
    needs one), an indexed one is taken as named."""
    d = torch.device(d)
    return resolve_device(d) if d.type == "cuda" and d.index is None else d


def block_shape(nx: int, ny: int, mesh_shape: Tuple[int, int]) -> Tuple[int, int]:
    """``(lx, ly)`` of one shard; raises if the mesh does not divide the grid."""
    mx, my = mesh_shape
    if nx % mx or ny % my:
        raise ValueError(f"grid {nx}x{ny} must divide the mesh shape {mesh_shape}")
    return nx // mx, ny // my


def local_blocks(mesh: Mesh, block) -> Blocks:
    """``block(ix, iy)`` for each shard of this process, None for the
    others."""
    mx, my = mesh.shape
    return tuple(tuple(block(ix, iy) if mesh.is_local(ix, iy) else None
                       for iy in range(my))
                 for ix in range(mx))


def shard_lattice(f: torch.Tensor, mesh: Mesh) -> Blocks:
    """``(..., X, Y)`` -> a contiguous ``(..., lx, ly)`` block per shard of
    this process, on its device (the JAX package's ``lattice_sharding``;
    also ``field_sharding`` for an ``(X, Y)`` field)."""
    lx, ly = block_shape(f.shape[-2], f.shape[-1], mesh.shape)
    return local_blocks(mesh, lambda ix, iy: f[..., ix * lx:(ix + 1) * lx,
                                                iy * ly:(iy + 1) * ly]
                         .to(mesh.device(ix, iy)).contiguous())


def shard_rows(v: torch.Tensor, mesh: Mesh) -> Blocks:
    """``(X,)`` -> its ``(lx,)`` slice per shard of this process, the same
    for every ``iy`` (the JAX package's ``row_sharding``)."""
    mx = mesh.shape[0]
    if v.shape[0] % mx:
        raise ValueError(f"{v.shape[0]} rows must divide the mesh shape {mesh.shape}")
    lx = v.shape[0] // mx
    return local_blocks(mesh, lambda ix, iy: v[ix * lx:(ix + 1) * lx]
                         .to(mesh.device(ix, iy)).contiguous())


def gather_blocks(blocks: Blocks, mesh: Optional[Mesh], device: torch.device,
                  shards=None) -> Optional[Blocks]:
    """Every block of ``shards`` (default: all) on ``device``; on a mesh
    that spans processes, only on rank 0, which receives the others' blocks
    through the process group (staged through host memory under ``gloo``),
    and None on the other ranks.  Every block has the shape of rank 0's
    first."""
    mx, my = len(blocks), len(blocks[0])
    wanted = set(shards if shards is not None else
                 ((ix, iy) for ix in range(mx) for iy in range(my)))
    if mesh is None or not mesh.spans_processes:
        return tuple(tuple(b.to(device) if (ix, iy) in wanted else None
                           for iy, b in enumerate(column))
                     for ix, column in enumerate(blocks))
    staging = "cpu" if dist.get_backend() == "gloo" else None
    out = [[None] * my for _ in range(mx)]
    ops, received = [], []
    like = next(b for column in blocks for b in column if b is not None)
    for tag, (ix, iy) in enumerate(sorted(wanted)):
        owner, b = mesh.owner(ix, iy), blocks[ix][iy]
        if mesh.rank == 0 and owner == 0:
            out[ix][iy] = b.to(device)
        elif mesh.rank == 0:
            buf = torch.empty(like.shape, dtype=like.dtype, device=staging or like.device)
            ops.append(dist.P2POp(dist.irecv, buf, owner, tag=tag))
            received.append((ix, iy, buf))
        elif owner == mesh.rank:
            ops.append(dist.P2POp(dist.isend, b.to(staging or b.device).contiguous(), 0,
                                  tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if mesh.rank != 0:
        return None
    for ix, iy, buf in received:
        out[ix][iy] = buf.to(device)
    return tuple(tuple(column) for column in out)


def unshard_lattice(blocks: Blocks, device: torch.device,
                    mesh: Optional[Mesh] = None) -> Optional[torch.Tensor]:
    """The reverse of ``shard_lattice``: one ``(..., X, Y)`` tensor on
    ``device`` (on a mesh that spans processes: on rank 0, None on the
    others)."""
    blocks = gather_blocks(blocks, mesh, device)
    if blocks is None:
        return None
    return torch.cat([torch.cat(list(column), dim=-1) for column in blocks], dim=-2)


def unshard_rows(blocks: Blocks, device: torch.device,
                 mesh: Optional[Mesh] = None) -> Optional[torch.Tensor]:
    """The reverse of ``shard_rows``, read from the ``iy = 0`` shards (on a
    mesh that spans processes: on rank 0, None on the others)."""
    blocks = gather_blocks(blocks, mesh, device,
                           [(ix, 0) for ix in range(len(blocks))])
    if blocks is None:
        return None
    return torch.cat([column[0] for column in blocks])
