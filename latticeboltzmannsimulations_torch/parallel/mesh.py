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
blocks back into one tensor.  A mesh is driven from one
process; a device may appear in it more than once (several shards on one
card, or on the CPU), which is how one card or the CPU runs a larger mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import torch

from ..config import resolve_device

MESH_AXES = ("mx", "my")

# A tensor per shard, indexed [ix][iy].
Blocks = Tuple[Tuple[torch.Tensor, ...], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``mx x my`` grid of devices; shard ``(ix, iy)`` lives on
    ``devices[ix][iy]``."""

    shape: Tuple[int, int]
    devices: Tuple[Tuple[torch.device, ...], ...]

    def shards(self) -> Iterator[Tuple[int, int]]:
        """Every shard's ``(ix, iy)``, x-major."""
        mx, my = self.shape
        for ix in range(mx):
            for iy in range(my):
                yield ix, iy

    def device(self, ix: int, iy: int) -> torch.device:
        return self.devices[ix][iy]

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0]

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
        devices = [_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, have {len(devices)}")
    grid = tuple(tuple(devices[ix * my + iy] for iy in range(my)) for ix in range(mx))
    return Mesh((mx, my), grid)


def _device(d) -> torch.device:
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


def shard_lattice(f: torch.Tensor, mesh: Mesh) -> Blocks:
    """``(..., X, Y)`` -> a contiguous ``(..., lx, ly)`` block per shard, on
    its device (the JAX package's ``lattice_sharding``; also
    ``field_sharding`` for an ``(X, Y)`` field)."""
    lx, ly = block_shape(f.shape[-2], f.shape[-1], mesh.shape)
    return tuple(
        tuple(f[..., ix * lx:(ix + 1) * lx, iy * ly:(iy + 1) * ly]
              .to(mesh.device(ix, iy)).contiguous()
              for iy in range(mesh.shape[1]))
        for ix in range(mesh.shape[0]))



def shard_rows(v: torch.Tensor, mesh: Mesh) -> Blocks:
    """``(X,)`` -> its ``(lx,)`` slice per shard, the same for every ``iy``
    (the JAX package's ``row_sharding``)."""
    mx, my = mesh.shape
    if v.shape[0] % mx:
        raise ValueError(f"{v.shape[0]} rows must divide the mesh shape {mesh.shape}")
    lx = v.shape[0] // mx
    return tuple(
        tuple(v[ix * lx:(ix + 1) * lx].to(mesh.device(ix, iy)).contiguous()
              for iy in range(my))
        for ix in range(mx))


def unshard_lattice(blocks: Blocks, device: torch.device) -> torch.Tensor:
    """The reverse of ``shard_lattice``: one ``(..., X, Y)`` tensor on
    ``device``."""
    return torch.cat([torch.cat([b.to(device) for b in column], dim=-1)
                      for column in blocks], dim=-2)



def unshard_rows(blocks: Blocks, device: torch.device) -> torch.Tensor:
    """The reverse of ``shard_rows``, read from the ``iy = 0`` shards."""
    return torch.cat([column[0].to(device) for column in blocks])
