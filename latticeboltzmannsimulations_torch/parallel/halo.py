"""The sharded fused step in plain PyTorch: a two-phase halo exchange and
wall handling masked to the shards that own each wall.

The counterpart of the JAX package's ``parallel/halo.py``.  The global
lattice ``f (9, X, Y)`` is split over a mesh (``mesh.py``); every step each
shard

1. receives one-cell edge strips from its four axis neighbours, in two
   phases (y rows first, then x columns of the y-padded block), so the
   diagonal populations f5..f8 receive the corner values,
2. gathers (pull-streams) from its padded block,
3. applies the reduced NEBB rewrites masked to the shards that own a global
   wall, in the engine's order (left, right, bottom, lid),
4. computes the moments, the equilibrium and the collision locally.

The neighbour rings are periodic, which reproduces the single-device
engine's wrap (``torch.roll``) exactly; the wrap value is visible in the
trajectory at the lid corners, so the corners depend on it.  A one-shard
axis copies onto itself.  JAX's ``ppermute`` becomes tensor copies between
the shards' blocks, which are peer copies when the shards sit on different
cards; ``copies`` counts every copy the sharded runners make.  On a mesh
that spans processes a strip whose two ends lie in different processes is
sent and received over ``torch.distributed`` instead (``Transfer``), one
phase at a time; ``sends`` and ``staged`` count those strips.

The refresh of a mesh's whole halo (every carry's ring and, for the
temporal-block runner, its lid panels' x halos and their copy over each
column) is defined by ``refresh_phases``; ``refresh_moves`` gives the same
result as moves that may run in any order, what the halo exchange kernel
(``kernels/halo_rdma.py``) copies in one launch per card.

This module is also the plain version of the sharded CUDA kernels:
``local_step`` on a one-cell padded block for ``kernels/pull_sharded.py``,
and ``masked_step`` with masks keyed to the global cell for
``kernels/tblock_sharded.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .. import lattice
from ..config import SimConfig
from ..engine import State, _collide, init_state
from ..ops.collision import van_driest_cs2_block
from ..ops.equilibrium import equilibrium, lid_row_density, macroscopics
from .mesh import (
    Blocks,
    Mesh,
    block_shape,
    local_blocks,
    shard_lattice,
    shard_rows,
    unshard_lattice,
    unshard_rows,
)

Pair = Tuple[torch.Tensor, torch.Tensor]

# Tensor copies made by the halo exchanges and the sharded runners in this
# process (strips whose two ends it holds, lid-density replication, and the
# padding of a runner's input and output).
copies = 0
# Strips this process sent to another process, and strips it copied into or
# out of the contiguous buffers of those sends and receives.
sends = 0
staged = 0


class ShardedState(NamedTuple):
    """A ``State`` on a mesh: ``f[ix][iy]`` is shard ``(ix, iy)``'s
    ``(9, lx, ly)`` block and ``rho_lid[ix][iy]`` its ``(lx,)`` slice of the
    lid density (the same for every ``iy``)."""

    f: Blocks
    rho_lid: Blocks

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedState":
        """``fn`` applied to every block."""
        return ShardedState(*(_map_blocks(fn, blocks) for blocks in self))


class WallMasks(NamedTuple):
    """Which cells of a ``(w, h)`` block lie on each wall: per column
    (``left``, ``right``) and per row (``bottom``, ``lid``)."""

    left: torch.Tensor    # (w,) bool
    right: torch.Tensor   # (w,) bool
    bottom: torch.Tensor  # (h,) bool
    lid: torch.Tensor     # (h,) bool


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    global copies
    dst.copy_(src)
    copies += 1


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a shard's cells sit in its carry ``(C, lx + 2*depth, pitch)``:
    x at ``[depth, depth + lx)``, y at ``[y0, y0 + ly)``, inside a
    ``depth``-deep halo ring; the columns of a row past the ring are
    padding that nothing reads."""

    lx: int
    ly: int
    depth: int
    y0: int
    pitch: int

    @classmethod
    def tight(cls, lx: int, ly: int, depth: int) -> "Layout":
        """The ring and nothing else: ``(C, lx + 2*depth, ly + 2*depth)``."""
        return cls(lx, ly, depth, depth, ly + 2 * depth)

    @classmethod
    def aligned(cls, lx: int, ly: int, depth: int) -> "Layout":
        """``y0`` and the pitch multiples of 32, so the first cell of every
        float32 carry row starts a 128-byte line (a warp's 32 cells span
        one line, as in an unpadded field whose rows are a multiple of 32
        long)."""
        y0 = -(-depth // 32) * 32
        return cls(lx, ly, depth, y0, -(-(y0 + ly + depth) // 32) * 32)

    def new(self, like: torch.Tensor) -> torch.Tensor:
        """An unset carry of this layout for blocks like ``like``."""
        return like.new_empty((like.shape[0], self.lx + 2 * self.depth, self.pitch))

    def cells(self, carry: torch.Tensor) -> torch.Tensor:
        """The view of the shard's cells."""
        return carry[:, self.depth:self.depth + self.lx, self.y0:self.y0 + self.ly]

    def padded(self, carry: torch.Tensor) -> torch.Tensor:
        """The view of the cells with their halo ring."""
        d = self.depth
        return carry[:, :, self.y0 - d:self.y0 + self.ly + d]


ALL = slice(None)


class Strip(NamedTuple):
    """A view of one shard's tensor: ``blocks[ix][iy][index]``."""

    blocks: Blocks
    shard: Tuple[int, int]
    index: Tuple[slice, ...]

    def view(self) -> torch.Tensor:
        ix, iy = self.shard
        return self.blocks[ix][iy][self.index]


# (destination, source): the source's values go into the destination.
Move = Tuple[Strip, Strip]


def halo_moves(carries: Blocks, layout: Layout) -> Tuple[List[Move], List[Move]]:
    """The two phases of the exchange that fills the halo ring of every
    shard's carry: the y phase (the top halo is the ``my``-predecessor's
    last rows) and the x phase (columns of the y-padded carries, corners
    included), which must run after it.  Needs ``lx, ly >= depth``."""
    mx, my = len(carries), len(carries[0])
    d, lx, ly, y0 = layout.depth, layout.lx, layout.ly, layout.y0
    ring = slice(y0 - d, y0 + ly + d)
    cols = slice(d, d + lx)
    y_phase, x_phase = [], []
    for ix in range(mx):
        for iy in range(my):
            up, down = (ix, (iy - 1) % my), (ix, (iy + 1) % my)
            y_phase.append((Strip(carries, (ix, iy), (ALL, cols, slice(y0 - d, y0))),
                            Strip(carries, up, (ALL, cols, slice(y0 + ly - d, y0 + ly)))))
            y_phase.append((Strip(carries, (ix, iy), (ALL, cols, slice(y0 + ly, y0 + ly + d))),
                            Strip(carries, down, (ALL, cols, slice(y0, y0 + d)))))
    for ix in range(mx):
        for iy in range(my):
            left, right = ((ix - 1) % mx, iy), ((ix + 1) % mx, iy)
            x_phase.append((Strip(carries, (ix, iy), (ALL, slice(0, d), ring)),
                            Strip(carries, left, (ALL, slice(lx, lx + d), ring))))
            x_phase.append((Strip(carries, (ix, iy), (ALL, slice(d + lx, lx + 2 * d), ring)),
                            Strip(carries, right, (ALL, slice(d, 2 * d), ring))))
    return y_phase, x_phase


def row_halo_moves(panels: Blocks, depth: int) -> List[Move]:
    """The moves that fill the x halo of every shard's ``(lx + 2*depth,)``
    lid-density panel from its x neighbours (the x phase of
    ``halo_moves``)."""
    mx, my = len(panels), len(panels[0])
    d = depth
    lx = next(p for column in panels for p in column if p is not None).shape[0] - 2 * d
    moves = []
    for ix in range(mx):
        for iy in range(my):
            moves.append((Strip(panels, (ix, iy), (slice(0, d),)),
                          Strip(panels, ((ix - 1) % mx, iy), (slice(lx, lx + d),))))
            moves.append((Strip(panels, (ix, iy), (slice(d + lx, lx + 2 * d),)),
                          Strip(panels, ((ix + 1) % mx, iy), (slice(d, 2 * d),))))
    return moves


def replicate_moves(rows: Blocks) -> List[Move]:
    """The moves of each ``iy = 0`` shard's row over the others of its
    column: the lid density is owned by the top shards (the JAX package's
    ``psum`` over ``my``)."""
    return [(Strip(rows, (ix, iy), (ALL,)), Strip(rows, (ix, 0), (ALL,)))
            for ix in range(len(rows)) for iy in range(1, len(rows[0]))]


def refresh_phases(carries: Blocks, panels: Optional[Blocks],
                   layout: Layout) -> List[List[Move]]:
    """The refresh of a mesh's whole halo, as phases of moves copied one
    phase after the other: the y phase, then the x phase (with the x halo
    of every ``(lx + 2*depth,)`` lid-density panel, where ``panels`` are
    given), then each ``iy = 0`` shard's panel over the rest of its column.
    This is the definition of the refresh; ``refresh_moves`` is the same
    result in one set of moves."""
    y_phase, x_phase = halo_moves(carries, layout)
    if panels is None:
        return [y_phase, x_phase]
    return [y_phase, x_phase + row_halo_moves(panels, layout.depth),
            replicate_moves(panels)]


def refresh_moves(carries: Blocks, panels: Optional[Blocks],
                  layout: Layout) -> List[Move]:
    """The refresh of ``refresh_phases`` as moves that run in any order:
    every source is a shard's own cells and every destination a halo cell
    or the panel of a shard that does not own the lid, so no move reads
    what another writes.  Each carry gets eight rectangles: its two y
    strips and two x strips from its axis neighbours, and its four K x K
    corners straight from its diagonal neighbours (where the phases carry
    them through the x neighbour's y halo).  Each panel's x halo, and the
    cells of a panel with ``iy > 0``, come straight from the ``iy = 0``
    panels of the columns."""
    mx, my = len(carries), len(carries[0])
    d, lx, ly, y0 = layout.depth, layout.lx, layout.ly, layout.y0
    # (destination span, source span in the neighbour, step to the neighbour)
    xs = ((slice(0, d), slice(lx, lx + d), -1), (slice(d, d + lx), slice(d, d + lx), 0),
          (slice(d + lx, lx + 2 * d), slice(d, 2 * d), 1))
    ys = ((slice(y0 - d, y0), slice(y0 + ly - d, y0 + ly), -1),
          (slice(y0, y0 + ly), slice(y0, y0 + ly), 0),
          (slice(y0 + ly, y0 + ly + d), slice(y0, y0 + d), 1))
    moves = []
    for ix in range(mx):
        for iy in range(my):
            for x_dst, x_src, sx in xs:
                for y_dst, y_src, sy in ys:
                    if sx or sy:
                        moves.append((Strip(carries, (ix, iy), (ALL, x_dst, y_dst)),
                                      Strip(carries, ((ix + sx) % mx, (iy + sy) % my),
                                            (ALL, x_src, y_src))))
    if panels is not None:
        for ix in range(mx):
            for iy in range(my):
                for x_dst, x_src, sx in xs:
                    if sx or iy:
                        moves.append((Strip(panels, (ix, iy), (x_dst,)),
                                      Strip(panels, ((ix + sx) % mx, 0), (x_src,))))
    return moves


def move_pairs(moves: List[Move]) -> List[Pair]:
    """The (destination, source) views of moves whose ends this process
    holds."""
    return [(dst.view(), src.view()) for dst, src in moves]


def halo_pairs(carries: Blocks, layout: Layout) -> List[Pair]:
    """The (destination, source) views of ``halo_moves`` on a mesh of one
    process, in the order they must be copied: the y phase, then the x
    phase."""
    y_phase, x_phase = halo_moves(carries, layout)
    return move_pairs(y_phase + x_phase)


def row_halo_pairs(panels: Blocks, depth: int) -> List[Pair]:
    """The (destination, source) views of ``row_halo_moves``."""
    return move_pairs(row_halo_moves(panels, depth))


def replicate_pairs(rows: Blocks) -> List[Pair]:
    """The (destination, source) views of ``replicate_moves``."""
    return move_pairs(replicate_moves(rows))


def copy_pairs(pairs: List[Pair]) -> None:
    """Copy each source view into its destination view, in order."""
    for dst, src in pairs:
        _copy(dst, src)


class Transfer:
    """One phase of an exchange as this process runs it.  A move whose two
    ends this process holds is a tensor copy (``copy_pairs``, in order);
    the others are sends to and receives from the processes that hold the
    other end, one batch of ``torch.distributed`` point-to-point operations.
    The strips are views with gaps, so each goes through a contiguous
    buffer, in host memory under ``gloo`` (which cannot send card memory:
    the strips cross, the compute stays on the card).  Every process of a
    mesh builds the same moves, so a send and its receive pair up by the
    move's index as their tag.  The views and buffers are fixed here, once;
    each call runs the phase and returns when it has landed."""

    def __init__(self, mesh: Mesh, moves: List[Move]):
        self.copies: List[Pair] = []
        self.sends, self.recvs = [], []
        for tag, (dst, src) in enumerate(moves):
            if mesh.is_local(*dst.shard) and mesh.is_local(*src.shard):
                self.copies.append((dst.view(), src.view()))
            elif mesh.is_local(*src.shard):
                view = src.view()
                self.sends.append((view, _buffer(view), mesh.owner(*dst.shard), tag))
            elif mesh.is_local(*dst.shard):
                view = dst.view()
                self.recvs.append((view, _buffer(view), mesh.owner(*src.shard), tag))

    def __call__(self) -> None:
        global sends, staged
        copy_pairs(self.copies)
        if not (self.sends or self.recvs):
            return
        ops = []
        for view, buf, peer, tag in self.sends:
            buf.copy_(view)
            ops.append(dist.P2POp(dist.isend, buf, peer, tag=tag))
        ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag)
                for _, buf, peer, tag in self.recvs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for view, buf, _, _ in self.recvs:
            view.copy_(buf)
        sends += len(self.sends)
        staged += len(self.sends) + len(self.recvs)


def transfers(mesh: Mesh, phases: List[List[Move]]) -> Callable[[], None]:
    """A call that runs each phase as a ``Transfer``, one after the other."""
    fixed = [Transfer(mesh, phase) for phase in phases]

    def run() -> None:
        for transfer in fixed:
            transfer()

    return run


def _buffer(view: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer for a strip that crosses processes: in host
    memory for a card's strip under ``gloo``, else on the strip's device."""
    host = view.is_cuda and dist.get_backend() == "gloo"
    return torch.empty(view.shape, dtype=view.dtype,
                       device="cpu" if host else view.device)


def _map_blocks(fn, blocks: Blocks) -> Blocks:
    """``fn`` of each block this process holds, None for the others."""
    return tuple(tuple(None if b is None else fn(b) for b in column)
                 for column in blocks)


def empty_blocks(blocks: Blocks) -> Blocks:
    """An unset tensor like each block."""
    return _map_blocks(torch.empty_like, blocks)


def copy_into(dst: Blocks, src: Blocks, view=lambda t: t) -> None:
    """Each block of ``src`` copied into ``view`` of its ``dst`` block (a
    runner's carries or panels that it keeps)."""
    for d_col, s_col in zip(dst, src):
        for d, s in zip(d_col, s_col):
            if s is not None:
                _copy(view(d), s)


def pad_blocks(blocks: Blocks, layout: Layout) -> Blocks:
    """Each ``(C, lx, ly)`` block copied into a new carry of ``layout``;
    the halo ring is left unset."""
    def pad(b):
        c = layout.new(b)
        _copy(layout.cells(c), b)
        return c
    return _map_blocks(pad, blocks)


def unpad_blocks(carries: Blocks, layout: Layout) -> Blocks:
    """The cells of each carry as a new contiguous block."""
    def unpad(c):
        cells = layout.cells(c)
        b = c.new_empty(cells.shape)
        _copy(b, cells)
        return b
    return _map_blocks(unpad, carries)


def pad_rows(rows: Blocks, depth: int) -> Blocks:
    """Each ``(lx,)`` row copied into a new ``(lx + 2*depth,)`` panel; the
    halo is left unset."""
    def pad(r):
        p = r.new_empty(r.shape[0] + 2 * depth)
        _copy(p[depth:depth + r.shape[0]], r)
        return p
    return _map_blocks(pad, rows)


def unpad_rows(panels: Blocks, depth: int) -> Blocks:
    """The cells of each panel as a new row."""
    def unpad(p):
        r = p.new_empty(p.shape[0] - 2 * depth)
        _copy(r, p[depth:p.shape[0] - depth])
        return r
    return _map_blocks(unpad, panels)


def exchange_halo(blocks: Blocks, depth: int = 1) -> Blocks:
    """Every shard's ``(C, lx, ly)`` block padded to
    ``(C, lx + 2*depth, ly + 2*depth)`` with its neighbours' edge strips,
    two-phase so the corners propagate diagonally."""
    _, lx, ly = blocks[0][0].shape
    layout = Layout.tight(lx, ly, depth)
    carries = pad_blocks(blocks, layout)
    copy_pairs(halo_pairs(carries, layout))
    return carries


def edge_flags(mesh_shape: Tuple[int, int], ix: int, iy: int) -> Tuple[bool, bool, bool, bool]:
    """Does shard ``(ix, iy)`` own the global (left, right, lid, bottom)
    wall?  The lid is global row 0, on the ``iy = 0`` shards."""
    mx, my = mesh_shape
    return ix == 0, ix == mx - 1, iy == 0, iy == my - 1


def flag_masks(flags, lx: int, ly: int, device) -> WallMasks:
    """The walls of an ``(lx, ly)`` shard from its edge flags: a wall is the
    edge cell of a shard that owns it."""
    left, right, top, bottom = flags
    cols = torch.arange(lx, device=device)
    rows = torch.arange(ly, device=device)
    return WallMasks(left=(cols == 0) & left, right=(cols == lx - 1) & right,
                     bottom=(rows == ly - 1) & bottom, lid=(rows == 0) & top)


def _gather_from_padded(fpad: torch.Tensor) -> torch.Tensor:
    """Pull gather on a one-cell padded block ``(9, w + 2, h + 2)``:
    ``out[k](x, y) = f[k](x - cx_k, y + cy_k)`` (see ``ops/streaming.py``)."""
    w, h = fpad.shape[1] - 2, fpad.shape[2] - 2
    planes = []
    for k in range(lattice.Q):
        x0 = 1 - int(lattice.CX[k])
        y0 = 1 + int(lattice.CY[k])
        planes.append(fpad[k, x0:x0 + w, y0:y0 + h])
    return torch.stack(planes)


def _gather_bc(cfg: SimConfig, fpad: torch.Tensor, rho_lid_prev: torch.Tensor,
               m: WallMasks) -> torch.Tensor:
    """Gather + reduced NEBB on the cells the masks mark, in the fused
    engine's order (left, right, bottom, lid), so corner values chain as
    there.  ``rho_lid_prev`` is the previous lid density of each cell,
    ``(w, h)`` or ``(w, 1)``; the lid momentum is zero on the side-wall
    columns (the two corners)."""
    g = _gather_from_padded(fpad)
    w, h = g.shape[1], g.shape[2]
    left, right, bottom, lid = m
    # Left wall: f1<-f3, f5<-f7, f8<-f6.
    g[1][left] = g[3][left]
    g[5][left] = g[7][left]
    g[8][left] = g[6][left]
    # Right wall: f3<-f1, f6<-f8, f7<-f5.
    g[3][right] = g[1][right]
    g[6][right] = g[8][right]
    g[7][right] = g[5][right]
    # Bottom wall: f2<-f4, f5<-f7, f6<-f8.
    g[2][:, bottom] = g[4][:, bottom]
    g[5][:, bottom] = g[7][:, bottom]
    g[6][:, bottom] = g[8][:, bottom]
    # Moving lid: f4<-f2; f7<-f5 - mom; f8<-f6 + mom.
    mom = (rho_lid_prev * (cfg.u_lid / 6.0)).expand(w, h)
    mom = torch.where((left | right)[:, None], 0.0, mom)
    g[4][:, lid] = g[2][:, lid]
    g[7][:, lid] = g[5][:, lid] - mom[:, lid]
    g[8][:, lid] = g[6][:, lid] + mom[:, lid]
    return g


def _macros(cfg: SimConfig, g: torch.Tensor, m: WallMasks):
    """Moments with the wall overrides: u = 0 on the static walls; on the
    lid row between the side walls u = (u_lid, 0) and the closure density
    (the two lid corners belong to the side walls)."""
    rho, u = macroscopics(g)
    side = m.left | m.right
    u = torch.where(side[:, None] | m.bottom[None, :], 0.0, u)
    lid_in = m.lid[None, :] & ~side[:, None]
    u = torch.stack([torch.where(lid_in, cfg.u_lid, u[0]),
                     torch.where(lid_in, 0.0, u[1])])
    rho = torch.where(lid_in, lid_row_density(g), rho)
    return rho, u


def masked_step(cfg: SimConfig, fpad: torch.Tensor, rho_lid_prev: torch.Tensor,
                m: WallMasks, cs2: Optional[torch.Tensor] = None):
    """One fused step of the ``(w, h)`` interior of a one-cell padded block
    with the walls where ``m`` marks them.  Returns the post-collision
    ``(9, w, h)`` and the density ``(w, h)`` (the closure density on the lid
    row: the next step's lid density).  ``cs2`` is the block's Van Driest
    Cs^2 plane, required under Van Driest damping."""
    if cfg.turbulence == "smagorinsky" and cfg.van_driest and cs2 is None:
        raise ValueError("a sharded Van Driest step needs its shard's Cs^2 plane")
    g = _gather_bc(cfg, fpad, rho_lid_prev, m)
    rho, u = _macros(cfg, g, m)
    feq = equilibrium(rho, u)
    return _collide(cfg, g, feq, rho, cs2_field=cs2), rho


def local_step(cfg: SimConfig, fpad: torch.Tensor, rho_lid: torch.Tensor,
               flags, cs2: Optional[torch.Tensor] = None):
    """One fused step of one shard: ``fpad (9, lx + 2, ly + 2)`` with its
    halo ring filled and the shard's ``(lx,)`` lid density -> the new
    ``(9, lx, ly)`` block and its ``(lx,)`` first-row density (the lid
    density on a shard that owns the lid)."""
    lx, ly = fpad.shape[1] - 2, fpad.shape[2] - 2
    m = flag_masks(flags, lx, ly, fpad.device)
    f_new, rho = masked_step(cfg, fpad, rho_lid[:, None], m, cs2)
    return f_new, rho[:, 0].clone()


def cs2_blocks(cfg: SimConfig, mesh: Mesh, dtype: torch.dtype) -> Optional[Blocks]:
    """Each shard's slice of the global Van Driest Cs^2 plane on its device,
    or None without Van Driest damping."""
    if not (cfg.turbulence == "smagorinsky" and cfg.van_driest):
        return None
    lx, ly = block_shape(cfg.nx, cfg.ny, cfg.mesh_shape)
    return local_blocks(mesh, lambda ix, iy: van_driest_cs2_block(
        cfg.nx, cfg.ny, ix * lx, iy * ly, lx, ly, cfg.u_lid / cfg.nu, dtype=dtype,
        device=mesh.device(ix, iy)))


def check_mesh(cfg: SimConfig, mesh: Mesh) -> Tuple[int, int]:
    """``(lx, ly)``; raises unless the mesh is the configuration's and
    divides its grid."""
    if tuple(cfg.mesh_shape) != mesh.shape:
        raise ValueError(f"the mesh is {mesh.shape}, the configuration's "
                         f"mesh_shape {cfg.mesh_shape}")
    return block_shape(cfg.nx, cfg.ny, mesh.shape)


def check_single_process(mesh: Mesh, what: str) -> None:
    """Raise if ``mesh`` spans processes: ``what`` runs in one."""
    if mesh.spans_processes:
        raise ValueError(f"{what} runs on a mesh of one process; across processes "
                         "use kernels.pull_sharded or kernels.tblock_sharded")


def check_sharded_state(cfg: SimConfig, state: ShardedState, mesh: Mesh) -> None:
    """Every block of this process has its shard's shape, dtype and
    device."""
    lx, ly = block_shape(cfg.nx, cfg.ny, mesh.shape)
    for ix, iy in mesh.local_shards():
        dev = mesh.device(ix, iy)
        for name, t, shape in (("f", state.f[ix][iy], (9, lx, ly)),
                               ("rho_lid", state.rho_lid[ix][iy], (lx,))):
            if tuple(t.shape) != shape or t.device != dev:
                raise ValueError(
                    f"shard {(ix, iy)}: {name} is {tuple(t.shape)} on {t.device}, "
                    f"expected {shape} on {dev}")


def _sharded_step(cfg: SimConfig, mesh: Mesh):
    lx, ly = check_mesh(cfg, mesh)
    check_single_process(mesh, "the plain sharded engine")
    cs2 = cs2_blocks(cfg, mesh, cfg.dtype)

    def step(state: ShardedState) -> ShardedState:
        check_sharded_state(cfg, state, mesh)
        padded = exchange_halo(state.f)
        f, rows = [], []
        for ix in range(mesh.shape[0]):
            col_f, col_rho = [], []
            for iy in range(mesh.shape[1]):
                f_new, rho_row = local_step(
                    cfg, padded[ix][iy], state.rho_lid[ix][iy],
                    edge_flags(mesh.shape, ix, iy),
                    None if cs2 is None else cs2[ix][iy])
                col_f.append(f_new)
                col_rho.append(rho_row)
            f.append(tuple(col_f))
            # the lid density of the top shard, replicated over the column
            rows.append(tuple(col_rho[0].to(mesh.device(ix, iy))
                              for iy in range(mesh.shape[1])))
        return ShardedState(tuple(f), tuple(rows))

    return step


def make_sharded_fused_step(cfg: SimConfig, mesh: Mesh) -> Callable[[ShardedState], ShardedState]:
    """One fused collide-and-stream step over the mesh."""
    cfg.validate()
    return _sharded_step(cfg, mesh)


def make_sharded_scan_runner(cfg: SimConfig, n_steps: int, mesh: Mesh):
    """``n_steps`` sharded steps per call, each with its halo exchange."""
    step = make_sharded_fused_step(cfg, mesh)

    def run(state: ShardedState) -> ShardedState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return run


def sharded_observables(cfg: SimConfig, mesh: Mesh):
    """The sharded counterpart of ``engine.observables``: the
    boundary-corrected pre-collision ``(rho (X, Y), u (2, X, Y))``, gathered
    onto the mesh's first device."""
    check_mesh(cfg, mesh)
    check_single_process(mesh, "the sharded observables")

    def obs(state: ShardedState):
        check_sharded_state(cfg, state, mesh)
        padded = exchange_halo(state.f)
        rho_b, u_b = [], []
        for ix in range(mesh.shape[0]):
            col_rho, col_u = [], []
            for iy in range(mesh.shape[1]):
                fpad = padded[ix][iy]
                m = flag_masks(edge_flags(mesh.shape, ix, iy), fpad.shape[1] - 2,
                               fpad.shape[2] - 2, fpad.device)
                rho, u = _macros(cfg, _gather_bc(cfg, fpad, state.rho_lid[ix][iy][:, None], m), m)
                col_rho.append(rho)
                col_u.append(u)
            rho_b.append(tuple(col_rho))
            u_b.append(tuple(col_u))
        dev = mesh.first_device
        return unshard_lattice(tuple(rho_b), dev), unshard_lattice(tuple(u_b), dev)

    return obs


def shard_state(state: State, mesh: Mesh) -> ShardedState:
    """Place a (single-device) ``State`` onto the mesh."""
    return ShardedState(f=shard_lattice(state.f, mesh),
                        rho_lid=shard_rows(state.rho_lid, mesh))


def unshard_state(state: ShardedState, device: torch.device,
                  mesh: Optional[Mesh] = None) -> Optional[State]:
    """The reverse of ``shard_state``: the global ``State`` on ``device``
    (on a ``mesh`` that spans processes: gathered on rank 0, None on the
    others)."""
    f = unshard_lattice(state.f, device, mesh)
    rho_lid = unshard_rows(state.rho_lid, device, mesh)
    return None if f is None else State(f=f, rho_lid=rho_lid)


def init_sharded_state(cfg: SimConfig, mesh: Mesh) -> ShardedState:
    return shard_state(init_state(cfg, mesh.first_device), mesh)
