"""Streaming (advection) operators: push scatter and pull gather.

Index convention (see ``lattice.py``): population ``k`` moves from cell
``(x, y)`` to ``(x + cx_k, y - cy_k)`` — the y index grows downwards, so a
positive ``cy`` is a shift towards smaller y index (reference: push
``MRT.py:404-414``; pull gather ``MRTTiledPull.py:403-429``).

Out-of-domain gathers WRAP (``torch.roll``) — and the wrap value is
**trajectory-visible** at the lid corners (the right-wall NEBB rewrite copies
g8 into g6 *before* the lid rewrites g8), so every backend must reproduce
the identical wrap semantics.  Do NOT "fix" this to a clamped shift.
"""

from __future__ import annotations

import torch

from .. import lattice


def _shift(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Shift plane ``a (X, Y)`` by (dx, dy) in *index* space; edge cells
    receive the WRAPPED value from the opposite edge."""
    if dx == 0 and dy == 0:
        return a
    return torch.roll(a, shifts=(dx, dy), dims=(0, 1))


def gather_pull(f: torch.Tensor) -> torch.Tensor:
    """Pull gather: out[k](x, y) = f[k](x - cx_k, y + cy_k), wrapping at the
    edges; the wall values are then replaced by the boundary conditions."""
    planes = []
    for k in range(lattice.Q):
        planes.append(_shift(f[k], int(lattice.CX[k]), -int(lattice.CY[k])))
    return torch.stack(planes)


def stream_push(fpost: torch.Tensor) -> torch.Tensor:
    """Push streaming: population k of the result at (x, y) came from
    (x - cx_k, y + cy_k).  On a post-collision field this moves data exactly
    as the pull gather does."""
    return gather_pull(fpost)


stream_pull = gather_pull
