"""Spatial domain decomposition of the lattice over a 2-D mesh of devices,
driven from one process, with an explicit one-cell halo exchange (the JAX
package's ``parallel/``; its multi-process ``multihost`` is not ported
yet)."""

from .mesh import Mesh, make_mesh, shard_lattice, shard_rows, unshard_lattice
from .halo import (
    ShardedState,
    exchange_halo,
    init_sharded_state,
    make_sharded_fused_step,
    make_sharded_scan_runner,
    shard_state,
    sharded_observables,
    unshard_state,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_lattice",
    "shard_rows",
    "unshard_lattice",
    "ShardedState",
    "exchange_halo",
    "init_sharded_state",
    "make_sharded_fused_step",
    "make_sharded_scan_runner",
    "sharded_observables",
    "shard_state",
    "unshard_state",
]
