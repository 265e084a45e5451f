"""Spatial domain decomposition of the lattice over a 2-D mesh of devices,
with an explicit halo exchange (the JAX package's ``parallel/``).  A mesh is
driven from one process, or spans the processes of a group
(``multihost``)."""

from . import multihost
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
    "multihost",
    "sharded_observables",
    "shard_state",
    "unshard_state",
]
