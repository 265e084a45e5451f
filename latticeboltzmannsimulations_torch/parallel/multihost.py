"""Runs across processes: the process group, and a mesh that spans it.

The counterpart of the JAX package's ``parallel/multihost.py``.  One process
runs per card (or per group of cards), each started by a launcher such as
``torchrun``, which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``:

    from latticeboltzmannsimulations_torch.parallel import multihost
    multihost.initialize()                     # the process group
    mesh = multihost.make_pod_mesh((8, 4))     # global (mx, my), this card
    state = shard_state(init_state(cfg, mesh.first_device), mesh)
    out = pull_sharded.make_sharded_runner(cfg, n, mesh)(state)
    state = unshard_state(out, mesh.first_device, mesh)   # rank 0; else None

Each process holds its own shards; the halo strips whose ends lie in two
processes travel over ``torch.distributed`` (``parallel/halo.py``), and the
x ring of ``kernels/halo_rdma.py`` writes straight into the neighbours'
carries.  ``spawn`` starts the ranks of a run on this machine, each in the
process group of them all (what the tests and ``chip_smoke.py`` do).

A single-process run never calls ``initialize()``, and everything else here
degrades to this process.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing

from .mesh import Mesh, as_device

# The variables by which a launcher describes the process group.
CLUSTER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _init_method(address: Optional[str]) -> str:
    """``env://`` without an address; a bare ``host:port`` as TCP."""
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with the JAX package's
    arguments: ``coordinator_address`` is the init method (``file://...``,
    ``tcp://host:port`` or a bare ``host:port``; the launcher's variables
    when None), ``num_processes`` the world size, ``process_id`` the rank.

    A run with no arguments and none of ``CLUSTER_VARS`` set is a plain
    single-process run: this returns without touching ``torch.distributed``,
    as it does when the group exists already.  The backend is ``nccl`` when
    each rank of this machine has a card of its own (``LOCAL_WORLD_SIZE``,
    else the world size, ranks against the cards it sees) and ``gloo``
    otherwise; ``nccl`` takes the rank's card (``LOCAL_RANK``, else the
    rank, modulo the cards) as the current device.  ``nccl`` with fewer
    cards than ranks raises: NCCL refuses two ranks on one card, where a
    group would hang at its first collective.
    """
    if dist.is_initialized():
        return
    cluster_env = any(v in os.environ for v in CLUSTER_VARS)
    if coordinator_address is None and num_processes is None and not cluster_env:
        return
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if 0 < local_ranks <= cards else "gloo"
    if backend == "nccl":
        if cards < local_ranks:
            raise ValueError(
                f"backend 'nccl' needs a card per rank: {local_ranks} ranks on this "
                f"machine would share {cards} card(s), and NCCL refuses two ranks "
                "on one card; use backend='gloo'")
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    if backend == "nccl":
        # NCCL's first operation must involve every rank; the halo exchanges'
        # sends and receives involve neighbours only
        dist.barrier()


def make_pod_mesh(mesh_shape: Tuple[int, int],
                  devices_per_rank: Optional[Sequence] = None) -> Mesh:
    """The global ``(mx, my)`` mesh over every process of the group (this
    process alone without one).  Each rank places its shards on the
    devices ``devices_per_rank`` (the same number on every rank; default:
    its current card).  The shards are numbered x-major and dealt out
    process-major, ``devices_per_rank`` at a time, as the JAX package's
    ``jax.devices()`` are: x is the process-major axis, so the y halo rows
    stay within a process and only the x strips cross between them."""
    mx, my = mesh_shape
    world, rank = ((dist.get_world_size(), dist.get_rank()) if dist.is_initialized()
                   else (1, 0))
    if devices_per_rank is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices_per_rank "
                               "(e.g. ['cpu']) to run elsewhere")
        devices_per_rank = [torch.device("cuda", torch.cuda.current_device())]
    local = [as_device(d) for d in devices_per_rank]
    per = len(local)
    if per * world != mx * my:
        raise ValueError(f"mesh {mesh_shape} has {mx * my} shards; {world} ranks of "
                         f"{per} devices hold {per * world}")
    devices = tuple(tuple(local[(ix * my + iy) % per] for iy in range(my))
                    for ix in range(mx))
    ranks = tuple(tuple((ix * my + iy) // per for iy in range(my)) for ix in range(mx))
    return Mesh((mx, my), devices, ranks, rank)


def _run_rank(rank: int, fn: Callable, nprocs: int, init_file: str, backend: str,
              args: tuple) -> None:
    initialize(f"file://{init_file}", nprocs, rank, backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, init_file: str, args: tuple = (),
          backend: str = "gloo", timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes of this machine,
    each in the process group of them all (a ``file://`` store at
    ``init_file``, a path that must not exist yet), and wait for them.
    ``fn`` must be importable by name (a module-level function).  Raises
    if a process fails (the others are ended) or if they outlast
    ``timeout`` seconds (all are ended)."""
    ctx = torch.multiprocessing.start_processes(
        _run_rank, args=(fn, nprocs, init_file, backend, args), nprocs=nprocs,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} processes outlasted {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
