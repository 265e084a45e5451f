"""``parallel/multihost.py`` and the sharded runners on a mesh that spans
processes, on the CPU.

The counterparts of ``tests/test_multihost.py``: ``initialize`` leaves
``torch.distributed`` alone without arguments or launcher variables, passes
its arguments through, refuses ``nccl`` on a shared card, and
``make_pod_mesh`` deals the shards out process-major along x.  Then one run
of four processes (``gloo`` on a ``file://`` store): on 2x2 and 4x1 meshes
the one-step sharded runner and the temporal-block runner under both
``halo_impl``s, gathered on rank 0, equal the same runners on a mesh of one
process bit for bit, with a remainder: the exchange only moves values.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import pull_sharded, tblock_sharded
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    make_sharded_fused_step,
    multihost,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate

CPU = torch.device("cpu")


def _clear_cluster_env(monkeypatch):
    for v in (*multihost.CLUSTER_VARS, "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)


@pytest.fixture
def record(monkeypatch):
    """``init_process_group`` replaced by a recorder of its arguments (and
    ``barrier`` by a recorder of the call)."""
    _clear_cluster_env(monkeypatch)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "barrier", lambda: calls.append("barrier"))
    return calls


def test_initialize_noop_without_cluster(monkeypatch):
    _clear_cluster_env(monkeypatch)

    def boom(**kwargs):
        raise AssertionError("initialize() must not touch torch.distributed")

    monkeypatch.setattr(dist, "init_process_group", boom)
    multihost.initialize()


@pytest.mark.parametrize("var, value", [("MASTER_ADDR", "10.0.0.1"), ("WORLD_SIZE", "4"),
                                        ("RANK", "2")])
def test_initialize_detects_cluster_env(monkeypatch, record, var, value):
    monkeypatch.setenv(var, value)
    multihost.initialize()
    assert record == [dict(backend="gloo", init_method="env://", world_size=-1, rank=-1)]


def test_initialize_explicit_args(record):
    multihost.initialize("host0:1234", num_processes=4, process_id=2)
    multihost.initialize("file:///tmp/store", 2, 1, backend="gloo")
    assert record == [
        dict(backend="gloo", init_method="tcp://host0:1234", world_size=4, rank=2),
        dict(backend="gloo", init_method="file:///tmp/store", world_size=2, rank=1)]


def test_initialize_already_initialized(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)

    def boom(**kwargs):
        raise AssertionError("must not re-initialize")

    monkeypatch.setattr(dist, "init_process_group", boom)
    multihost.initialize()


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    return chosen


def test_nccl_is_the_default_with_a_card_per_rank(monkeypatch, record):
    chosen = _cards(monkeypatch, 4)
    multihost.initialize("file:///tmp/store", 4, 2)
    # NCCL's first operation involves every rank: a barrier
    assert record[0]["backend"] == "nccl" and record[1:] == ["barrier"] and chosen == [2]
    _cards(monkeypatch, 1)
    multihost.initialize("file:///tmp/store", 2, 1)
    assert record[-1]["backend"] == "gloo"


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch, record):
    _cards(monkeypatch, 1)
    with pytest.raises(ValueError, match="share 1 card"):
        multihost.initialize("file:///tmp/store", 2, 0, backend="nccl")
    _cards(monkeypatch, 0)
    with pytest.raises(ValueError, match="nccl"):
        multihost.initialize("file:///tmp/store", 1, 0, backend="nccl")
    assert record == []


def test_make_pod_mesh_process_major_x(monkeypatch):
    """Shards x-major, dealt out to the ranks in order: x is the
    process-major axis, so y halo rows stay within a process."""
    mesh = multihost.make_pod_mesh((2, 2), ["cpu"] * 4)
    assert mesh.ranks == ((0, 0), (0, 0)) and not mesh.spans_processes
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    mesh = multihost.make_pod_mesh((4, 2), ["cpu", "cpu"])
    assert mesh.ranks == ((0, 0), (1, 1), (2, 2), (3, 3)) and mesh.rank == 2
    assert mesh.local_shards() == [(2, 0), (2, 1)] and mesh.spans_processes
    s = shard_state(engine.init_state(SimConfig(nx=16, ny=8, mesh_shape=(4, 2)), CPU), mesh)
    assert [[b is not None for b in col] for col in s.f] == [[False] * 2, [False] * 2,
                                                            [True] * 2, [False] * 2]
    with pytest.raises(ValueError, match="4 ranks of 3 devices"):
        multihost.make_pod_mesh((4, 2), ["cpu"] * 3)


def test_one_process_paths_refuse_a_mesh_across_processes(monkeypatch, tmp_path):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    mesh = multihost.make_pod_mesh((2, 1), ["cpu"])
    cfg = SimConfig(nx=32, ny=32, mesh_shape=(2, 1), max_steps=10, report_interval=10)
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 1"):
        simulate(cfg, SimOptions(out_dir=str(tmp_path), verbose=False), device=["cpu"] * 2)
    with pytest.raises(ValueError, match="one process"):
        make_sharded_fused_step(cfg, mesh)


def _start(cfg):
    """The start state with seeded noise, the same in every process."""
    s = engine.init_state(cfg, CPU)
    noise = np.random.default_rng(0).standard_normal(tuple(s.f.shape))
    return engine.State(s.f * (1.0 + 1e-3 * torch.from_numpy(noise).float()), s.rho_lid)


def _runners(cfg):
    return {
        "pull_sharded": lambda m: pull_sharded.make_sharded_runner(cfg, 3, m),
        "tblock ppermute": lambda m: tblock_sharded.make_sharded_runner(cfg, 9, m, k_steps=4),
        "tblock rdma": lambda m: tblock_sharded.make_sharded_runner(
            cfg, 9, m, k_steps=4, halo_impl="rdma"),
    }


def _four_process_runs(rank):
    for shape in ((2, 2), (4, 1)):
        cfg = SimConfig(nx=48, ny=40, reynolds=400.0, collision="mrt", mesh_shape=shape)
        s0 = _start(cfg)
        pod = multihost.make_pod_mesh(shape, ["cpu"])
        assert pod.local_shards() == [list(pod.shards())[rank]]
        for name, make in _runners(cfg).items():
            out = unshard_state(make(pod)(shard_state(s0, pod)), CPU, pod)
            if rank != 0:
                assert out is None
                continue
            one = make_mesh(shape, ["cpu"] * 4)
            ref = unshard_state(make(one)(shard_state(s0, one)), CPU)
            assert torch.equal(out.f, ref.f), (shape, name)
            assert torch.equal(out.rho_lid, ref.rho_lid), (shape, name)
    assert halo.sends > 0 and halo.staged > 0


def test_four_processes_equal_one(tmp_path):
    multihost.spawn(_four_process_runs, 4, str(tmp_path / "store"), timeout=120)
