"""The x-ring halo exchange (``kernels/halo_rdma.py``) and the temporal-block
sharded runner's ``halo_impl`` on the CPU.

On CPU shards the exchange runs its plain version: the x phase of the
two-phase exchange and the lid panel's x halo, copied in order.  The port's
``"rdma"`` runner is held to the JAX package's ``halo_impl="rdma"`` runner
in interpret mode on the JAX test's own case (``tests/test_tblock_sharded.py``:
128x64, mesh (1, 1), K=8, MRT float32, 8 steps) at atol 2e-5 (an
independent float32 implementation), and to the port's ``"ppermute"``
runner bit for bit on 1x1, 2x1, 4x1 and 2x2 meshes, with and without a
remainder: the exchange only moves values.  The (2, 1) case is the
counterpart of JAX's ``test_rdma_halo_multichip_traces``, which can only
trace its remote path; here it runs.  The kernel itself is held to the
plain copies in ``test_torch_csrc_emulated.py`` and on the card in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.kernels import halo_rdma, tblock_sharded
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    multihost,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_torch.parallel.mesh import local_blocks
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu import parallel as j_par
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels.pallas_pull_tblock_sharded import (
    make_sharded_tblock_runner,
)

CPU = torch.device("cpu")


def _cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def test_rdma_runner_matches_pallas_interpret():
    base = dict(nx=128, ny=64, reynolds=400.0, collision="mrt", precision="float32",
                mesh_shape=(1, 1))
    jc, tc = JConfig(**base), TConfig(**base)
    j_mesh = j_par.make_mesh((1, 1))
    j_out = make_sharded_tblock_runner(jc, 8, j_mesh, k_steps=8, interpret=True,
                                       halo_impl="rdma")(
        j_par.shard_state(j_eng.init_state(jc), j_mesh))
    mesh = _cpu_mesh((1, 1))
    runner = tblock_sharded.make_sharded_runner(tc, 8, mesh, k_steps=8, halo_impl="rdma")
    out = unshard_state(runner(shard_state(t_eng.init_state(tc, CPU), mesh)), CPU)
    np.testing.assert_allclose(out.f.numpy(), np.asarray(j_out.f), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out.rho_lid.numpy(), np.asarray(j_out.rho_lid),
                               rtol=0, atol=2e-5)


def _noisy_start(cfg):
    s = t_eng.init_state(cfg, CPU)
    noise = np.random.default_rng(0).standard_normal(tuple(s.f.shape))
    return t_eng.State(s.f * (1.0 + 1e-3 * torch.from_numpy(noise).float()), s.rho_lid)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("n", [8, 11])     # two blocks of K=4; and a remainder
def test_rdma_runner_equals_ppermute(mesh_shape, n):
    cfg = TConfig(nx=48, ny=40, reynolds=400.0, collision="mrt", mesh_shape=mesh_shape)
    mesh = _cpu_mesh(mesh_shape)
    s0 = shard_state(_noisy_start(cfg), mesh)
    outs = [unshard_state(tblock_sharded.make_sharded_runner(
        cfg, n, mesh, k_steps=4, halo_impl=impl)(s0), CPU) for impl in ("ppermute", "rdma")]
    assert torch.equal(outs[0].f, outs[1].f)
    assert torch.equal(outs[0].rho_lid, outs[1].rho_lid)


def _carries(mesh_shape, lx, ly, k, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lay = halo.Layout.tight(lx, ly, k)
    mx, my = mesh_shape
    carries = tuple(tuple(torch.randn(9, lx + 2 * k, ly + 2 * k, generator=gen)
                          for _ in range(my)) for _ in range(mx))
    panels = tuple(tuple(torch.randn(lx + 2 * k, generator=gen) for _ in range(my))
                   for _ in range(mx))
    return lay, carries, panels


@pytest.mark.parametrize("mesh_shape", [(1, 1), (3, 2), (2, 1)])
def test_exchange_fills_the_x_halos_from_the_ring(mesh_shape):
    """The exchange on CPU shards writes each shard's west halo from its x
    predecessor's last K columns and its east halo from its successor's
    first K (full ring height, corners included; the panel alike), and
    nothing else."""
    lx, ly, k = 7, 5, 3
    mesh = _cpu_mesh(mesh_shape)
    lay, carries, panels = _carries(mesh_shape, lx, ly, k)
    before = [[c.clone() for c in col] for col in carries]
    before_p = [[p.clone() for p in col] for col in panels]
    halo_rdma.make_x_halo_exchange(mesh, carries, panels, lay)()
    mx, my = mesh_shape
    for ix in range(mx):
        for iy in range(my):
            c, p = carries[ix][iy], panels[ix][iy]
            west, east = before[(ix - 1) % mx][iy], before[(ix + 1) % mx][iy]
            assert torch.equal(c[:, :k], west[:, lx:lx + k])
            assert torch.equal(c[:, k + lx:], east[:, k:2 * k])
            assert torch.equal(c[:, k:k + lx], before[ix][iy][:, k:k + lx])
            assert torch.equal(p[:k], before_p[(ix - 1) % mx][iy][lx:lx + k])
            assert torch.equal(p[k + lx:], before_p[(ix + 1) % mx][iy][k:2 * k])
            assert torch.equal(p[k:k + lx], before_p[ix][iy][k:k + lx])


def test_strip_rows_describe_one_run_per_plane():
    lay, carries, panels = _carries((2, 1), 6, 5, 2)
    rows = halo_rdma.strip_rows(halo.move_pairs(halo_rdma.x_moves(carries, panels, lay)))
    c0, c1 = carries[0][0], carries[1][0]
    plane = c0.stride(0)
    # shard 0's west halo from shard 1's last K columns: 9 runs of K * (ly + 2K)
    assert rows[0] == (c1[:, 6].data_ptr(), c0.data_ptr(), 9, plane, plane, 2 * 9)
    assert rows[-1][2:] == (1, 0, 0, 2)
    aligned = halo.Layout.aligned(6, 5, 2)
    wide = tuple(tuple(aligned.new(torch.empty(9, 6, 5)) for _ in range(1)) for _ in range(2))
    with pytest.raises(ValueError, match="one contiguous run per plane"):
        halo_rdma.strip_rows(halo.move_pairs(halo.halo_moves(wide, aligned)[1]))
    with pytest.raises(ValueError, match="float32"):
        halo_rdma.strip_rows([(torch.zeros(3, dtype=torch.float64),) * 2])


def test_rdma_halo_rejects_unknown_impl():
    cfg = TConfig(nx=128, ny=64, mesh_shape=(1, 1))
    with pytest.raises(ValueError, match="halo_impl"):
        tblock_sharded.make_sharded_runner(cfg, 8, _cpu_mesh((1, 1)), halo_impl="nope")


def _pod(monkeypatch, shape, cards, world, rank):
    """A mesh of ``world`` ranks with ``cards`` CUDA devices each, as rank
    ``rank`` sees it, with the carries and panels it holds (on the CPU:
    the IPC plan reads only the mesh)."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    mesh = multihost.make_pod_mesh(shape, [f"cuda:{i}" for i in range(cards)])
    lay = halo.Layout.tight(8, 8, 2)
    carries = local_blocks(mesh, lambda ix, iy: torch.zeros(9, 12, 12))
    panels = local_blocks(mesh, lambda ix, iy: torch.zeros(12))
    return mesh, carries, panels, lay


def test_ipc_plan_offers_and_opens_on_the_writing_card(monkeypatch):
    """(4, 1) over two ranks of two cards: rank 0 holds (0,0) on card 0 and
    (1,0) on card 1.  It offers its carries and panels to rank 1, which
    writes their x halos, and opens rank 1's on the card that writes them:
    (2,0)'s west halo from (1,0) on card 1, (3,0)'s east halo (the wrap)
    from (0,0) on card 0."""
    mesh, carries, panels, lay = _pod(monkeypatch, (4, 1), 2, 2, 0)
    kinds = {id(carries): ("carry", carries), id(panels): ("panel", panels)}
    offers, opens = halo_rdma.ipc_plan(mesh, halo_rdma.x_moves(carries, panels, lay), kinds)
    assert {w: sorted(keys) for w, keys in offers.items()} == {
        1: [("carry", (0, 0)), ("carry", (1, 0)), ("panel", (0, 0)), ("panel", (1, 0))]}
    assert opens == {("carry", (2, 0)): 1, ("panel", (2, 0)): 1,
                     ("carry", (3, 0)): 0, ("panel", (3, 0)): 0}


@pytest.mark.parametrize("rank", [0, 1])
def test_exchange_refuses_two_cards_writing_one_remote_carry(monkeypatch, rank):
    """(3, 2) over two ranks of three cards: rank 0 holds (0,0) on card 0,
    (0,1) on card 1 and (1,0) on card 2, so rank 1's (2,0) gets its west
    halo from card 2 and its east halo from card 0 of rank 0.  One IPC
    mapping cannot serve both cards: every rank refuses the layout before
    any handle moves (a card writing through another card's mapping
    faults)."""
    mesh, carries, panels, lay = _pod(monkeypatch, (3, 2), 3, 2, rank)
    assert mesh.device(0, 0).index == 0 and mesh.device(1, 0).index == 2
    with pytest.raises(ValueError, match="from cards"):
        halo_rdma.make_x_halo_exchange(mesh, carries, panels, lay)
