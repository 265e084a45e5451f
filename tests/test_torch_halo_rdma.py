"""The halo exchange (``kernels/halo_rdma.py``) and the temporal-block
sharded runner's ``halo_impl`` on the CPU.

On CPU shards an exchange runs its plain version: the whole refresh
(``halo.refresh_phases``: the y phase, the x phase with the lid panels' x
halos, the panels' copy over each column) or, for the x-only exchange, the
x phase and the panels' x halos, copied in order.  The refresh's moves in
one set (``halo.refresh_moves``, what the kernel copies in any order) are
checked against where each halo cell comes from: corners from the diagonal
shard, panels from ``iy = 0``.  The port's ``"rdma"`` runner is held to the
JAX package's ``halo_impl="rdma"`` runner in interpret mode on the JAX
test's own case (``tests/test_tblock_sharded.py``: 128x64, mesh (1, 1), K=8,
MRT float32, 8 steps) at atol 2e-5 (an independent float32
implementation), and to the port's ``"ppermute"`` runner bit for bit on
1x1, 2x1, 1x2, 4x1, 2x2 and 3x2 meshes, with and without a remainder: the
exchange only moves values.  The (2, 1) case is the counterpart of JAX's
``test_rdma_halo_multichip_traces``, which can only trace its remote path;
here it runs.  The IPC plan across processes (y and diagonal neighbours
included) and its refusals are checked on a mesh faked on the CPU.  The
kernel itself is held to the plain copies in ``test_torch_csrc_emulated.py``
and on the card in ``test_torch_cuda.py``.
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


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (4, 1), (2, 2), (1, 2), (3, 2)])
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
    """The kernel's table: an x strip of the tight carry is one run per
    plane, a y strip and a strip of the aligned carry are rows at the pitch,
    a panel strip is one run; each rectangle's first slot follows the
    slots before it."""
    lay, carries, panels = _carries((2, 1), 6, 5, 2)
    rows = halo_rdma.rect_rows(halo.move_pairs(halo_rdma.x_moves(carries, panels, lay)))
    c0, c1 = carries[0][0], carries[1][0]
    plane = c0.stride(0)
    # shard 0's west halo from shard 1's last K columns: 9 runs of K * (ly + 2K)
    assert rows[0][:9] == (c1[:, 6].data_ptr(), c0.data_ptr(), 9, 1, 2 * 9, plane, 0,
                           plane, 0)
    assert rows[-1][2:9] == (1, 1, 2, 0, 0, 0, 0)
    for before, row in zip(rows, rows[1:]):
        assert row[11] == before[11] + before[2] * before[3] * before[10]
    aligned = halo.Layout.aligned(6, 5, 2)
    wide = tuple(tuple(aligned.new(torch.empty(9, 6, 5)) for _ in range(1)) for _ in range(2))
    y_strip = halo_rdma.rect_rows(halo.move_pairs(halo.halo_moves(wide, aligned)[0]))[0]
    assert y_strip[2:9] == (9, 6, 2, wide[0][0].stride(0), aligned.pitch,
                            wide[0][0].stride(0), aligned.pitch)
    x_strip = halo_rdma.rect_rows(halo.move_pairs(halo.halo_moves(wide, aligned)[1]))[0]
    assert x_strip[2:5] == (9, 2, 5 + 2 * 2)
    with pytest.raises(ValueError, match="float32"):
        halo_rdma.rect_rows([(torch.zeros(3, dtype=torch.float64),) * 2])
    with pytest.raises(ValueError, match="a rectangle of"):
        halo_rdma.rect_rows([(torch.zeros(3), torch.zeros(4))])


@pytest.mark.parametrize("n, shift, want", [(40, 0, (1, (40 + 6) // 4)), (40, 1, (0, 40)),
                                            (9, 0, (0, 9))])
def test_rect_rows_take_float4_only_for_long_rows_of_one_phase(n, shift, want):
    """Rows of at least ``VECTOR_MIN`` floats whose source and destination
    share their 16-byte phase on every row are cut into 16-byte lines
    (``(n + 6) // 4`` slots); other rows, and every short row (a y strip, a
    corner), into floats."""
    buf = torch.zeros(1024)
    src = buf[:400].view(4, 100)[:, :n]
    dst = buf[400 + shift:800 + shift].view(4, 100)[:, :n]
    (row,) = halo_rdma.rect_rows([(dst, src)])
    assert row[9:11] == want


def test_refresh_moves_take_corners_from_the_diagonal_and_panels_from_the_lid_row():
    """On a (3, 2) mesh: each carry's corners straight from its diagonal
    neighbour's cells, its y and x strips from its axis neighbours', its
    cells untouched; each panel's x halo from the ``iy = 0`` panels of the
    neighbouring columns, its cells (``iy > 0``) from its own column's; and
    all of it the same as the phases copied in order."""
    mesh_shape, lx, ly, k = (3, 2), 7, 5, 3
    lay, carries, panels = _carries(mesh_shape, lx, ly, k)
    before = [[c.clone() for c in col] for col in carries]
    before_p = [[p.clone() for p in col] for col in panels]
    phased = [tuple(tuple(b.clone() for b in col) for col in bl) for bl in (carries, panels)]
    moves = halo.refresh_moves(carries, panels, lay)
    assert len(moves) == 8 * 6 + 2 * 6 + 3
    halo.copy_pairs(halo.move_pairs(moves[::-1]))    # any order
    for phase in halo.refresh_phases(*phased, lay):
        halo.copy_pairs(halo.move_pairs(phase))
    mx, my = mesh_shape
    spans = {-1: (slice(0, k), slice(lx, lx + k)), 0: (slice(k, k + lx), slice(k, k + lx)),
             1: (slice(k + lx, lx + 2 * k), slice(k, 2 * k))}
    y_spans = {-1: (slice(0, k), slice(ly, ly + k)), 0: (slice(k, k + ly), slice(k, k + ly)),
               1: (slice(k + ly, ly + 2 * k), slice(k, 2 * k))}
    for ix in range(mx):
        for iy in range(my):
            for sx, (xd, xs) in spans.items():
                for sy, (yd, ys) in y_spans.items():
                    src = before[(ix + sx) % mx][(iy + sy) % my]
                    assert torch.equal(carries[ix][iy][:, xd, yd], src[:, xs, ys])
                p = panels[ix][iy][xd]
                if sx or iy:
                    assert torch.equal(p, before_p[(ix + sx) % mx][0][xs])
                else:
                    assert torch.equal(p, before_p[ix][iy][xd])
            assert torch.equal(carries[ix][iy], phased[0][ix][iy])
            assert torch.equal(panels[ix][iy], phased[1][ix][iy])


def test_halo_exchange_on_cpu_shards_is_the_refresh():
    """``make_halo_exchange`` on CPU shards runs the plain refresh: the same
    as ``halo.refresh_phases`` copied in order, with and without panels."""
    for panels_too in (True, False):
        lay, carries, panels = _carries((2, 2), 6, 5, 2)
        panels = panels if panels_too else None
        want = [tuple(tuple(b.clone() for b in col) for col in bl)
                for bl in (carries, panels) if bl is not None]
        for phase in halo.refresh_phases(want[0], want[1] if panels_too else None, lay):
            halo.copy_pairs(halo.move_pairs(phase))
        halo_rdma.make_halo_exchange(_cpu_mesh((2, 2)), carries, panels, lay)()
        for got, ref in zip((carries, panels), want):
            for ix, iy in _cpu_mesh((2, 2)).shards():
                assert torch.equal(got[ix][iy], ref[ix][iy])


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


def test_ipc_plan_takes_the_y_and_diagonal_neighbours(monkeypatch):
    """(2, 2) over four ranks of one card: under the whole refresh rank 0's
    shard (0,0) writes into its y neighbour (0,1) (both y halos and, from
    the lid row, its panel), its x neighbour (1,0) and its diagonal
    neighbour (1,1) (a corner each, and their panels' x halos), all from
    card 0; and it offers its carry to the three ranks that write into it,
    its panel to the one whose shard (1,0) fills the panel's x halos."""
    mesh, carries, panels, lay = _pod(monkeypatch, (2, 2), 1, 4, 0)
    kinds = {id(carries): ("carry", carries), id(panels): ("panel", panels)}
    offers, opens = halo_rdma.ipc_plan(mesh, halo.refresh_moves(carries, panels, lay), kinds)
    assert {w: sorted(keys) for w, keys in offers.items()} == {
        1: [("carry", (0, 0))], 2: [("carry", (0, 0)), ("panel", (0, 0))],
        3: [("carry", (0, 0))]}
    assert opens == {(kind, shard): 0 for kind in ("carry", "panel")
                     for shard in ((0, 1), (1, 0), (1, 1))}


@pytest.mark.parametrize("rank", [0, 1])
def test_refresh_refuses_x_and_diagonal_neighbours_on_two_cards(monkeypatch, rank):
    """(2, 2) over two ranks of two cards: rank 0 holds (0,0) on card 0 and
    (0,1) on card 1, so rank 1's (1,0) gets its west strip from card 0 and,
    since the refresh reads corners straight from the diagonal neighbour,
    a corner from card 1.  The x-only exchange's plan takes this layout
    (one card writes each remote carry); the whole refresh refuses it on
    every rank, saying why."""
    mesh, carries, panels, lay = _pod(monkeypatch, (2, 2), 2, 2, rank)
    kinds = {id(carries): ("carry", carries), id(panels): ("panel", panels)}
    halo_rdma.ipc_plan(mesh, halo_rdma.x_moves(carries, panels, lay), kinds)
    with pytest.raises(ValueError, match="from cards .*diagonal"):
        halo_rdma.make_halo_exchange(mesh, carries, panels, lay)
