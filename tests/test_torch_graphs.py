"""The CUDA-graph runners (``kernels/graphs.py``) on the CPU.

* The plan: the launches its graphs issue, replayed as planned, are the
  eager loop's in the same order, and the result lies in the buffer the
  eager loop ends on.
* The rule that only a runner of one process on one card captures.
* The graphed runners' own logic (buffers kept, input copied in, result
  copied out, the counters' hook), on the CPU with a stand-in for the
  capture that records the launches and runs them again at each replay:
  the single-device chunk on a toy launch, and both sharded runners on a
  mesh of the CPU through their plain versions, bit for bit against the
  eager runners.
* Every runner on ``device="cpu"`` against the JAX package's fused scan
  runner (its push oracle, its fused step with omega as an argument) on the
  same seeded numpy input over 20 steps: float32 to atol 2e-5 (an
  independent float32 implementation), float64 to 1e-12 for the plain
  runners that take it; so the graphs left the CPU path as it was.  (The
  module tests hold the same runners to the JAX package's Pallas kernels in
  interpret mode.)

The captured graphs themselves run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them to the eager
form bit for bit there.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine as t_eng
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.convert import state_from_numpy, state_to_numpy
from latticeboltzmannsimulations_torch.kernels import (
    graphs,
    halo_rdma,
    pull,
    pull_sharded,
    push,
    tblock,
    tblock_sharded,
)
from latticeboltzmannsimulations_torch.parallel import halo, make_mesh, shard_state, unshard_state
from latticeboltzmannsimulations_torch.parallel.mesh import Mesh
from latticeboltzmannsimulations_tpu import engine as j_eng
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig

CPU = torch.device("cpu")
STEPS = 20
TOL = {"float32": 2e-5, "float64": 1e-12}
G = graphs.MAX_BODY


def _eager_launches(n_steps, k_steps):
    """The eager loop's launches: the K-step blocks, then the one-step
    remainder, each from the buffer the one before wrote (the input is
    buffer 0)."""
    blocks, singles = divmod(n_steps, k_steps)
    return [graphs.Launch(i < blocks, i % 2, 1 - i % 2) for i in range(blocks + singles)]


@pytest.mark.parametrize("k_steps", [1, 5, 8])
@pytest.mark.parametrize("n_steps", [0, 1, 2, 7, G, G + 1, 3 * G + 7])
def test_plan_issues_the_eager_launches(n_steps, k_steps):
    """Scaled by K, so that the body is filled with K-step launches: the
    replayed graphs issue the eager launches in order, no graph holds more
    than ``MAX_BODY`` launches (the remainder at most K - 1 more), a body
    replayed more than once is even, and the result buffer is the last
    launch's destination (the input's, 0, for no launch)."""
    n = n_steps * k_steps if n_steps >= G else n_steps
    p = graphs.plan(n, k_steps)
    issued = [one for launches, replays in p.graphs() for _ in range(replays)
              for one in launches]
    assert issued == _eager_launches(n, k_steps)
    assert p.launches == len(issued)
    assert all(len(launches) <= G + k_steps - 1 for launches, _ in p.graphs())
    body = p.graphs()[0] if p.graphs() else ([], 0)
    assert body[1] == 1 or len(body[0]) % 2 == 0
    assert p.result == (issued[-1].dst if issued else 0)
    assert len(p.graphs()) <= 2


@pytest.mark.parametrize("n_steps, k_steps, body", [(9, 1, 4), (23, 5, 2), (11, 5, 2)])
def test_plan_with_a_small_body(n_steps, k_steps, body):
    """A body of a few launches replayed several times, then the rest
    (K-step launches and the remainder) in one graph."""
    p = graphs.plan(n_steps, k_steps, max_body=body)
    issued = [one for launches, replays in p.graphs() for _ in range(replays)
              for one in launches]
    assert issued == _eager_launches(n_steps, k_steps)
    assert p.graphs()[0][1] == n_steps // k_steps // body
    assert p.result == issued[-1].dst


def test_plan_refuses_an_odd_body():
    with pytest.raises(ValueError, match="even"):
        graphs.plan(10, 1, max_body=3)


def test_only_one_card_of_one_process_captures():
    """The explicit rule: a mesh of several cards or processes, and the
    CPU, keep the eager loop."""
    card = torch.device("cuda", 0)
    assert graphs.one_card([card] * 4) == card
    assert graphs.one_card([card]) == card
    assert graphs.one_card([card, torch.device("cuda", 1)]) is None
    assert graphs.one_card([card] * 2, spans_processes=True) is None
    assert graphs.one_card([CPU] * 4) is None
    mesh = make_mesh((2, 2), ["cuda:0"] * 4)
    assert graphs.one_card([mesh.device(*s) for s in mesh.local_shards()],
                           mesh.spans_processes) == card
    across = Mesh((2, 1), ((card,), (card,)), ranks=((0,), (1,)), rank=0)
    assert graphs.one_card([across.device(*s) for s in across.local_shards()],
                           across.spans_processes) is None


class _Recorded(graphs.Graphs):
    """The graphs' bookkeeping with the capture replaced, for the CPU: a
    graph records its launches, running them once (the capture comes just
    before a graph's first replay, which that run stands for), and every
    later replay runs them again, its counts left to the bookkeeping, as a
    replay on the card runs no Python."""

    def _on_device(self):
        return contextlib.nullcontext()

    def _capturer(self):
        def capture(launches, launch):
            for one in launches:
                launch(one)

            class Graph:
                captured = True

                def replay(self):
                    if self.captured:
                        self.captured = False
                        return
                    with graphs.counted_apart():
                        for one in launches:
                            launch(one)

            return Graph()

        return capture


@pytest.fixture
def recorded(monkeypatch):
    """The graphed path on the CPU: the stand-in capture, and the CPU as
    the card of a runner of one process."""
    monkeypatch.setattr(graphs, "Graphs", _Recorded)
    monkeypatch.setattr(graphs, "one_card", lambda devices, spans_processes=False:
                        CPU if set(devices) == {CPU} and not spans_processes else None)


@pytest.mark.parametrize("n_steps", [1, 2, 7, 12])
def test_ping_pong_copies_in_replays_and_copies_out(recorded, n_steps):
    """A toy runner (each launch doubles one buffer into the other, adds
    its kind, and counts as a ``pull_step`` launch) with a body of 4: equal
    to applying the launches in turn, its input untouched, its result not
    overwritten by the next call, the counter at one per launch per call."""
    def launch(one, bufs):
        bufs[one.dst][0].copy_(2 * bufs[one.src][0] + one.block)
        pull.launches += 1

    plan = graphs.plan(n_steps, 3, max_body=4)
    before = pull.launches
    chunk = graphs.PingPong(CPU, [(2, 3)], plan, launch)
    assert pull.launches == before            # the warm-up is not counted
    x = torch.arange(6.0).reshape(2, 3)
    x0 = x.clone()
    (out,) = chunk((x,))
    want = x0.clone()
    for one in _eager_launches(n_steps, 3):
        want = 2 * want + one.block
    assert torch.equal(out, want) and torch.equal(x, x0)
    assert pull.launches - before == plan.launches
    first = out.clone()
    (again,) = chunk((out,))
    assert torch.equal(out, first) and not torch.equal(again, first)
    assert pull.launches - before == 2 * plan.launches


def _counts():
    return (pull_sharded.launches, tblock_sharded.launches, halo_rdma.launches,
            halo.copies)


def _noisy_sharded(cfg, mesh, seed=3):
    s = t_eng.init_state(cfg, CPU)
    rng = np.random.default_rng(seed)
    f = s.f * (1.0 + 1e-3 * torch.from_numpy(rng.standard_normal(tuple(s.f.shape))).float())
    return shard_state(t_eng.State(f, s.rho_lid), mesh)


@pytest.mark.parametrize("module, kw, n_steps", [
    (pull_sharded, {}, 3),
    (pull_sharded, {}, 6),
    (tblock_sharded, dict(halo_impl="rdma", k_steps=2), 7),
    (tblock_sharded, dict(halo_impl="ppermute", k_steps=2), 8),
], ids=["pull_odd", "pull_even", "tblock_rdma_rem", "tblock_ppermute"])
def test_sharded_runners_graphed_equal_eager(recorded, module, kw, n_steps):
    """The graphed sharded runner on a 2x2 mesh of the CPU (its shards
    through the plain versions) against the eager one: bit for bit, the
    input untouched, the returned state unchanged by a second call, the
    launches equal; the copies too, but for the one-step runner's lid
    densities, which it copies out of the rows it keeps (one per shard)."""
    cfg = TConfig(nx=24, ny=20, reynolds=400.0, collision="mrt", mesh_shape=(2, 2))
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    s0 = _noisy_sharded(cfg, mesh)
    f0 = [b.clone() for col in s0.f for b in col]
    c0 = _counts()
    want = unshard_state(module._eager_sharded_runner(cfg, n_steps, mesh, **kw)(s0), CPU)
    c1 = _counts()
    runner = module.make_sharded_runner(cfg, n_steps, mesh, **kw)
    c2 = _counts()
    out = runner(s0)
    c3 = _counts()
    got = unshard_state(out, CPU)
    assert torch.equal(got.f, want.f) and torch.equal(got.rho_lid, want.rho_lid)
    assert all(torch.equal(a, b) for a, b in zip((b for col in s0.f for b in col), f0))
    assert c2 == c1                           # building warms up, uncounted
    eager = [b - a for a, b in zip(c0, c1)]
    graphed = [b - a for a, b in zip(c2, c3)]
    rows_out = 4 if module is pull_sharded or n_steps % kw["k_steps"] else 0
    assert graphed[:3] == eager[:3] and graphed[3] == eager[3] + rows_out
    kept = unshard_state(out, CPU)
    runner(out)
    after = unshard_state(out, CPU)
    assert torch.equal(kept.f, after.f) and torch.equal(kept.rho_lid, after.rho_lid)


def _jax_start(jc, seed=0):
    """The JAX start state with seeded noise, as numpy arrays."""
    s = j_eng.init_state(jc)
    f = np.asarray(s.f)
    rng = np.random.default_rng(seed)
    return ((f * (1.0 + 1e-3 * rng.standard_normal(f.shape))).astype(f.dtype),
            np.asarray(s.rho_lid))


def _close(got, want, precision):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=TOL[precision])


BASE = dict(nx=32, ny=24, reynolds=400.0, collision="mrt")
MESH = (2, 2)


@pytest.fixture(scope="module")
def fused_reference():
    """20 steps of the JAX package's fused scan runner (the trajectory of
    every pull-scheme runner) from a seeded state, per precision."""
    out = {}
    for precision in ("float32", "float64"):
        jc = JConfig(**BASE, precision=precision)
        f0, lid0 = _jax_start(jc)
        want = jax.jit(j_eng.make_scan_runner(jc, STEPS))(j_eng.State(f0, lid0))
        out[precision] = ((f0, lid0), (np.asarray(want.f), np.asarray(want.rho_lid)))
    return out


def _sharded(run, cfg, start):
    mesh = make_mesh(MESH, ["cpu"] * 4)
    return unshard_state(run(cfg, mesh)(shard_state(state_from_numpy(*start, CPU), mesh)), CPU)


# Each port runner on the CPU: (precision, run(cfg, start) -> State).
RUNNERS = {
    "pull": ("float32", lambda cfg, start: pull.make_scan_runner(cfg, STEPS, CPU)(
        state_from_numpy(*start, CPU))),
    # K=8: two blocks, then four one-step launches
    "tblock": ("float32", lambda cfg, start: tblock.make_scan_runner(
        cfg, STEPS, CPU, k_steps=8)(state_from_numpy(*start, CPU))),
    "pull_sharded": ("float32", lambda cfg, start: _sharded(
        lambda c, m: pull_sharded.make_sharded_runner(c, STEPS, m), cfg, start)),
    # K=3 (of the 16x12 shards): six blocks and two remainder steps, each
    # refresh in both transports
    "tblock_sharded_rdma": ("float32", lambda cfg, start: _sharded(
        lambda c, m: tblock_sharded.make_sharded_runner(c, STEPS, m, 3, "rdma"), cfg, start)),
    "tblock_sharded_ppermute": ("float32", lambda cfg, start: _sharded(
        lambda c, m: tblock_sharded.make_sharded_runner(c, STEPS, m, 3), cfg, start)),
    # the plain runners that the float64 routes take (``torch``, ``sharded``)
    "engine": ("float64", lambda cfg, start: t_eng.make_scan_runner(cfg, STEPS, CPU)(
        state_from_numpy(*start, CPU))),
    "sharded_engine": ("float64", lambda cfg, start: _sharded(
        lambda c, m: halo.make_sharded_scan_runner(c, STEPS, m), cfg, start)),
}


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_on_cpu_matches_the_jax_runner(fused_reference, name):
    precision, run = RUNNERS[name]
    mesh_shape = MESH if "sharded" in name else (1, 1)
    cfg = TConfig(**BASE, precision=precision, mesh_shape=mesh_shape)
    start, want = fused_reference[precision]
    _close(state_to_numpy(run(cfg, start)), want, precision)


def test_sweep_runners_on_cpu_match_the_jax_step():
    """The stacked sweep (three cavities, each its own omega) and the
    one-cavity form with omega as an argument, against 20 steps of the JAX
    package's fused step with omega as an argument, per cavity."""
    kw = dict(BASE, collision="srt", turbulence="smagorinsky", reynolds=2000.0)
    jc, tc = JConfig(**kw), TConfig(**kw)
    f0, lid0 = _jax_start(jc)
    omegas = np.array([1.2, 1.5, 1.8])
    step = jax.jit(j_eng.make_fused_step_omega(jc))
    want = []
    for om in omegas:
        s = j_eng.State(f0, lid0)
        for _ in range(STEPS):
            s = step(s, np.float32(om))
        want.append((np.asarray(s.f), np.asarray(s.rho_lid)))
    stack = state_from_numpy(np.concatenate([f0] * 3, axis=1), np.concatenate([lid0] * 3), CPU)
    got = pull.make_sweep_runner(tc, 3, STEPS, CPU)(stack, omegas)
    for c, (f, lid) in enumerate(want):
        x = slice(c * tc.nx, (c + 1) * tc.nx)
        _close([got.f[:, x], got.rho_lid[x]], [f, lid], "float32")
    got = pull.make_scan_runner_omega(tc, STEPS, CPU)(state_from_numpy(f0, lid0, CPU),
                                                      omegas[1])
    _close(state_to_numpy(got), want[1], "float32")


def test_push_runners_on_cpu_match_the_jax_step():
    """The push runner and its ``State`` form (the lid density slot the
    placeholder ``f[0, :, 0]``) against 20 steps of the JAX package's push
    oracle."""
    jc, tc = JConfig(**BASE), TConfig(**BASE)
    f0, lid0 = _jax_start(jc)
    step = jax.jit(j_eng.make_push_oracle_step(jc))
    want = f0
    for _ in range(STEPS):
        want = step(want)
    want = np.asarray(want)
    got = push.make_push_scan_runner(tc, STEPS, CPU)(torch.from_numpy(f0))
    _close([got], [want], "float32")
    state = push.make_scan_runner(tc, STEPS, CPU)(state_from_numpy(f0, lid0, CPU))
    _close([state.f, state.rho_lid], [want, want[0, :, 0]], "float32")
