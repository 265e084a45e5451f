"""CUDA graphs of the kernel runners: a runner's chunk of N steps as one
replay on the card.

The JAX package runs every chunk of N steps inside one compiled dispatch
(``engine.make_scan_runner``'s ``lax.scan``, and the Pallas runners'
``make_scan_runner``, ``make_sweep_runner``, ``make_push_scan_runner``
and sharded runners).  On the card that dispatch becomes one launch of a
captured ``torch.cuda.CUDAGraph``: a runner captures the kernel launches
of its chunk once, over buffers it keeps for its lifetime, and each call
replays them, with no Python, ctypes or launch cost per step.

* ``plan`` splits a runner's launches into a captured body, replayed a
  whole number of times, and a remainder graph, and says which of the two
  ping-pong buffers holds the result.
* ``Graphs`` captures the plan's graphs on a side stream and replays them
  on the caller's current stream.  Each graph keeps the counts of the
  launches (and halo copies) captured in it, and every replay adds them to
  the kernel modules' counters, so a counter reads what the launches one
  by one would have counted.
* ``warm_up`` runs one launch of each of a runner's entries outside any
  capture, into scratch buffers and uncounted: it loads the kernel's
  module and sets its attributes before a capture needs them.  Runners do
  it when they are built, so a profile of their first call holds only the
  chunk's own kernels.
* ``Chunk`` holds a runner's graphs and the buffers they run over, made
  at its first call and kept for its lifetime; ``PingPong`` is the
  single-device runners' chunk: the input copied into the first of two
  buffers, the graphs replayed, the result copied out.

A capture or a replay that fails raises; nothing falls back to launching
the steps one by one.  Only a runner on one card captures: on the CPU the
runners run their plain versions step by step, and a mesh that spans
several cards or processes keeps its eager loop (``one_card``), whose
streams are ordered by events across cards and by host barriers across
processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

# The most launches of a runner in one graph.  A 2 000-step chunk, the
# report interval of ``simulate``'s default and of the Ghia gates, is one
# graph.  A longer chunk replays a body of 2 000 launches: one graph launch
# (a few us of host) per 2 000 steps costs nothing a step, while capturing
# costs about as much host time per launch as the launch itself did, and a
# graph's instantiation time and device memory grow with its nodes, so a
# 40 000-step chunk (the slow gates) captures 2 000 launches, not 40 000.
# A launch of a sharded runner is one step of every shard and its halo
# refresh: 5 nodes on a 2x2 mesh.  Even, so that the body starts every
# replay on the same buffer.
MAX_BODY = 2000

# Graph launches (replays) in this process: a chunk's dispatches, beside
# the kernel launches that the kernel modules count.
replays = 0


class Launch(NamedTuple):
    """One launch of a runner: of its K-step kernel (``block``) or of its
    one-step remainder kernel, from buffer ``src`` into buffer ``dst``."""

    block: bool
    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class Plan:
    """``blocks`` launches of a runner's K-step kernel, then ``singles`` of
    its one-step kernel, launch ``i`` reading buffer ``i % 2`` (the input
    is copied into buffer 0) and writing the other: a body of the first
    ``body`` launches replayed ``replays`` times, then the rest in one
    remainder graph."""

    blocks: int
    singles: int
    body: int
    replays: int

    @property
    def launches(self) -> int:
        return self.blocks + self.singles

    @property
    def result(self) -> int:
        """The buffer that holds the result."""
        return self.launches % 2

    def graphs(self) -> List[Tuple[List[Launch], int]]:
        """Each graph's launches and its replays per call, in order: the
        body, then the remainder."""
        out = []
        if self.replays:
            out.append((self._launches(0, self.body), self.replays))
        start = self.body * self.replays
        if start < self.launches:
            out.append((self._launches(start, self.launches), 1))
        return out

    def _launches(self, lo: int, hi: int) -> List[Launch]:
        return [Launch(i < self.blocks, i % 2, 1 - i % 2) for i in range(lo, hi)]


def plan(n_steps: int, k_steps: int = 1, max_body: Optional[int] = None) -> Plan:
    """The graphs of ``n_steps`` steps: ``n_steps // k_steps`` launches of
    ``k_steps`` steps, then the ``n_steps % k_steps`` one-step ones.  Up to
    ``max_body`` (default ``MAX_BODY``) launches in all are one graph; more
    replay a body of ``max_body`` K-step launches (even, so every replay
    starts on buffer 0) and run the rest as one remainder graph."""
    max_body = MAX_BODY if max_body is None else max_body
    if n_steps < 0 or k_steps < 1:
        raise ValueError(f"{n_steps} steps in launches of {k_steps}")
    if max_body < 2 or max_body % 2:
        raise ValueError(f"the body must be an even number of launches, not {max_body}")
    blocks, singles = divmod(n_steps, k_steps)
    if blocks + singles <= max_body:
        return Plan(blocks, singles, blocks + singles, 1 if blocks + singles else 0)
    return Plan(blocks, singles, max_body, blocks // max_body)


def _counters() -> List[Tuple[object, str]]:
    """Every count that a captured launch adds to: the kernels' launches and
    the halo copies of the sharded runners."""
    from ..parallel import halo
    from . import halo_rdma, pull, pull_sharded, push, tblock, tblock_sharded

    return [(pull, "launches"), (pull, "tangential_launches"), (pull, "sweep_launches"),
            (tblock, "launches"), (push, "launches"), (push, "west_eq_launches"),
            (push, "bounce_back_launches"), (pull_sharded, "launches"),
            (tblock_sharded, "launches"), (halo_rdma, "launches"), (halo, "copies")]


@contextlib.contextmanager
def counted_apart():
    """Leaves the counters as they were before the block, and yields the
    dict that receives what the block added to each, ``{(module,
    attribute): count}``, once the block is done."""
    before = {key: getattr(*key) for key in _counters()}
    added: Dict[Tuple[object, str], int] = {}
    try:
        yield added
    finally:
        for (module, attr), value in before.items():
            delta = getattr(module, attr) - value
            if delta:
                added[(module, attr)] = delta
            setattr(module, attr, value)


class Graphs:
    """A plan's graphs on one card, captured on a side stream by
    ``launch(one)`` for each ``Launch`` over buffers that must live as long
    as the graphs.  ``replay`` runs them all once, on the current stream,
    and adds what each captured to the counters for each of its replays.
    Each graph is captured just before its first replay, so the remainder's
    capture runs on the host while the card runs the body's replays."""

    def __init__(self, device: torch.device, plan_: Plan, launch: Callable[[Launch], None]):
        self.device = device
        self._launch = launch
        self._capture = None
        # per graph: its launches, its replays per call, and once captured
        # the graph and what its launches added to the counters
        self._graphs: List[list] = [[launches, times, None, None]
                                    for launches, times in plan_.graphs()]

    def _on_device(self):
        return torch.cuda.device(self.device)

    def _capturer(self):
        """``capture(launches, launch)``: one graph of ``launches``,
        captured on a side stream into the memory pool of these graphs
        (which allocate nothing)."""
        pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream(self.device)

        def capture(launches: List[Launch], launch) -> torch.cuda.CUDAGraph:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                try:
                    for one in launches:
                        launch(one)
                except BaseException:
                    _end_failed_capture(graph)
                    raise
                graph.capture_end()
            return graph

        return capture

    def replay(self) -> None:
        global replays
        with self._on_device():
            for entry in self._graphs:
                launches, times, graph, counts = entry
                if graph is None:
                    if self._capture is None:
                        self._capture = self._capturer()
                    with counted_apart() as counts:
                        graph = self._capture(launches, self._launch)
                    entry[2:] = graph, counts
                for _ in range(times):
                    graph.replay()
                replays += times
                for (module, attr), n in counts.items():
                    setattr(module, attr, getattr(module, attr) + n * times)
        if all(entry[2] is not None for entry in self._graphs):
            self._launch = self._capture = None


def _end_failed_capture(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture that a launch broke off, so that its stream leaves
    capture mode; the launch's error is the one raised."""
    with contextlib.suppress(RuntimeError):
        graph.capture_end()


def warm_up(launch: Callable[[Launch], None], plan_: Plan) -> None:
    """One launch of each kind the plan holds (the K-step kernel, the
    one-step one), from buffer 0 into buffer 1 of the scratch set that
    ``launch`` writes, outside any capture and uncounted."""
    kinds = [True] * bool(plan_.blocks) + [False] * bool(plan_.singles)
    with counted_apart():
        for block in kinds:
            launch(Launch(block, 0, 1))


def one_card(devices: Sequence[torch.device], spans_processes: bool = False
             ) -> Optional[torch.device]:
    """The card a runner over ``devices`` captures on: the one CUDA device
    they all are, in a runner of one process.  None (the runner keeps its
    eager loop) for the CPU, for several cards, and across processes."""
    found = set(devices)
    if spans_processes or len(found) != 1:
        return None
    (device,) = found
    return device if device.type == "cuda" else None


class Chunk:
    """A runner's graphs on one card and the buffers they run over.
    ``build(alloc)`` makes a set of buffers (``alloc(shape)``: a float32
    tensor on the card) and returns it with ``launch(one)``, which issues
    one ``Launch`` of the plan over that set on the current stream.

    Built, it warms the kernels up on a scratch set, which it then drops.
    ``buffers`` is the set the graphs run over, made and captured over at
    its first use and held, with the graphs, for the chunk's lifetime;
    ``replay`` runs the graphs once."""

    def __init__(self, device: torch.device, plan_: Plan,
                 build: Callable[[Callable[[tuple], torch.Tensor]], tuple]):
        self.device, self.plan, self._build = device, plan_, build
        self._bufs = None
        self._graphs: Optional[Graphs] = None
        _, launch = build(self._alloc(torch.zeros))
        warm_up(launch, plan_)

    def _alloc(self, make):
        return lambda shape: make(shape, dtype=torch.float32, device=self.device)

    @property
    def buffers(self):
        if self._graphs is None:
            bufs, launch = self._build(self._alloc(torch.empty))
            self._graphs = Graphs(self.device, self.plan, launch)
            self._bufs = bufs
        return self._bufs

    def replay(self) -> None:
        self._graphs.replay()


class PingPong(Chunk):
    """The chunk of a single-device runner: two buffers, each one float32
    tensor of each of ``shapes``; ``launch(one, bufs)`` issues one launch
    from ``bufs[one.src]`` into ``bufs[one.dst]``.  A call copies its
    inputs into buffer 0, replays, and returns a copy of the result's
    buffer, so the inputs are never written and no later call overwrites
    what it returned."""

    def __init__(self, device: torch.device, shapes: Sequence[tuple], plan_: Plan,
                 launch: Callable[[Launch, list], None]):
        def build(alloc):
            bufs = [tuple(alloc(shape) for shape in shapes) for _ in range(2)]
            return bufs, lambda one: launch(one, bufs)

        super().__init__(device, plan_, build)

    def __call__(self, inputs: Sequence[torch.Tensor]) -> tuple:
        bufs = self.buffers
        for buf, x in zip(bufs[0], inputs):
            buf.copy_(x)
        self.replay()
        return tuple(buf.clone() for buf in bufs[self.plan.result])
