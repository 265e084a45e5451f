"""High-level simulation driver: the time loop with per-interval metrics,
convergence, mass correction, Ghia gating and backend selection, as the JAX
package's ``sim.py`` runs it, on one device or on a mesh of them.

Backends:

* ``"cuda-pull"`` — the one-step CUDA kernel (``kernels/pull.py``), one
  launch per step.  ``backend="auto"`` picks it on a CUDA device for a
  float32 NEBB configuration below ``TBLOCK_AUTO_MIN_CELLS``, and for a
  float32 tangential lid (``boundary="nebb_tangential"``) at every size.
* ``"cuda-tblock"`` — the temporal-block CUDA kernel (``kernels/tblock.py``),
  ``K`` steps per launch.  ``"auto"`` picks it for float32 NEBB fields of
  at least ``TBLOCK_AUTO_MIN_CELLS`` cells without Van Driest damping.
* ``"cuda-push"`` — the push CUDA kernel (``kernels/push.py``), on the plain
  pre-collision field.  ``"auto"`` picks it on a CUDA device for the
  float32 ``bounce_back`` and ``nebb_west_eq`` walls without Van Driest
  damping; for NEBB only when asked for, as the JAX driver's
  ``pallas-push``.
* ``"push-oracle"`` — the plain push engine (``engine.make_push_oracle_step``),
  for the ``bounce_back`` and ``nebb_west_eq`` walls where the push kernel
  does not serve them: on the CPU, in float64, with Van Driest damping.
* ``"torch"`` — the plain fused engine (``engine.py``), for what the kernels
  do not take (float64), and on the CPU.

With a mesh (``cfg.mesh_shape`` larger than ``(1, 1)``, or one of these
backends asked for) the lattice is split over the mesh's devices
(``parallel/``) and one of the sharded engines runs it:

* ``"cuda-sharded"`` — the one-step sharded CUDA kernel
  (``kernels/pull_sharded.py``), a halo exchange and one launch per shard per
  step.  ``"auto"`` picks it for float32 NEBB on a mesh of CUDA devices.
* ``"cuda-sharded-tblock"`` — the sharded temporal-block CUDA kernel
  (``kernels/tblock_sharded.py``), one exchange and one launch per shard per
  ``K`` steps, the exchange one launch per card of the exchange kernel
  (``SHARDED_TBLOCK_HALO_IMPL``).  ``"auto"`` picks it for shards of at
  least ``SHARDED_TBLOCK_AUTO_MIN_CELLS`` cells (None: never).
* ``"sharded"`` — the plain sharded engine (``parallel/halo.py``), for the
  rest (float64, a mesh on the CPU).

``device`` is one device, or with a mesh a sequence of ``mx * my`` devices
(which may repeat one); the default ``"cuda"`` with a mesh takes the first
``mx * my`` cards and raises with fewer.  A run is one process: inside a
``torch.distributed`` group of several (``parallel.multihost``) it is
refused, as the JAX package's ``simulate`` has no multi-process path; drive
a mesh that spans processes with ``kernels.pull_sharded`` or
``kernels.tblock_sharded`` (ROADMAP.md queue 1 item 1).  The walls other
than NEBB and the single-device backends refuse a mesh.

An explicit kernel backend that cannot serve a configuration, or that is
asked for off the card, raises rather than run something else under its
name.

``SimOptions.checkpoint_every`` writes checkpoints of the global state
(``io.checkpoint``, the JAX package's format) and arms a one-shot restore of
the last good one after a blow-up; ``resume_from`` continues a run from a
checkpoint, on any backend (a mesh shards the loaded state).  Every
interval, after the checkpoint and in the JAX driver's order,
``save_plots`` renders the dashboard (``viz.dashboard``) and ``save_vtk``
writes a ``.vtr`` snapshot (``io.vtk.save_to_vtk``), both from the host
fields the interval fetched (on a mesh, the gathered global fields), the
density rescaled by the mass correction.  ``profile_dir`` writes a
``torch.profiler`` Chrome trace of the first chunk, ``trace.json``, with the
card's kernels when the run is on the card; the chunk's steps and time count
in the run's MLUPS, as the JAX driver's do, but the profiler's own start,
stop and export do not (its first start in a process initialises the
card's tracing, seconds against a chunk's milliseconds).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from . import engine, viz
from .config import SimConfig, resolve_device
from .io.checkpoint import Checkpointer, load_checkpoint
from .io.metrics import MetricsLogger, mlups
from .io.vtk import save_to_vtk
from .kernels import pull, pull_sharded, push, tblock, tblock_sharded
from .parallel import halo
from .parallel.mesh import Mesh, make_mesh
from .validate import compare_to_ghia
from .validate.ghia_data import has_reynolds


@dataclasses.dataclass
class SimOptions:
    """Output & runtime switches (reference knobs ``MRT.py:33-38``)."""

    out_dir: str = "output"
    project: str = "ldc"
    save_plots: bool = False
    save_vtk: bool = False
    metrics_jsonl: bool = True
    checkpoint_every: int = 0     # steps; 0 = off
    resume_from: Optional[str] = None
    # 'auto' | 'cuda-pull' | 'cuda-tblock' | 'cuda-push' | 'push-oracle' |
    # 'torch' | 'cuda-sharded' | 'cuda-sharded-tblock' | 'sharded'
    backend: str = "auto"
    verbose: bool = True
    # The wet-node corner treatment (faithful to the reference kernels) leaks
    # a little mass each step — negligible over the reference's 3000-step
    # runs but a ~5%/10M-step density drift that biases long validation runs.
    # This rescales f to the initial mean density every report interval
    # (velocity is invariant under a uniform rescale of f).
    mass_correction: bool = True
    # Write a torch.profiler Chrome trace of the first compute chunk here
    # (trace.json; chrome://tracing or Perfetto); None = off.
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class SimSummary:
    steps: int
    converged: bool
    elapsed_s: float
    mlups: float
    r2_ux: Optional[float]
    l2_combined: Optional[float]
    out_dir: str
    backend: str
    r2_uy: Optional[float]


# The name of the profiled chunk's span in the trace.
CHUNK_SPAN = "simulate.chunk"


# Fields of at least this many cells take the temporal-block kernel under
# backend="auto" (float32 NEBB without Van Driest, on the card); None: never.
# Set from chip_smoke.py's timing of cuda-tblock against cuda-pull in turns
# in one call on one H100 (PERF.md, section 6): ahead by more than its
# margin from rest and further on at 2048^2 and 4096^2, behind from rest at
# 1024^2.
TBLOCK_AUTO_MIN_CELLS: Optional[int] = 2048 * 2048

# Meshes whose shards hold at least this many cells take the sharded
# temporal-block kernel under backend="auto" (float32 NEBB without Van
# Driest, on CUDA devices); None: never.  Keyed to the shard, as the JAX
# driver's gate is.  Set only where chip_smoke.py counts it ahead of
# cuda-sharded by more than its margin in every reading (the runners from
# rest and further on, and simulate in alternating order): at 4096^2 on a
# 2x2 mesh of one H100, the one size measured (shards of 2048^2; PERF.md,
# section 6).
SHARDED_TBLOCK_AUTO_MIN_CELLS: Optional[int] = 2048 * 2048

# The transport of cuda-sharded-tblock's halo refresh (a mesh of CUDA devices
# in one process): "rdma", the exchange kernel's one launch per card, where
# chip_smoke.py counts that runner ahead of the strip copies ("ppermute") in
# every reading of the runners at 4096^2 and 128^2 on a 2x2 mesh of one H100,
# from rest and further on, and of simulate at 128^2 (PERF.md, section 6).
# The two give the same bits.
SHARDED_TBLOCK_HALO_IMPL = "rdma"

BACKENDS = ("auto", "cuda-pull", "cuda-tblock", "cuda-push", "push-oracle", "torch",
            "cuda-sharded", "cuda-sharded-tblock", "sharded")
_SHARDED = ("cuda-sharded", "cuda-sharded-tblock", "sharded")
# Walls that only the push engines (the push kernel and its oracle) implement.
_PUSH_ONLY = ("bounce_back", "nebb_west_eq")


def _same(state):
    return state


class Backend(NamedTuple):
    """A routed backend: its name, a factory of ``n``-step runners on its
    state, ``observe(cfg, state) -> (rho, u)`` of its state, and ``prep``,
    which turns an ``engine.State`` into its state (the sharding onto the
    mesh; the identity on one device)."""

    name: str
    make_runner: Callable[[int], Callable]
    observe: Callable
    prep: Callable = _same


Placement = Union[torch.device, Mesh]


def _placement(cfg: SimConfig, device) -> Placement:
    """Where a run goes: one resolved device, or with a mesh the ``Mesh`` of
    its devices (the default ``"cuda"`` takes the first ``mx * my``
    cards).  Refused in a process group of several processes."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError(
            "simulate runs in one process; a mesh that spans the processes of a "
            "group runs through kernels.pull_sharded or kernels.tblock_sharded "
            "(ROADMAP.md queue 1 item 1)")
    if isinstance(device, (str, torch.device)):
        if tuple(cfg.mesh_shape) == (1, 1):
            return resolve_device(device)
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            return make_mesh(cfg.mesh_shape)
        raise ValueError(
            f"mesh {cfg.mesh_shape} needs {cfg.mesh_shape[0] * cfg.mesh_shape[1]} "
            f"devices; pass a sequence of them, not the one device {d}")
    devices: Sequence = list(device)
    if tuple(cfg.mesh_shape) == (1, 1) and len(devices) == 1:
        return resolve_device(devices[0])
    return make_mesh(cfg.mesh_shape, devices)


def _first_device(where: Placement) -> torch.device:
    return where.first_device if isinstance(where, Mesh) else where


def _select_sharded(cfg: SimConfig, backend: str, mesh: Mesh) -> Backend:
    """The sharded half of the routing, as the JAX driver's sharded branch:
    ``auto`` takes the one-step kernel for float32 NEBB on CUDA devices (the
    temporal-block one for shards of ``SHARDED_TBLOCK_AUTO_MIN_CELLS``
    cells), the plain sharded engine otherwise.  The temporal-block runner
    refreshes its halo through ``SHARDED_TBLOCK_HALO_IMPL`` (the mesh is one
    process on CUDA devices: ``simulate`` runs in one process and the route
    takes only CUDA devices); the one-step runner takes the exchange kernel
    by itself on such a mesh."""
    observe = halo.sharded_observables(cfg, mesh)
    prep = lambda s: halo.shard_state(s, mesh)  # noqa: E731
    kernels = {
        "cuda-sharded": (pull_sharded.unsupported_reason,
                         lambda n: pull_sharded.make_sharded_runner(cfg, n, mesh)),
        "cuda-sharded-tblock": (tblock_sharded.unsupported_reason,
                                lambda n: tblock_sharded.make_sharded_runner(
                                    cfg, n, mesh, halo_impl=SHARDED_TBLOCK_HALO_IMPL)),
    }
    if backend == "auto" and mesh.on_cuda:
        if (SHARDED_TBLOCK_AUTO_MIN_CELLS is not None
                and (cfg.nx // mesh.shape[0]) * (cfg.ny // mesh.shape[1])
                >= SHARDED_TBLOCK_AUTO_MIN_CELLS
                and tblock_sharded.unsupported_reason(cfg) is None):
            backend = "cuda-sharded-tblock"
        elif pull_sharded.unsupported_reason(cfg) is None:
            backend = "cuda-sharded"
    if backend in kernels:
        unsupported, make_runner = kernels[backend]
        reason = unsupported(cfg)
        if not mesh.on_cuda:
            reason = f"the CUDA kernel runs on CUDA devices, not {mesh.devices}"
        if reason is not None:
            raise ValueError(f"backend {backend!r} cannot run this configuration: {reason}")
        return Backend(backend, make_runner, lambda _cfg, s: observe(s), prep)
    return Backend("sharded", lambda n: halo.make_sharded_scan_runner(cfg, n, mesh),
                   lambda _cfg, s: observe(s), prep)


def _select_backend(cfg: SimConfig, backend: str, device: Placement) -> Backend:
    """Pick the runner for ``simulate`` and ``run_to_convergence`` alike, as
    the JAX driver's routing does; this is the one place that routes.  On
    one device ``auto`` on the card takes a kernel for float32 NEBB (the
    temporal-block one from ``TBLOCK_AUTO_MIN_CELLS`` cells) and the one-step
    kernel for the float32 tangential lid at every size (the temporal-block
    kernel refuses it), the plain fused engine for float64 and on the CPU;
    for the walls only the push engines implement, the push kernel on the
    card where it serves the configuration, the push oracle otherwise.  A
    mesh, or a sharded backend, goes to
    ``_select_sharded``; ``device`` is then the ``Mesh`` (or, for a 1 x 1
    mesh, its one device), and ``cuda-sharded-tblock`` refreshes its halo
    through ``SHARDED_TBLOCK_HALO_IMPL`` ("rdma": one exchange kernel
    launch per card)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if cfg.mesh_shape != (1, 1) or backend in _SHARDED:
        if cfg.boundary != "nebb":
            raise ValueError(
                f"boundary {cfg.boundary!r} runs on a single-device engine; "
                f"the requested mesh {cfg.mesh_shape} would be ignored"
            )
        if backend not in ("auto", *_SHARDED):
            raise ValueError(
                f"backend {backend!r} is single-device; the requested mesh "
                f"{cfg.mesh_shape} would be ignored"
            )
        mesh = device if isinstance(device, Mesh) else make_mesh(cfg.mesh_shape, [device])
        return _select_sharded(cfg, backend, mesh)
    fused, pushed = engine.observables, engine.push_observables
    kernels = {
        "cuda-pull": (pull.unsupported_reason,
                      lambda n: pull.make_scan_runner(cfg, n, device), fused),
        "cuda-tblock": (tblock.unsupported_reason,
                        lambda n: tblock.make_scan_runner(cfg, n, device), fused),
        "cuda-push": (push.unsupported_reason,
                      lambda n: push.make_scan_runner(cfg, n, device), pushed),
    }
    if backend in kernels:
        unsupported, make_runner, observe = kernels[backend]
        reason = unsupported(cfg)
        if device.type != "cuda":
            reason = f"the CUDA kernel runs on a CUDA device, not {device}"
        if reason is not None:
            raise ValueError(f"backend {backend!r} cannot run this configuration: {reason}")
        return Backend(backend, make_runner, observe)
    if backend == "push-oracle" or cfg.boundary in _PUSH_ONLY:
        if backend not in ("auto", "push-oracle"):
            raise ValueError(f"boundary {cfg.boundary!r} runs only on the push "
                             f"engines (cuda-push, push-oracle), not on backend "
                             f"{backend!r}")
        if (backend == "auto" and device.type == "cuda"
                and push.unsupported_reason(cfg) is None):
            return Backend("cuda-push", kernels["cuda-push"][1], pushed)
        return Backend("push-oracle",
                       lambda n: engine.make_push_scan_runner(cfg, n, device), pushed)
    if backend == "auto" and device.type == "cuda" and pull.unsupported_reason(cfg) is None:
        if (TBLOCK_AUTO_MIN_CELLS is not None
                and cfg.nx * cfg.ny >= TBLOCK_AUTO_MIN_CELLS
                and tblock.unsupported_reason(cfg) is None):
            return Backend("cuda-tblock", kernels["cuda-tblock"][1], fused)
        return Backend("cuda-pull", kernels["cuda-pull"][1], fused)
    return Backend("torch", lambda n: engine.make_scan_runner(cfg, n, device), fused)


def run_to_convergence(cfg: SimConfig, state: engine.State | None = None,
                       callback=None, device="cuda",
                       backend: str = "auto") -> engine.RunResult:
    """``engine.run_to_convergence`` stepping through the backend that
    ``simulate`` would pick (``backend`` and ``device`` as there).  With a
    mesh, ``callback`` sees the sharded state and the result holds the
    global state on the mesh's first device."""
    cfg.validate()
    where = _placement(cfg, device)
    routed = _select_backend(cfg, backend, where)
    first = _first_device(where)
    if state is None:
        state = engine.init_state(cfg, first)
    result = engine.run_to_convergence(
        cfg, routed.prep(state), callback, first,
        runner=routed.make_runner(max(1, cfg.report_interval)),
        observe=routed.observe)
    if isinstance(result.state, halo.ShardedState):
        result = result._replace(state=halo.unshard_state(result.state, first))
    return result


def _scaled(state, s: float):
    """The state with every population and lid density times ``s``."""
    if isinstance(state, halo.ShardedState):
        return state.map(lambda t: t * s)
    return engine.State(f=state.f * s, rho_lid=state.rho_lid * s)


def _global_state(state, device: torch.device) -> engine.State:
    """The run's state as one ``engine.State``: a sharded one gathered onto
    ``device``."""
    if isinstance(state, halo.ShardedState):
        return halo.unshard_state(state, device)
    return state


def _devices(where: Placement) -> list:
    """The distinct devices a run uses."""
    if isinstance(where, Mesh):
        return list(dict.fromkeys(d for row in where.devices for d in row))
    return [where]


def _profiled(runner, state, where: Placement, profile_dir: str):
    """``runner(state)`` under ``torch.profiler`` (CPU activity, and CUDA
    activity on cards), waited for before the profiler stops, in a span
    named ``CHUNK_SPAN``; the trace goes to ``profile_dir/trace.json``.
    Returns the state and the seconds the profiler took around the chunk
    (its start, stop and export)."""
    cards = [d for d in _devices(where) if d.type == "cuda"]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        with record_function(CHUNK_SPAN):
            t_chunk = time.perf_counter()
            state = runner(state)
            for d in cards:
                torch.cuda.synchronize(d)
            chunk_s = time.perf_counter() - t_chunk
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return state, time.perf_counter() - t0 - chunk_s


def simulate(cfg: SimConfig, opts: Optional[SimOptions] = None,
             device="cuda") -> SimSummary:
    """Run a cavity simulation to convergence with full diagnostics.
    ``device`` is one device, or with a mesh a sequence of ``mx * my``
    devices; the default ``"cuda"`` takes the first card (``mx * my``
    cards with a mesh)."""
    opts = opts or SimOptions()
    cfg.validate()
    where = _placement(cfg, device)
    routed = _select_backend(cfg, opts.backend, where)
    backend = routed.name
    first = _first_device(where)
    os.makedirs(opts.out_dir, exist_ok=True)
    chunk = max(1, cfg.report_interval)
    runner = routed.make_runner(chunk)
    if opts.resume_from:
        state, start_step = load_checkpoint(opts.resume_from, cfg, first)
    else:
        state, start_step = engine.init_state(cfg, first), 0
    state = routed.prep(state)
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[cfg.dtype]

    metrics = MetricsLogger(
        os.path.join(opts.out_dir, f"{opts.project}_metrics.jsonl")
        if opts.metrics_jsonl else None
    )
    ckpt = (
        Checkpointer(os.path.join(opts.out_dir, "ckpt"), cfg,
                     every=opts.checkpoint_every, start_step=start_step, device=first)
        if opts.checkpoint_every else None
    )
    if opts.verbose:
        print(f"[{backend}] {cfg.describe()}")

    r2_history = []
    mean_past, hits = np.inf, 0
    converged = False
    step = start_step
    vtk_n = 0
    restores = 0
    profiler_s = 0.0
    t0 = time.perf_counter()
    while step < cfg.max_steps:
        if opts.profile_dir is not None and step == start_step:
            state, profiler_s = _profiled(runner, state, where, opts.profile_dir)
        else:
            state = runner(state)
        step += chunk
        rho, u = routed.observe(cfg, state)
        rho_h, u_h = rho.cpu().numpy(), u.cpu().numpy()
        mean_u = float(u_h.mean(dtype=np.float64))
        if not np.isfinite(mean_u):
            # One restore gives transient blow-ups (bad resume file, cosmic
            # ray, preempted write) a second chance; identical dynamics that
            # diverge deterministically must not loop forever.
            if ckpt is not None and ckpt.last_good and restores < 1:
                restores += 1
                if opts.verbose:
                    print(f"blow-up at step {step}; restoring {ckpt.last_good}")
                restored, step = ckpt.restore_last_good()
                state = routed.prep(restored)
                mean_past, hits = np.inf, 0
                continue
            raise FloatingPointError(f"simulation diverged at step {step}")

        if opts.mass_correction:
            scale = 1.0 / rho_h.mean(dtype=np.float64)
            if abs(scale - 1.0) > 1e-12:
                # rounded to the working precision first, as the JAX driver's
                # cfg.dtype(scale) is; on the push path rho_lid is the
                # placeholder and is never read
                state = _scaled(state, float(np_dtype(scale)))
                rho_h = rho_h * scale

        rec = {"mean_u": mean_u, "backend": backend}
        if has_reynolds(cfg.reynolds):
            cmp_ = compare_to_ghia(u_h, cfg.u_lid, cfg.reynolds)
            rec.update(r2_ux=cmp_.r2_ux, l2=cmp_.l2_combined)
            r2_history.append((step, cmp_.r2_ux))
        metrics.log(step, **rec)
        if opts.verbose:
            extra = f" R2={rec['r2_ux']:.4f}" if "r2_ux" in rec else ""
            print(f"  step {step}: mean_u={mean_u:.3e}{extra}")

        if ckpt is not None and ckpt.due(step):
            # the global (f, rho_lid), gathered only when it is saved; on the
            # push route rho_lid is the placeholder f[0, :, 0], as the JAX
            # package's simulate saves it
            ckpt(step, _global_state(state, first), rho_h, u_h)
        if opts.save_plots:
            viz.dashboard(cfg, rho_h, u_h, step, r2_history,
                          out_dir=opts.out_dir, prefix=opts.project)
        if opts.save_vtk:
            save_to_vtk(u_h, rho_h, opts.project, vtk_n, out_dir=opts.out_dir)
            vtk_n += 1

        if abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol:
            hits += 1
            if hits > cfg.convergence_hits:
                converged = True
                break
        else:
            hits = 0
        mean_past = mean_u
    elapsed = time.perf_counter() - t0 - profiler_s

    _, u = routed.observe(cfg, state)
    u_h = u.cpu().numpy()
    r2 = r2_uy = l2 = None
    if has_reynolds(cfg.reynolds):
        cmp_ = compare_to_ghia(u_h, cfg.u_lid, cfg.reynolds)
        r2, r2_uy, l2 = cmp_.r2_ux, cmp_.r2_uy, cmp_.l2_combined
    summary = SimSummary(
        steps=step, converged=converged, elapsed_s=elapsed,
        mlups=mlups(cfg.nx, cfg.ny, step - start_step, elapsed),
        r2_ux=r2, l2_combined=l2, out_dir=opts.out_dir, backend=backend,
        r2_uy=r2_uy,
    )
    metrics.log(step, final=True, mlups=summary.mlups,
                converged=converged, **({"r2_ux": r2, "l2": l2} if r2 is not None else {}))
    metrics.close()
    if opts.verbose:
        print(
            f"done: {step} steps, converged={converged}, "
            f"{summary.mlups:.1f} MLUPS"
            + (f", R2(ux)={r2:.4f}, L2={100 * l2:.2f}%" if r2 is not None else "")
        )
    return summary
