"""Reynolds-sweep dataset generator.

The JAX package's ``ml/datagen.py`` in PyTorch, with the same routing and
the same four-array schema as the reference generator (reference:
``MRT_GPU_datagen.py:886-902``)::

    Re_range    (N,)
    feq_initial (9, X, Y)
    f_final     (N, 9, X, Y)
    u_final     (N, 2, X, Y)

plus ``failed.npy`` whenever a cavity diverged.  The sweep (default Re
100..5090 step 10, 500 runs) runs each cavity to convergence
(``|d mean(u)| / u_lid < cfg.convergence_tol`` sustained), one relaxation
rate per cavity.

Routing, as the JAX package's: on the card, for float32 NEBB without Van
Driest damping, a batch of cavities stacked along x advances through the
sweep form of the CUDA pull kernel (``kernels.pull.make_sweep_runner``),
one launch per step for the whole batch, or, with a batch of one, one
cavity at a time through its one-cavity form (``make_scan_runner_omega``).
Everything else (float64, the other walls, Van Driest, the CPU) runs a
batch of cavities through the plain engine (``engine.make_batched_step_omega``)
on the given device.  With a mesh, a batch is split over the mesh's first
axis, one stack (or plain batch) per entry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import engine
from ..config import SimConfig, resolve_device
from ..kernels import pull
from ..parallel.mesh import Mesh


@dataclasses.dataclass
class DatasetArrays:
    re_range: np.ndarray     # (N,)
    feq_initial: np.ndarray  # (9, X, Y)
    f_final: np.ndarray      # (N, 9, X, Y)
    u_final: np.ndarray      # (N, 2, X, Y)
    # Quarantined runs: a cavity that diverged mid-sweep is marked here and
    # its f/u slots zeroed; the rest of the batch completes (the reference's
    # sequential per-run loop simply moved on past a blown-up Re).
    failed: Optional[np.ndarray] = None  # (N,) bool


def _omega(cfg: SimConfig, re: float) -> float:
    return dataclasses.replace(cfg, reynolds=float(re)).omega


def _mean_u(u: torch.Tensor) -> np.ndarray:
    """Per-cavity mean of a batch of velocity fields, reduced on the host in
    float64 (at float32 the device mean's rounding sits near the 1e-8
    convergence tolerance), each cavity on its own."""
    return np.array([c.mean(dtype=np.float64) for c in u.cpu().numpy()])


def _renormed(state: engine.State, rho_b: torch.Tensor) -> engine.State:
    """Per-cavity mass renormalisation of a batch (``f (B, 9, X, Y)``) or of
    cavities stacked along x (``f (9, B * X, Y)``), given each cavity's
    density ``rho_b (B, X, Y)``: its f and lid densities scaled by the
    inverse of its mean density (velocity is invariant under it).  Each
    cavity's mean is its own reduction, so a cavity's bits do not depend on
    the batch or stack it runs in."""
    scale = (1.0 / torch.stack([r.mean() for r in rho_b])).to(state.f.dtype)
    n_cav = len(scale)
    if state.f.dim() == 4:
        f = state.f * scale[:, None, None, None]
    else:
        q, width, ny = state.f.shape
        f = (state.f.reshape(q, n_cav, width // n_cav, ny)
             * scale[None, :, None, None]).reshape(q, width, ny)
    rho_lid = (state.rho_lid.reshape(n_cav, -1) * scale[:, None]).reshape(
        state.rho_lid.shape)
    return engine.State(f, rho_lid)


def _quarantine(progress, res, newly, steps) -> None:
    if progress is not None:
        progress(f"quarantined diverged Re={res[newly].tolist()} at step {steps}")


def _batch_report(progress, lo, hi, res, steps, converged, fail_b) -> None:
    if progress is not None:
        progress(
            f"Re[{lo}:{hi}] ({res[0]:g}..{res[-1]:g}): {steps} steps, "
            f"{int(converged.sum())}/{len(res)} converged"
            + (f", {int(fail_b.sum())} failed" if fail_b.any() else "")
        )


def _zero_failed(f_c: np.ndarray, u_c: np.ndarray, fail_b: np.ndarray):
    if fail_b.any():
        f_c, u_c = f_c.copy(), u_c.copy()
        f_c[fail_b] = 0.0
        u_c[fail_b] = 0.0
    return f_c, u_c


def _parts(b: int, n_dev: int) -> List[Tuple[int, int, int]]:
    """``(lo, hi, device index)`` of each part of a batch of ``b`` cavities:
    ``n_dev`` equal parts, one per device, when they divide the batch, else
    the whole batch on the first device (as the JAX package leaves a batch
    that does not divide unsharded)."""
    if n_dev > 1 and b % n_dev == 0:
        per = b // n_dev
        return [(i * per, (i + 1) * per, i) for i in range(n_dev)]
    return [(0, b, 0)]


class _Part:
    """The cavities ``[lo, hi)`` of a batch on one device, padded to
    ``size`` cavities by repeats of the last (their results discarded)."""

    def __init__(self, state0, omegas: np.ndarray, lo: int, hi: int, size: int,
                 device, stacked: bool, dtype):
        self.lo, self.hi, self.size, self.device, self.stacked = lo, hi, size, device, stacked
        om = np.concatenate([omegas[lo:hi], np.repeat(omegas[hi - 1:hi], size - (hi - lo))])
        f0, lid0 = state0.f.to(device), state0.rho_lid.to(device)
        state = engine.State(f0.expand(size, *f0.shape), lid0.expand(size, *lid0.shape))
        # the sweep runner takes host omegas; the plain step a device vector
        self.omegas = om if stacked else torch.tensor(om, dtype=dtype, device=device)
        self.state = engine.stack_cavities(state) if stacked else state

    def batch(self) -> engine.State:
        return engine.unstack_cavities(self.state, self.size) if self.stacked else self.state


def _generate_batches(cfg, re_values, batch_size, progress, on_batch, devices, stacked):
    """The sweep in batches of ``batch_size`` cavities, each batch split over
    ``devices`` (``_parts``), every part advancing ``report_interval`` steps
    per chunk, all parts' chunks issued before any result is read (so the
    devices run at once).  ``stacked``: a part's cavities stacked along x
    through the sweep kernel's runner (``pull.make_sweep_runner``, one
    launch per step per part; on the CPU its plain stacked step), a part
    that is a whole batch padded to ``batch_size`` cavities so that one
    runner serves every batch; else a part is a batch through the plain
    engine (``engine.make_batched_step_omega``, the JAX package's vmapped
    step).  The convergence check, the per-cavity mass renormalisation and
    the quarantine act on each cavity of the whole batch every chunk, as on
    one device."""
    n = len(re_values)
    state0 = engine.init_state(cfg, devices[0])
    feq_initial = state0.f.cpu().numpy()  # initial equilibrium (datagen :281)
    chunk = max(1, cfg.report_interval)
    step = engine.make_batched_step_omega(cfg)
    runners = {}

    def advance(part: _Part) -> engine.State:
        if not part.stacked:
            state = part.state
            for _ in range(chunk):
                state = step(state, part.omegas)
            return state
        key = (part.size, part.device)
        if key not in runners:
            runners[key] = pull.make_sweep_runner(cfg, part.size, chunk, part.device)
        return runners[key](part.state, part.omegas)

    f_final = np.empty((n, 9, cfg.nx, cfg.ny), dtype=feq_initial.dtype)
    u_final = np.empty((n, 2, cfg.nx, cfg.ny), dtype=feq_initial.dtype)
    failed = np.zeros(n, dtype=bool)

    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        res = re_values[lo:hi]
        b = hi - lo
        omegas = np.array([_omega(cfg, r) for r in res])
        parts = [_Part(state0, omegas, plo, phi,
                       batch_size if stacked and phi - plo == b else phi - plo,
                       devices[d], stacked, cfg.dtype)
                 for plo, phi, d in _parts(b, len(devices))]
        mean_past = np.full(b, np.inf)
        hits = np.zeros(b, dtype=int)
        fail_b = np.zeros(b, dtype=bool)
        steps = 0
        while steps < cfg.max_steps:
            for part in parts:
                part.state = advance(part)
            steps += chunk
            mean_u = []
            for part in parts:
                rho_b, u_b = engine.batched_observables(cfg, part.batch())
                # per-run mass renormalization (see sim.SimOptions.mass_correction)
                part.state = _renormed(part.state, rho_b)
                mean_u.append(_mean_u(u_b)[:part.hi - part.lo])
            mean_u = np.concatenate(mean_u)
            # Quarantine diverged cavities: they are independent (in a stack,
            # cross-boundary gathers land only in wall-rewritten
            # populations), so a NaN slot cannot leak; mark it failed and let
            # the rest of the batch run on.
            newly = ~np.isfinite(mean_u) & ~fail_b
            if np.any(newly):
                fail_b |= newly
                _quarantine(progress, res, newly, steps)
            done = np.abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol
            hits = np.where(done, hits + 1, 0)
            mean_past = mean_u
            if np.all((hits > cfg.convergence_hits) | fail_b):
                break
        # Final observables from the converged (renormed) state.
        f_c, u_c = [], []
        for part in parts:
            batch = part.batch()
            _, u_b = engine.batched_observables(cfg, batch)
            real = part.hi - part.lo
            f_c.append(batch.f[:real].cpu().numpy())
            u_c.append(u_b[:real].cpu().numpy())
        f_c, u_c = _zero_failed(np.concatenate(f_c), np.concatenate(u_c), fail_b)
        f_final[lo:hi], u_final[lo:hi] = f_c, u_c
        failed[lo:hi] = fail_b
        converged = hits > cfg.convergence_hits
        _batch_report(progress, lo, hi, res, steps, converged, fail_b)
        if on_batch is not None:
            on_batch(res, f_final[lo:hi], u_final[lo:hi], steps, converged, fail_b)
    return DatasetArrays(re_range=re_values, feq_initial=feq_initial,
                         f_final=f_final, u_final=u_final, failed=failed)


def _generate_sequential(cfg, re_values, progress, on_batch, device):
    """Per-Re runs on the card through the one-cavity form of the sweep
    kernel (omega as an argument), the scale of the mass renormalisation
    reduced on the host in float64.  ``on_batch`` fires after each Re, a
    batch of one (the JAX package's route drops the callback)."""
    n = len(re_values)
    state0 = engine.init_state(cfg, device)
    feq_initial = state0.f.cpu().numpy()
    chunk = max(1, cfg.report_interval)
    runner = pull.make_scan_runner_omega(cfg, chunk, device)

    f_final = np.empty((n, 9, cfg.nx, cfg.ny), dtype=feq_initial.dtype)
    u_final = np.empty((n, 2, cfg.nx, cfg.ny), dtype=feq_initial.dtype)
    failed = np.zeros(n, dtype=bool)
    for idx, re in enumerate(re_values):
        omega = _omega(cfg, re)
        state = state0
        mean_past, hits, steps = np.inf, 0, 0
        while steps < cfg.max_steps:
            state = runner(state, omega)
            steps += chunk
            rho, u = engine.observables(cfg, state)
            scale = float(np.float32(1.0 / rho.cpu().numpy().mean(dtype=np.float64)))
            state = engine.State(f=state.f * scale, rho_lid=state.rho_lid * scale)
            mean_u = float(u.cpu().numpy().mean(dtype=np.float64))
            if not np.isfinite(mean_u):
                failed[idx] = True  # quarantine and move to the next Re
                if progress is not None:
                    progress(f"quarantined diverged Re={re:g} at step {steps}")
                break
            if abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol:
                hits += 1
                if hits > cfg.convergence_hits:
                    break
            else:
                hits = 0
            mean_past = mean_u
        if failed[idx]:
            f_final[idx] = 0.0
            u_final[idx] = 0.0
        else:
            _, u = engine.observables(cfg, state)
            f_final[idx] = state.f.cpu().numpy()
            u_final[idx] = u.cpu().numpy()
        if progress is not None and (idx + 1) % 25 == 0:
            progress(f"Re {re:g} ({idx + 1}/{n}): {steps} steps")
        if on_batch is not None:
            on_batch(re_values[idx:idx + 1], f_final[idx:idx + 1],
                     u_final[idx:idx + 1], steps,
                     np.array([hits > cfg.convergence_hits]), failed[idx:idx + 1])
    return DatasetArrays(re_range=re_values, feq_initial=feq_initial,
                         f_final=f_final, u_final=u_final, failed=failed)


def sweep_kernel_reason(cfg: SimConfig, device) -> Optional[str]:
    """Why ``generate_dataset`` does not take the sweep kernel for ``cfg``
    on ``device`` (the plain batched engine runs instead), or None if it
    does: on the card, for what the kernel's sweep form takes (float32 NEBB
    without Van Driest damping, one device)."""
    if resolve_device(device).type != "cuda":
        return "not on a CUDA device"
    return pull.unsupported_reason(cfg, traced_omega=True)


def generate_dataset(
    cfg: SimConfig,
    re_values: Optional[np.ndarray] = None,
    batch_size: int = 32,
    progress: Optional[Callable[[str], None]] = None,
    on_batch: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
    device="cuda",
) -> DatasetArrays:
    """Run the sweep and return the dataset arrays.

    ``cfg`` fixes the grid / operator / turbulence model; ``cfg.reynolds`` is
    ignored in favor of ``re_values``.  Convergence uses
    ``cfg.convergence_tol`` / ``cfg.convergence_hits`` / ``cfg.max_steps``
    with checks every ``cfg.report_interval`` steps.

    ``on_batch(res, f_chunk, u_chunk, steps, converged, failed)`` fires after
    each completed batch (``converged`` / ``failed`` are per-cavity bool
    vectors) so multi-hour sweeps can persist incrementally and resume by
    re-running with only the missing ``re_values``.  A cavity that diverges
    is quarantined — marked in ``failed`` with zeroed fields — and the rest
    of the sweep continues.

    ``mesh`` (``parallel.make_mesh((dp, 1), devices)``; devices may repeat)
    spreads each batch of independent cavities over the mesh's first axis:
    a batch of ``b`` cavities with ``b % dp == 0`` runs as ``dp`` parts, one
    per entry (on cards one stack each through the sweep kernel, all issued
    before any is read), a batch that does not divide on the first entry's
    device.  There is no communication besides the host's convergence
    reads, and each cavity's arithmetic is the same wherever it runs, so
    the result equals ``mesh=None``'s.  With a mesh its devices take the
    place of ``device``; a mesh that spans processes, or whose first axis
    mixes device types, raises.
    """
    if mesh is not None:
        if mesh.spans_processes:
            raise NotImplementedError(
                "generate_dataset(mesh=...) runs in one process; a mesh that spans "
                "processes is not ported (ROADMAP.md queue 1)")
        devices = [mesh.device(ix, 0) for ix in range(mesh.shape[0])]
        if len({d.type for d in devices}) > 1:
            # one route serves every part: the cards' parts would take the
            # plain engine in place of the sweep kernel
            raise ValueError(f"generate_dataset(mesh=...): the mesh's first axis mixes "
                             f"device types ({[str(d) for d in devices]})")
    else:
        devices = [resolve_device(device)]
    if re_values is None:
        re_values = np.arange(100, 5100, 10, dtype=np.float64)  # 500 runs
    re_values = np.asarray(re_values, dtype=np.float64)
    n = len(re_values)

    if all(sweep_kernel_reason(cfg, d) is None for d in devices):
        if n > 1 and batch_size > 1:
            return _generate_batches(cfg, re_values, min(batch_size, n), progress,
                                     on_batch, devices, stacked=True)
        return _generate_sequential(cfg, re_values, progress, on_batch, devices[0])
    return _generate_batches(cfg, re_values, batch_size, progress, on_batch, devices,
                             stacked=False)


def bit_reversed_batches(values: np.ndarray, batch_size: int) -> np.ndarray:
    """Reorder ``values`` so consecutive-value batches run in bit-reversed
    index order.

    Batches keep consecutive Re values (similar convergence times, so a
    batch's slowest member wastes little of the others' work), but the batch
    *sequence* is bit-reversed: any prefix of the reordered sweep covers the
    whole Re range at roughly uniform density, so a sweep cut off by a time
    budget still yields a usable training set.

    The consumer (``generate_dataset``) re-slices the flat result into
    aligned ``batch_size`` groups, so any short final batch must stay LAST:
    placing it mid-sequence would shift every later slice boundary and mix
    Re values thousands apart in one batch (which then runs until its
    slowest member converges)."""
    batches = [values[i:i + batch_size]
               for i in range(0, len(values), batch_size)]
    tail = []
    if len(batches) > 1 and len(batches[-1]) != batch_size:
        tail = [batches.pop()]
    nbits = max(1, (len(batches) - 1).bit_length())
    order = sorted(range(len(batches)),
                   key=lambda i: int(f"{i:0{nbits}b}"[::-1], 2))
    return np.concatenate([batches[i] for i in order] + tail)


def save_dataset(ds: DatasetArrays, out_dir: str) -> None:
    """Same four-file .npy layout as the reference
    (reference: ``MRT_GPU_datagen.py:899-902``), plus ``failed.npy`` — the
    quarantine mask — whenever any cavity diverged, so zero-filled slots can
    never silently flow into training."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "Re_range.npy"), ds.re_range)
    np.save(os.path.join(out_dir, "feq_initial.npy"), ds.feq_initial)
    np.save(os.path.join(out_dir, "f_final.npy"), ds.f_final)
    np.save(os.path.join(out_dir, "u_final.npy"), ds.u_final)
    failed_path = os.path.join(out_dir, "failed.npy")
    if ds.failed is not None and ds.failed.any():
        np.save(failed_path, ds.failed)
    elif os.path.exists(failed_path):
        os.remove(failed_path)  # don't let a stale mask shadow a clean save


def load_dataset(out_dir: str) -> DatasetArrays:
    failed_path = os.path.join(out_dir, "failed.npy")
    return DatasetArrays(
        re_range=np.load(os.path.join(out_dir, "Re_range.npy")),
        feq_initial=np.load(os.path.join(out_dir, "feq_initial.npy")),
        f_final=np.load(os.path.join(out_dir, "f_final.npy")),
        u_final=np.load(os.path.join(out_dir, "u_final.npy")),
        failed=np.load(failed_path) if os.path.exists(failed_path) else None,
    )


def drop_failed(ds: DatasetArrays) -> DatasetArrays:
    """Dataset with quarantined (zero-filled) cavities removed."""
    if ds.failed is None or not ds.failed.any():
        return ds
    keep = ~ds.failed
    return DatasetArrays(
        re_range=ds.re_range[keep],
        feq_initial=ds.feq_initial,
        f_final=ds.f_final[keep],
        u_final=ds.u_final[keep],
        failed=None,
    )
