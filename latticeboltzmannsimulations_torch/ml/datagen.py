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
on the given device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import engine
from ..config import SimConfig, resolve_device
from ..kernels import pull


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
    convergence tolerance)."""
    return u.cpu().numpy().mean(axis=(1, 2, 3), dtype=np.float64)


def _renormed(state: engine.State, rho_b: torch.Tensor) -> engine.State:
    """Per-cavity mass renormalisation of a batch (``f (B, 9, X, Y)``) or of
    cavities stacked along x (``f (9, B * X, Y)``), given each cavity's
    density ``rho_b (B, X, Y)``: its f and lid densities scaled by the
    inverse of its mean density (velocity is invariant under it)."""
    scale = (1.0 / rho_b.mean(dim=(1, 2))).to(state.f.dtype)
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


def _generate_stacked(cfg, re_values, n_cav, progress, on_batch, device):
    """The batched sweep on the card: ``n_cav`` cavities stacked along x
    advance through one launch of the sweep kernel per step, each with its
    own omega; the convergence check and the per-cavity mass
    renormalisation run on the stack every ``report_interval`` steps.  A
    short last batch is padded with repeats of its last Re, whose results
    are discarded."""
    n = len(re_values)
    nx, ny = cfg.nx, cfg.ny
    state0 = engine.init_state(cfg, device)
    feq_initial = state0.f.cpu().numpy()
    chunk = max(1, cfg.report_interval)
    runner = pull.make_sweep_runner(cfg, n_cav, chunk, device)

    f_final = np.empty((n, 9, nx, ny), dtype=feq_initial.dtype)
    u_final = np.empty((n, 2, nx, ny), dtype=feq_initial.dtype)
    failed = np.zeros(n, dtype=bool)

    for lo in range(0, n, n_cav):
        hi = min(lo + n_cav, n)
        res = re_values[lo:hi]
        b = hi - lo
        res_pad = np.concatenate([res, np.repeat(res[-1:], n_cav - b)])
        omegas = np.array([_omega(cfg, r) for r in res_pad])
        state = engine.stack_cavities(engine.State(
            state0.f.expand(n_cav, *state0.f.shape),
            state0.rho_lid.expand(n_cav, *state0.rho_lid.shape)))
        mean_past = np.full(n_cav, np.inf)
        hits = np.zeros(n_cav, dtype=int)
        fail_b = np.zeros(n_cav, dtype=bool)
        steps = 0
        while steps < cfg.max_steps:
            state = runner(state, omegas)
            steps += chunk
            rho_b, u_b = engine.batched_observables(
                cfg, engine.unstack_cavities(state, n_cav))
            state = _renormed(state, rho_b)
            mean_u = _mean_u(u_b)
            # Quarantine diverged cavities: the stacked cavities are isolated
            # (cross-boundary gathers land only in wall-rewritten
            # populations), so a NaN slot cannot leak; mark it failed and let
            # the rest of the batch run on.
            newly = ~np.isfinite(mean_u) & ~fail_b
            if np.any(newly[:b]):
                fail_b |= newly
                _quarantine(progress, res, newly[:b], steps)
            done = np.abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol
            hits = np.where(done, hits + 1, 0)
            mean_past = mean_u
            if np.all((hits[:b] > cfg.convergence_hits) | fail_b[:b]):
                break
        # Final observables from the converged (renormed) state.
        batch = engine.unstack_cavities(state, n_cav)
        _, u_b = engine.batched_observables(cfg, batch)
        f_c, u_c = _zero_failed(batch.f[:b].cpu().numpy(), u_b[:b].cpu().numpy(),
                                fail_b[:b])
        f_final[lo:hi], u_final[lo:hi] = f_c, u_c
        failed[lo:hi] = fail_b[:b]
        converged = hits[:b] > cfg.convergence_hits
        _batch_report(progress, lo, hi, res, steps, converged, fail_b[:b])
        if on_batch is not None:
            on_batch(res, f_final[lo:hi], u_final[lo:hi], steps, converged, fail_b[:b])
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


def _generate_batched(cfg, re_values, batch_size, progress, on_batch, device):
    """The sweep through the plain engine on ``device``: ``batch_size``
    independent cavities per batch (``engine.make_batched_step_omega``, the
    JAX package's vmapped step), each renormalised and checked every
    ``report_interval`` steps."""
    n = len(re_values)
    state0 = engine.init_state(cfg, device)
    feq_initial = state0.f.cpu().numpy()  # initial equilibrium (datagen :281)

    chunk = max(1, cfg.report_interval)
    step = engine.make_batched_step_omega(cfg)

    f_final = np.empty((n, 9, cfg.nx, cfg.ny), dtype=feq_initial.dtype)
    u_final = np.empty((n, 2, cfg.nx, cfg.ny), dtype=feq_initial.dtype)
    failed = np.zeros(n, dtype=bool)

    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        res = re_values[lo:hi]
        omegas = torch.tensor([_omega(cfg, r) for r in res], dtype=cfg.dtype,
                              device=device)
        b = hi - lo
        state = engine.State(f=state0.f.expand(b, *state0.f.shape),
                             rho_lid=state0.rho_lid.expand(b, *state0.rho_lid.shape))
        mean_past = np.full(b, np.inf)
        hits = np.zeros(b, dtype=int)
        fail_b = np.zeros(b, dtype=bool)
        steps = 0
        while steps < cfg.max_steps:
            for _ in range(chunk):
                state = step(state, omegas)
            steps += chunk
            rho_b, u = engine.batched_observables(cfg, state)
            # per-run mass renormalization (see sim.SimOptions.mass_correction)
            state = _renormed(state, rho_b)
            mean_u = _mean_u(u)
            # Quarantine diverged runs (the batch's cavities are independent).
            newly = ~np.isfinite(mean_u) & ~fail_b
            if np.any(newly):
                fail_b |= newly
                _quarantine(progress, res, newly, steps)
            done = np.abs(mean_u - mean_past) / cfg.u_lid < cfg.convergence_tol
            hits = np.where(done, hits + 1, 0)
            mean_past = mean_u
            if np.all((hits > cfg.convergence_hits) | fail_b):
                break
        converged = hits > cfg.convergence_hits
        _batch_report(progress, lo, hi, res, steps, converged, fail_b)
        _, u_b = engine.batched_observables(cfg, state)
        f_c, u_c = _zero_failed(state.f.cpu().numpy(), u_b.cpu().numpy(), fail_b)
        f_final[lo:hi], u_final[lo:hi] = f_c, u_c
        failed[lo:hi] = fail_b
        if on_batch is not None:
            on_batch(res, f_final[lo:hi], u_final[lo:hi], steps, converged, fail_b)

    return DatasetArrays(
        re_range=re_values,
        feq_initial=feq_initial,
        f_final=f_final,
        u_final=u_final,
        failed=failed,
    )


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
    mesh=None,
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

    ``mesh`` (the JAX package's spread of batches over devices) is not
    ported yet: it raises ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "generate_dataset(mesh=...) is not ported yet: ROADMAP.md queue 1 "
            "item 3 (datagen's data parallelism)")
    device = resolve_device(device)
    if re_values is None:
        re_values = np.arange(100, 5100, 10, dtype=np.float64)  # 500 runs
    re_values = np.asarray(re_values, dtype=np.float64)
    n = len(re_values)

    if sweep_kernel_reason(cfg, device) is None:
        if n > 1 and batch_size > 1:
            return _generate_stacked(cfg, re_values, min(batch_size, n), progress,
                                     on_batch, device)
        return _generate_sequential(cfg, re_values, progress, on_batch, device)
    return _generate_batched(cfg, re_values, batch_size, progress, on_batch, device)


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
