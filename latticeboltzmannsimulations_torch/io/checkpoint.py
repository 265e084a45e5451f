"""Simulation checkpoint / resume (a capability the reference lacks: its only
persistence is dataset dumps and Keras .h5 saves), as the JAX package's
``io/checkpoint.py`` writes it.

Format: a single ``.npz`` holding the fused-engine state ``(f, rho_lid)``,
the step counter, and a config fingerprint that is verified on restore.
The keys and the fingerprint are the JAX package's (``dataclasses.asdict``
of the two packages' ``SimConfig`` gives the same JSON), so a checkpoint
written by either package loads in the other.  The state is fetched to the
host once per save (off the hot path).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig, resolve_device
from ..engine import State


def _fingerprint(cfg: SimConfig) -> str:
    payload = {
        k: v for k, v in dataclasses.asdict(cfg).items()
        if k not in ("report_interval", "max_steps")  # resumable knobs
    }
    return json.dumps(payload, sort_keys=True, default=str)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(path: str, state: State, step: int, cfg: SimConfig) -> str:
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            f=_host(state.f),
            rho_lid=_host(state.rho_lid),
            step=np.int64(step),
            fingerprint=np.frombuffer(
                _fingerprint(cfg).encode(), dtype=np.uint8
            ),
        )
    os.replace(tmp, path)  # atomic: no torn checkpoints on crash
    return path


def load_checkpoint(path: str, cfg: SimConfig, device="cuda") -> Tuple[State, int]:
    """The saved state as contiguous tensors of ``cfg.dtype`` on ``device``
    (what the kernels take), and its step; raises ``ValueError`` for a
    checkpoint of another configuration."""
    device = resolve_device(device)
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _fingerprint(cfg):
            raise ValueError(
                f"checkpoint {path} was written with a different config:\n"
                f"  saved: {fp}\n  current: {_fingerprint(cfg)}"
            )
        state = State(*(torch.from_numpy(z[k]).to(device, cfg.dtype).contiguous()
                        for k in ("f", "rho_lid")))
        return state, int(z["step"])


class Checkpointer:
    """Interval callback for ``sim.simulate``: saves once at least ``every``
    steps have passed since the last save, keeps the last ``keep``
    checkpoints (never deleting the last good one), and remembers the last
    finite ("good") one for blow-up recovery, which it restores onto
    ``device``."""

    def __init__(self, directory: str, cfg: SimConfig, every: int = 0,
                 keep: int = 2, start_step: int = 0, device="cuda"):
        self.directory = directory
        self.cfg = cfg
        self.every = every
        self.keep = keep
        self.device = device
        self._saved: list[str] = []
        self.last_good: Optional[str] = None
        # Seed the save clock from the resume point: a fresh Checkpointer in
        # a resumed run would otherwise measure ``since`` from step 0 and
        # write a redundant checkpoint at the first report interval.
        self._last_saved_step: Optional[int] = start_step or None

    def due(self, step: int) -> bool:
        """Whether a call at ``step`` would save (a finite state given), so
        a caller can skip gathering a sharded state that would not be
        saved."""
        # The caller only invokes this at report-interval multiples, so an
        # exact ``step % every`` test can silently never fire when ``every``
        # is not a multiple of the report interval.  Save whenever at least
        # ``every`` steps have elapsed since the last save instead.
        if not self.every:
            return True
        since = (step if self._last_saved_step is None
                 else step - self._last_saved_step)
        return since >= self.every

    def __call__(self, step: int, state: State, rho, u) -> None:
        if not self.due(step):
            return
        if not bool(np.isfinite(_host(u)).all()):
            # Never persist a diverged state: a fresh process's cold scan
            # picks the NEWEST file, and a known-bad newest checkpoint
            # would make blow-up recovery restore the blow-up itself.
            return
        self._last_saved_step = step
        path = os.path.join(self.directory, f"ckpt_{step:08d}.npz")
        save_checkpoint(path, state, step, self.cfg)
        self.last_good = path
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            if old != self.last_good and os.path.exists(old):
                os.remove(old)

    def restore_last_good(self) -> Tuple[State, int]:
        if self.last_good is None:
            # Cold scan of the directory (fresh process).  Every persisted
            # checkpoint was finite when written (see __call__), so the
            # newest is the last good one.
            cands = sorted(
                p for p in os.listdir(self.directory) if p.endswith(".npz")
            )
            if not cands:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            self.last_good = os.path.join(self.directory, cands[-1])
        state, step = load_checkpoint(self.last_good, self.cfg, self.device)
        # Rewind the save clock to the restore point, else no checkpoint
        # is written while the replay window re-runs (a second failure
        # there would lose the whole window).
        self._last_saved_step = step
        return state, step
