"""Structured per-interval metrics: JSONL sink + MLUPS computation.

Replaces the reference's stdout prints and hand-kept spreadsheet
(``CythonPerformance.ods``; per-interval prints ``MRTtest.py:796,860-861``)
with machine-readable records.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


def mlups(nx: int, ny: int, steps: int, elapsed_s: float) -> float:
    """Million lattice-site updates per second — the reference's headline
    metric (reference: ``MRTTiledPull.py:703``)."""
    return nx * ny * steps * 1e-6 / elapsed_s


class MetricsLogger:
    """Append-only JSONL metrics stream.

    Each ``log()`` writes one line: ``{"t": wall_clock, "step": ..., **kv}``.
    Use as a callback alongside plots/VTK in ``run_to_convergence``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[IO[str]] = None
        self._t0 = time.perf_counter()
        self.records: list[dict] = []
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, step: int, **kv) -> dict:
        rec = {"t": round(time.perf_counter() - self._t0, 6), "step": step}
        rec.update(kv)
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
