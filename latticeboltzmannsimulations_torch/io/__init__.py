"""I/O layer (L5): structured metrics.  The VTK writers and checkpoints of
the JAX package's ``io/`` are not ported yet (see ``ROADMAP.md``)."""

from .metrics import MetricsLogger, mlups

__all__ = ["MetricsLogger", "mlups"]
