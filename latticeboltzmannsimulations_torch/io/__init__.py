"""I/O layer (L5): checkpoint/restore and structured metrics.  The VTK
writers of the JAX package's ``io/`` are not ported yet (see
``ROADMAP.md``)."""

from .checkpoint import Checkpointer, load_checkpoint, save_checkpoint
from .metrics import MetricsLogger, mlups

__all__ = ["Checkpointer", "save_checkpoint", "load_checkpoint", "MetricsLogger", "mlups"]
