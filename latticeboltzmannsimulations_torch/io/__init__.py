"""I/O layer (L5): VTK export, checkpoint/restore and structured metrics,
as the JAX package's ``io/`` has them."""

from .vtk import save_to_vtk, write_vtr, write_vti, write_vtp_points
from .checkpoint import Checkpointer, load_checkpoint, save_checkpoint
from .metrics import MetricsLogger, mlups

__all__ = [
    "save_to_vtk",
    "write_vtr",
    "write_vti",
    "write_vtp_points",
    "Checkpointer",
    "save_checkpoint",
    "load_checkpoint",
    "MetricsLogger",
    "mlups",
]
