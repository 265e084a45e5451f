"""Physics operators (layer L1/L2): equilibrium, macroscopics, collision,
streaming and the wall velocity overrides, all as plain PyTorch functions
over ``(9, X, Y)`` planar fields."""

from .equilibrium import equilibrium, macroscopics, lid_row_density  # noqa: F401
from .collision import (  # noqa: F401
    srt_collide,
    trt_collide,
    mrt_collide,
    smagorinsky_tau,
)
from .streaming import stream_push, stream_pull, gather_pull  # noqa: F401
from . import boundary  # noqa: F401
