"""latticeboltzmannsimulations_torch — the D2Q9 lattice-Boltzmann lid-driven
cavity in PyTorch, with the fused pull step as a hand-written CUDA kernel
for NVIDIA Hopper (H100).

The port of the JAX package beside it, slice by slice; that package is the
reference the tests hold this one to.  This package imports neither it nor
JAX.  Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.

Typical use::

    import latticeboltzmannsimulations_torch as lbt

    cfg = lbt.SimConfig(nx=256, ny=256, reynolds=1000, collision="mrt")
    result = lbt.run_to_convergence(cfg)          # on the card
    rho, u = lbt.observables(cfg, result.state)
"""

from .config import SimConfig  # noqa: F401
from .engine import (  # noqa: F401
    State,
    init_state,
    initial_fields,
    make_fused_step,
    make_fused_step_omega,
    make_scan_runner,
    observables,
)
from .sim import SimOptions, SimSummary, run_to_convergence, simulate  # noqa: F401
from . import lattice, ops  # noqa: F401

__version__ = "0.1.0"
