"""Validation (layer L4): Ghia et al. (1982) golden data, centerline profile
extraction, the R^2 / L2 fidelity metrics and vortex-center detection.  NumPy
only."""

from .ghia_data import RE_VALUES, has_reynolds, UX_MID_COLUMN, UY_MID_ROW, VORTICES  # noqa: F401
from .ghia import (  # noqa: F401
    GhiaComparison,
    centerline_profiles,
    compare_to_ghia,
    l2_error,
    r_squared,
)
from .vortex import find_vortex_centers  # noqa: F401
