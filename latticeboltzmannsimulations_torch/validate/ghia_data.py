"""Ghia, Ghia & Shin (1982) lid-driven-cavity benchmark tables.

High-Re solutions for incompressible flow using the Navier-Stokes equations
and a multigrid method, J. Comput. Phys. 48:387-411 — Tables I (u along the
vertical centerline), II (v along the horizontal centerline) and the vortex
location tables, for Re in {100, 400, 1000, 3200, 5000, 7500, 10000}.

Same published values the reference validates against
(reference: ``GhiaData.csv``, parsed at ``MRT.py:104-116``), restructured as
explicit mappings.  Coordinates are normalized to the cavity ([0, 1]^2) with
y measured from the BOTTOM wall (Ghia's convention; note the framework's
array index y=0 is the lid, see ``lattice.py``).

Three transcription typos present in the reference's CSV are CORRECTED
here: Re=3200 Ux(y=0.4531) -0.86636 -> -0.086636 and Re=400 Uy(x=0.9609)
+0.15663 -> -0.15663 (physically impossible, |u| <= 1 mid-cavity, would
poison the validation gates; reference ``GhiaData.csv`` rows 16 and 9),
and the station coordinate 0.2831 -> 0.2813 (row 17): Ghia's Table I
stations are nodes of the 129-point grid, and every other station is an
exact k/128 (0.2813 = 36/128) while 0.2831*128 = 36.23 is not — a digit
transposition that would sample the simulated profile ~0.002 cavity
heights off at that station.
"""

from __future__ import annotations

import numpy as np

RE_VALUES = (100, 400, 1000, 3200, 5000, 7500, 10000)

# y -> Ux/U_lid at the mid-column (x = 0.5), one value per Re in RE_VALUES.
UX_MID_COLUMN = {
    1.0000: (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
    0.9766: (0.84123, 0.75837, 0.65928, 0.53236, 0.48223, 0.47224, 0.47221),
    0.9688: (0.78871, 0.68439, 0.57492, 0.48296, 0.46120, 0.47048, 0.47783),
    0.9609: (0.73722, 0.61756, 0.51117, 0.46547, 0.45992, 0.47323, 0.48070),
    0.9531: (0.68717, 0.55892, 0.46604, 0.46101, 0.46036, 0.47167, 0.47804),
    0.8516: (0.23151, 0.29093, 0.33304, 0.34682, 0.33556, 0.34228, 0.34635),
    0.7344: (0.00332, 0.16256, 0.18719, 0.19791, 0.20087, 0.20591, 0.20673),
    0.6172: (-0.13641, 0.02135, 0.05702, 0.07156, 0.08183, 0.08342, 0.08344),
    0.5000: (-0.20581, -0.11477, -0.06080, -0.04272, -0.03039, -0.03800, 0.03111),
    0.4531: (-0.21090, -0.17119, -0.10648, -0.086636, -0.07404, -0.07503, -0.07540),
    0.2813: (-0.15662, -0.32726, -0.27805, -0.24427, -0.22855, -0.23176, -0.23186),
    0.1719: (-0.10150, -0.24299, -0.38289, -0.34323, -0.33050, -0.32393, -0.32709),
    0.1016: (-0.06434, -0.14612, -0.29730, -0.41933, -0.40435, -0.38324, -0.38000),
    0.0703: (-0.04775, -0.10338, -0.22220, -0.37827, -0.43643, -0.43025, -0.41657),
    0.0625: (-0.04192, -0.09266, -0.20196, -0.35344, -0.42901, -0.43590, -0.42537),
    0.0547: (-0.03717, -0.08186, -0.18109, -0.32407, -0.41165, -0.43154, -0.42735),
    0.0000: (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
}

# x -> Uy/U_lid at the mid-row (y = 0.5).
UY_MID_ROW = {
    1.0000: (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    0.9688: (-0.05906, -0.12146, -0.21388, -0.39017, -0.49774, -0.53858, -0.54302),
    0.9609: (-0.07391, -0.15663, -0.27669, -0.47425, -0.55069, -0.55216, -0.52987),
    0.9531: (-0.08864, -0.19254, -0.33714, -0.52357, -0.55408, -0.52347, -0.49099),
    0.9453: (-0.10313, -0.22847, -0.39188, -0.54053, -0.52876, -0.48590, -0.45863),
    0.9063: (-0.16914, -0.23827, -0.51550, -0.44307, -0.41442, -0.41050, -0.41496),
    0.8594: (-0.22445, -0.44993, -0.42665, -0.37401, -0.36214, -0.36213, -0.36737),
    0.8047: (-0.24533, -0.38598, -0.31966, -0.31184, -0.30018, -0.30448, -0.30719),
    0.5000: (0.05454, 0.05186, 0.02526, 0.00999, 0.00945, 0.00824, 0.00831),
    0.2344: (0.17527, 0.30174, 0.32235, 0.28188, 0.27280, 0.27348, 0.27224),
    0.2266: (0.17507, 0.30203, 0.33075, 0.29030, 0.28066, 0.28117, 0.28003),
    0.1563: (0.16077, 0.28124, 0.37095, 0.37199, 0.35368, 0.35060, 0.35070),
    0.0938: (0.12317, 0.22965, 0.32627, 0.42768, 0.42951, 0.41824, 0.41487),
    0.0781: (0.10890, 0.20920, 0.30353, 0.41906, 0.43648, 0.43654, 0.43124),
    0.0703: (0.10091, 0.19713, 0.29012, 0.40917, 0.43329, 0.44030, 0.43733),
    0.0625: (0.09233, 0.18360, 0.27485, 0.39560, 0.42447, 0.43979, 0.43983),
    0.0000: (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
}

# Vortex centers: name -> {"x": per-Re tuple, "y": per-Re tuple}; zeros mean
# the vortex does not exist at that Reynolds number.
VORTICES = {
    "primary": {
        "x": (0.6172, 0.5547, 0.5313, 0.5165, 0.5117, 0.5117, 0.5117),
        "y": (0.7344, 0.6055, 0.5625, 0.5469, 0.5352, 0.5322, 0.5333),
    },
    "top_left": {
        "x": (0.0, 0.0, 0.0, 0.0547, 0.0625, 0.0664, 0.0703),
        "y": (0.0, 0.0, 0.0, 0.8984, 0.9102, 0.9141, 0.9141),
    },
    "bottom_left_1": {
        "x": (0.0313, 0.0508, 0.0859, 0.0859, 0.0703, 0.0645, 0.0586),
        "y": (0.0391, 0.0469, 0.0781, 0.1094, 0.1367, 0.1504, 0.1641),
    },
    "bottom_right_1": {
        "x": (0.9453, 0.8906, 0.8594, 0.8125, 0.8086, 0.7813, 0.7656),
        "y": (0.0625, 0.1250, 0.1094, 0.0859, 0.0742, 0.0625, 0.0586),
    },
    "bottom_left_2": {
        "x": (0.0, 0.0039, 0.0, 0.0078, 0.0117, 0.0117, 0.0156),
        "y": (0.0, 0.0039, 0.0, 0.0078, 0.0078, 0.0117, 0.0195),
    },
    "bottom_right_2": {
        "x": (0.0, 0.9922, 0.9922, 0.9844, 0.9805, 0.9492, 0.9336),
        "y": (0.0, 0.0078, 0.0078, 0.0078, 0.0195, 0.0430, 0.0625),
    },
    "bottom_right_3": {
        "x": (0.0, 0.0, 0.0, 0.0, 0.0, 0.9961, 0.9961),
        "y": (0.0, 0.0, 0.0, 0.0, 0.0, 0.0039, 0.0039),
    },
}


# Stations whose tabulated value is inconsistent with any smooth profile
# through its neighbors (off by ~0.14 while a validated solver matches every
# other station to < 0.01).  Kept verbatim in the tables above for parity;
# excluded from the fidelity gates (compare_to_ghia drops them by default).
SUSPECT_STATIONS = {
    (400, "uy", 0.9063),   # -0.23827; neighbors imply ~ -0.36
    # +0.03111 breaks smoothness in BOTH directions: the y-neighbors
    # (-0.07540 @0.4531, +0.08344 @0.6172) interpolate to ~ -0.029 at 0.5,
    # and the Re-trend at y=0.5 is -0.04272 / -0.03039 / -0.03800 for
    # Re=3200/5000/7500.  Almost certainly a sign typo for -0.03111.
    (10000, "ux", 0.5000),
}


def is_suspect(reynolds: float, component: str, station: float) -> bool:
    return (int(round(reynolds)), component, station) in SUSPECT_STATIONS


def has_reynolds(reynolds: float) -> bool:
    """Is this Reynolds number covered by the Ghia tables?"""
    return int(round(reynolds)) in RE_VALUES


def re_index(reynolds: float) -> int:
    """Column index for a supported Reynolds number."""
    re_int = int(round(reynolds))
    if re_int not in RE_VALUES:
        raise KeyError(
            f"no Ghia data for Re={reynolds}; available: {RE_VALUES}"
        )
    return RE_VALUES.index(re_int)


def ux_table(reynolds: float) -> tuple[np.ndarray, np.ndarray]:
    """(y positions ascending from bottom, Ux values) for one Re."""
    i = re_index(reynolds)
    ys = np.array(sorted(UX_MID_COLUMN))
    return ys, np.array([UX_MID_COLUMN[y][i] for y in ys])


def uy_table(reynolds: float) -> tuple[np.ndarray, np.ndarray]:
    i = re_index(reynolds)
    xs = np.array(sorted(UY_MID_ROW))
    return xs, np.array([UY_MID_ROW[x][i] for x in xs])


def vortex_table(reynolds: float) -> dict[str, tuple[float, float]]:
    """Existing vortex centers {name: (x, y)} for one Re."""
    i = re_index(reynolds)
    out = {}
    for name, ax in VORTICES.items():
        x, y = ax["x"][i], ax["y"][i]
        if x != 0.0 or y != 0.0:
            out[name] = (x, y)
    return out
