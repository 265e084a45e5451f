"""Collision operators: SRT/BGK, TRT and MRT (Gram-Schmidt moment space), plus
the Smagorinsky subgrid relaxation-time modifier (the JAX package's
``ops/collision.py`` in PyTorch).

``omega`` arguments may be Python floats or ``(X, Y)`` fields (the LES case),
thanks to broadcasting.
"""

from __future__ import annotations

import torch

from .. import lattice


def srt_collide(f: torch.Tensor, feq: torch.Tensor, omega) -> torch.Tensor:
    """BGK single-relaxation-time collision (reference: MRT.py:396)."""
    return f - omega * (f - feq)


def _plus_minus(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split into symmetric / antisymmetric parts along opposite directions.

    f+_k = (f_k + f_kbar)/2, f-_k = (f_k - f_kbar)/2 (reference: MRT.py:296-311).
    """
    fb = f[torch.as_tensor(lattice.OPP, dtype=torch.long, device=f.device)]
    return 0.5 * (f + fb), 0.5 * (f - fb)


def trt_collide(f: torch.Tensor, feq: torch.Tensor, omega_plus, omega_minus) -> torch.Tensor:
    """Two-relaxation-time collision (reference: MRT_GPU.py:426-531).

    f' = f - w+ (f+ - feq+) - w- (f- - feq-)
    """
    fp, fm = _plus_minus(f)
    fep, fem = _plus_minus(feq)
    return f - omega_plus * (fp - fep) - omega_minus * (fm - fem)


def mrt_moments(f: torch.Tensor) -> torch.Tensor:
    """Transform to Gram-Schmidt moment space, m = M f, as unrolled
    integer-coefficient sums."""
    s_all = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8]
    s_ax = f[1] + f[2] + f[3] + f[4]
    s_di = f[5] + f[6] + f[7] + f[8]
    jx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    jy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return torch.stack(
        [
            s_all,
            -4.0 * f[0] - s_ax + 2.0 * s_di,                       # e
            4.0 * f[0] - 2.0 * s_ax + s_di,                        # eps
            jx,
            -2.0 * (f[1] - f[3]) + f[5] - f[6] - f[7] + f[8],      # qx
            jy,
            -2.0 * (f[2] - f[4]) + f[5] + f[6] - f[7] - f[8],      # qy
            f[1] - f[2] + f[3] - f[4],                             # pxx
            f[5] - f[6] + f[7] - f[8],                             # pxy
        ]
    )


def mrt_moment_equilibrium(rho: torch.Tensor, jx: torch.Tensor, jy: torch.Tensor) -> torch.Tensor:
    """Moment-space equilibria (reference: MRT_GPU.py:636-644).

    Follows the reference in using raw momentum j (not j/rho) in the
    nonlinear terms, including its cubic q-moment closure 3 j^3 and the
    9 jx^2 jy^2 term in eps.
    """
    jx2 = jx * jx
    jy2 = jy * jy
    return torch.stack(
        [
            rho,
            -2.0 * rho + 3.0 * (jx2 + jy2),
            rho - 3.0 * (jx2 + jy2) + 9.0 * jx2 * jy2,
            jx,
            -jx + 3.0 * jx2 * jx,
            jy,
            -jy + 3.0 * jy2 * jy,
            jx2 - jy2,
            jx * jy,
        ]
    )


def mrt_from_moments(m: torch.Tensor) -> torch.Tensor:
    """Inverse transform f = M^-1 m, unrolled with exact rational coefficients."""
    r = m[0] / 9.0
    e = m[1]
    eps = m[2]
    jx, qx, jy, qy = m[3], m[4], m[5], m[6]
    pxx, pxy = m[7], m[8]
    e36, eps36 = e / 36.0, eps / 36.0
    f0 = r - 4.0 * e36 + 4.0 * eps36
    ax_e = -e36 - 2.0 * eps36          # axis populations: -e/36 - eps/18
    di_e = 2.0 * e36 + eps36           # diagonal populations: e/18 + eps/36
    f1 = r + ax_e + (jx / 6.0 - qx / 6.0) + pxx / 4.0
    f2 = r + ax_e + (jy / 6.0 - qy / 6.0) - pxx / 4.0
    f3 = r + ax_e + (-jx / 6.0 + qx / 6.0) + pxx / 4.0
    f4 = r + ax_e + (-jy / 6.0 + qy / 6.0) - pxx / 4.0
    f5 = r + di_e + (jx + jy) / 6.0 + (qx + qy) / 12.0 + pxy / 4.0
    f6 = r + di_e + (-jx + jy) / 6.0 + (-qx + qy) / 12.0 - pxy / 4.0
    f7 = r + di_e + (-jx - jy) / 6.0 + (-qx - qy) / 12.0 + pxy / 4.0
    f8 = r + di_e + (jx - jy) / 6.0 + (qx - qy) / 12.0 - pxy / 4.0
    return torch.stack([f0, f1, f2, f3, f4, f5, f6, f7, f8])


def mrt_collide(
    f: torch.Tensor,
    omega_nu,
    omega_e: float = 1.0,
    omega_eps: float = 1.0,
    omega_q: float = 1.2,
) -> torch.Tensor:
    """MRT collision in moment space (reference: MRT_GPU.py:633-658).

    m' = m - diag(omega_vec) (m - meq);  conserved moments (rho, jx, jy) are
    untouched.  ``omega_nu`` may be an (X, Y) field (Smagorinsky).
    """
    m = mrt_moments(f)
    rho, jx, jy = m[0], m[3], m[5]
    meq = mrt_moment_equilibrium(rho, jx, jy)
    d = m - meq
    m_post = torch.stack(
        [
            m[0],
            m[1] - omega_e * d[1],
            m[2] - omega_eps * d[2],
            m[3],
            m[4] - omega_q * d[4],
            m[5],
            m[6] - omega_q * d[6],
            m[7] - omega_nu * d[7],
            m[8] - omega_nu * d[8],
        ]
    )
    return mrt_from_moments(m_post)


def smagorinsky_tau(
    f: torch.Tensor,
    feq: torch.Tensor,
    rho: torch.Tensor,
    tau0: float,
    cs2=0.025,
) -> torch.Tensor:
    """Effective relaxation time with Smagorinsky eddy viscosity.

    tau_eff = (tau0 + sqrt(tau0^2 + 18*sqrt(2)*Cs^2*|Q_xy|/rho)) / 2
    using the off-diagonal non-equilibrium momentum flux (reference:
    MRT_GPU.py:378-385, with the fixed Cs^2 = 0.025 override at :376).
    ``cs2`` may be a scalar or an (X, Y) field (Van Driest damping).
    """
    fneq = f - feq
    q_xy = fneq[5] - fneq[6] + fneq[7] - fneq[8]
    disc = tau0 * tau0 + (18.0 * (2.0 ** 0.5) * cs2 * torch.abs(q_xy)) / rho
    return 0.5 * (tau0 + torch.sqrt(disc))


def van_driest_cs2(
    nx: int,
    ny: int,
    visc_inv: float,
    cs_bulk: float = 0.16,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Van-Driest-damped Smagorinsky constant field Cs^2(x, y).

    Cs = Cs_bulk * (1 - exp(-Z+/26)) with Z+ the wall distance scaled by the
    viscous length (reference: MRT_GPU.py:372-375; MRT.py:488-492).
    ``visc_inv`` is the inverse viscous length scale.
    """
    x = torch.arange(nx, dtype=dtype, device=device)[:, None]
    y = torch.arange(ny, dtype=dtype, device=device)[None, :]
    dist = torch.minimum(
        torch.minimum(x, (nx - 1) - x), torch.minimum(y, (ny - 1) - y)
    )
    z_plus = dist * visc_inv
    cs = cs_bulk * (1.0 - torch.exp(-z_plus / 26.0))
    return cs * cs
