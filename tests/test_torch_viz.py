"""The port's host diagnostics against the JAX package's: vortex centres,
the run dashboard and the surrogate's comparison figure (matplotlib, Agg),
on the same seeded fields."""

import numpy as np
import pytest

from latticeboltzmannsimulations_torch import viz as t_viz
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.ml import predict as t_predict
from latticeboltzmannsimulations_torch.validate import find_vortex_centers as t_centers
from latticeboltzmannsimulations_tpu import viz as j_viz
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.ml import predict as j_predict
from latticeboltzmannsimulations_tpu.validate import find_vortex_centers as j_centers

PNG = b"\x89PNG\r\n\x1a\n"
N = 48


def _cavity_like(seed: int, n: int = N) -> np.ndarray:
    """A smooth primary vortex with two weaker corner eddies and a little
    seeded noise, ``u (2, n, n)``, lid at y index 0."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    psi = (np.sin(np.pi * x) * np.sin(np.pi * y)) ** 2
    psi += 0.05 * np.sin(3 * np.pi * x) * np.sin(2 * np.pi * y)
    uy, ux = np.gradient(psi)
    u = np.stack([0.08 * ux * n, -0.08 * uy * n])
    return u + 1e-4 * rng.standard_normal(u.shape)


@pytest.mark.parametrize("n_vortices, bc_offset", [(2, None), (4, None), (4, 3), (60, 8)])
def test_find_vortex_centers_matches_jax(n_vortices, bc_offset):
    for seed in (0, 1):
        u = _cavity_like(seed)
        got = t_centers(u, n_vortices=n_vortices, bc_offset=bc_offset)
        assert got == j_centers(u, n_vortices=n_vortices, bc_offset=bc_offset)
        assert 1 <= len(got) <= n_vortices


def test_dashboard_renders_the_jax_png(tmp_path):
    u = _cavity_like(2)
    rho = 1.0 + 1e-3 * np.random.default_rng(5).standard_normal((N, N))
    hist = [(100, 0.5), (200, 0.9)]
    kw = dict(nx=N, ny=N, reynolds=100.0)
    a = t_viz.dashboard(TConfig(**kw), rho, u, 200, hist, out_dir=str(tmp_path / "port"))
    b = j_viz.dashboard(JConfig(**kw), rho, u, 200, hist, out_dir=str(tmp_path / "jax"))
    assert a.endswith("ldc_000200.png")
    png = open(a, "rb").read()
    assert png.startswith(PNG) and png == open(b, "rb").read()


def test_comparison_figure_matches_jax(tmp_path):
    u_lbm, u_cnn = _cavity_like(3), _cavity_like(4)
    kw = dict(nx=N, ny=N, reynolds=100.0, collision="srt")
    got = t_predict.comparison_figure(TConfig(**kw), u_lbm, u_cnn, str(tmp_path / "p" / "f.png"))
    want = j_predict.comparison_figure(JConfig(**kw), u_lbm, u_cnn, str(tmp_path / "j" / "f.png"))
    assert got.pop("figure") == str(tmp_path / "p" / "f.png")
    want.pop("figure")
    assert sorted(got) == sorted(want) == ["cnn_vs_lbm_l2", "l2_cnn", "l2_lbm", "r2_cnn_ux",
                                           "r2_lbm_ux"]
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-12), key
    assert open(tmp_path / "p" / "f.png", "rb").read().startswith(PNG)
