"""The port's population-level walls against the JAX package's
``ops/boundary.py``, on the same random fields made with numpy from a seed.

Tolerance: float64 to 1e-12 (the same formulas in the same order; only the
corner sums of the tangential lid may add in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch.ops import boundary as t_bc
from latticeboltzmannsimulations_tpu.ops import boundary as j_bc

TOL = 1e-12
U_LID = 0.08


def _fields(nx=12, ny=10, seed=0):
    """Three (9, X, Y) float64 fields: streamed f, feq and the pre-streaming
    fpost, each a unit-scale positive field with seeded noise."""
    rng = np.random.default_rng(seed)
    return [0.1 + 0.01 * rng.standard_normal((9, nx, ny)) for _ in range(3)]


def _both(fn_t, fn_j, arrays, *args):
    out_t = fn_t(*(torch.tensor(a) for a in arrays), *args)
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), *args)
    return out_t.numpy(), np.asarray(out_j)


@pytest.mark.parametrize("wall", ["nebb", "nebb_west_eq"])
def test_nebb_walls_match_jax(wall):
    f, feq, _ = _fields()
    got, want = _both(getattr(t_bc, wall), getattr(j_bc, wall), (f, feq))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert not np.array_equal(got, f)  # the walls rewrote something


def test_nebb_tangential_matches_jax():
    f, feq, _ = _fields(seed=1)
    got, want = _both(t_bc.nebb_tangential, j_bc.nebb_tangential, (f, feq), U_LID)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bounce_back_matches_jax():
    f, _, fpost = _fields(seed=2)
    got, want = _both(t_bc.bounce_back, j_bc.bounce_back, (f, fpost), U_LID)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # The lid-corner closure: static halfway bounce-back at both corners.
    nx = f.shape[1]
    np.testing.assert_array_equal(got[[4, 7], 0, 0], fpost[[2, 5], 0, 0])
    np.testing.assert_array_equal(got[[4, 8], nx - 1, 0], fpost[[2, 6], nx - 1, 0])


@pytest.mark.parametrize("variant", ["nebb", "nebb_west_eq", "nebb_tangential",
                                     "bounce_back"])
def test_apply_matches_jax_and_leaves_inputs_alone(variant):
    f, feq, fpost = _fields(nx=9, ny=14, seed=3)
    t_in = [torch.tensor(a) for a in (f, feq, fpost)]
    kept = [t.clone() for t in t_in]
    got = t_bc.apply(t_in[0], t_in[1], variant, U_LID, fpost=t_in[2]).numpy()
    want = np.asarray(j_bc.apply(jnp.asarray(f), jnp.asarray(feq), variant, U_LID,
                                 fpost=jnp.asarray(fpost)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for t, k in zip(t_in, kept):
        assert torch.equal(t, k)


def test_apply_refusals():
    f, feq, _ = (torch.tensor(a) for a in _fields())
    with pytest.raises(ValueError, match="pre-streaming"):
        t_bc.apply(f, feq, "bounce_back", U_LID)
    with pytest.raises(ValueError, match="unknown"):
        t_bc.apply(f, feq, "zou_he", U_LID)


def test_corners_chain_in_kernel_order():
    """Left, right, bottom, lid: at the bottom-left corner the bottom wall's
    f6 reads the f8 that the left wall wrote, and at the top-right corner
    the lid's f8 reads the f6 that the right wall wrote."""
    f, feq, _ = _fields(seed=4)
    out = t_bc.nebb(torch.tensor(f), torch.tensor(feq)).numpy()
    nx, ny = f.shape[1], f.shape[2]
    e = feq[:, 0, ny - 1]
    left_8 = e[8] - e[6] + f[6, 0, ny - 1]
    assert out[8, 0, ny - 1] == left_8
    assert out[6, 0, ny - 1] == e[6] - e[8] + left_8
    e = feq[:, nx - 1, 0]
    right_6 = e[6] - e[8] + f[8, nx - 1, 0]
    assert out[6, nx - 1, 0] == right_6
    assert out[8, nx - 1, 0] == e[8] - e[6] + right_6
