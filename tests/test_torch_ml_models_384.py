"""The port's ``CavityCNN`` against the JAX package's flax model on the CPU,
continued from ``test_torch_ml_models.py`` (a second file, so that the
flax compilations run on two workers): the presets at 384^2 and the
trained weights committed under ``docs/artifacts`` where they are present.

Tolerance rtol 1e-4, atol 1e-5 in float32: the same convolutions summed in
another order by another library (XLA's CPU convolutions against
PyTorch's)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch.ml import models
from latticeboltzmannsimulations_tpu.ml import models as jmodels

RTOL, ATOL = 1e-4, 1e-5
WEIGHTS = (Path(__file__).resolve().parent.parent / "docs" / "artifacts"
           / "ml_early_ref_budget" / "cnn_one_192" / "cnn_one_x.msgpack")


def _inputs(preset, res, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, res, res, 10)).astype(np.float32)
    if preset.aux_bc_at_input or preset.aux_bc_at_head:
        return x, rng.standard_normal((batch, res, res, 2)).astype(np.float32)
    return (x,)


def _torch_forward(name, params, args):
    model = models.make_model(name)
    model.load_state_dict(models.state_dict_from_flax(models.PRESETS[name], params))
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("name", [n for n, p in jmodels.PRESETS.items()
                                  if p.resolution == 384])
def test_preset_matches_flax_forward(name):
    """At the smallest grid of the preset's stride pyramid (192^2): flax's
    ``init`` and ``apply``, then the same parameters through the port."""
    preset = jmodels.PRESETS[name]
    assert models.PRESETS[name] == models.CNNPreset(**vars(preset))
    args = _inputs(preset, jmodels.stride_product(preset))
    flax_model = jmodels.make_model(name)
    params = flax_model.init(jax.random.PRNGKey(0), *args)["params"]
    want = np.asarray(flax_model.apply({"params": params}, *args))
    got = _torch_forward(name, jax.tree_util.tree_map(np.asarray, params), args)
    assert got.shape == want.shape == (2, *args[0].shape[1:3], 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_committed_weights_match_flax_forward():
    """The trained ``cnn_one`` x-component weights, restored by
    ``flax.serialization``, converted, and run on a 192^2 input."""
    if not WEIGHTS.exists():
        pytest.skip(f"the trained weights are not in this checkout ({WEIGHTS.name})")
    from flax import serialization

    params = serialization.msgpack_restore(WEIGHTS.read_bytes())
    args = _inputs(models.PRESETS["cnn_one"], 192, batch=1, seed=1)
    want = np.asarray(jmodels.make_model("cnn_one").apply({"params": params}, *args))
    np.testing.assert_allclose(_torch_forward("cnn_one", params, args), want,
                               rtol=RTOL, atol=ATOL)
