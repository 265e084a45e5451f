"""The port's ``CavityCNN`` against the JAX package's flax model on the CPU:
the forward pass of the presets at 192^2 (``test_torch_ml_models_384.py``
has those at 384^2 and the committed weights) with the flax parameters
carried across by ``state_dict_from_flax``, and its layers one by one.

Tolerance rtol 1e-4, atol 1e-5 in float32: the same convolutions summed in
another order by another library (XLA's CPU convolutions against
PyTorch's)."""

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch.ml import models
from latticeboltzmannsimulations_tpu.ml import models as jmodels

RTOL, ATOL = 1e-4, 1e-5


def _inputs(preset, res, batch=2, seed=0):
    """Seeded NHWC inputs: the 10 fnet planes and, for the presets that
    join them, the 2 aux planes."""
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
                                  if p.resolution == 192])
def test_preset_matches_flax_forward(name):
    """At the smallest grid of the preset's stride pyramid: flax's
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


@pytest.mark.parametrize("n, k, s", [
    (48, 4, 1), (16, 4, 3), (48, 2, 1), (48, 8, 1), (48, 12, 1), (48, 12, 12),
    (96, 3, 3), (17, 4, 4),
])
def test_same_padding_is_xla_same(n, k, s):
    """The convolution's SAME padding, asymmetric for an odd total, against
    the padding XLA takes for 'SAME'."""
    from jax._src.lax import lax as jlax

    assert models.same_padding(n, k, s) == tuple(jlax.padtype_to_pads((n,), (k,), (s,),
                                                                      "SAME")[0])


@pytest.mark.parametrize("k, s", [(4, 1), (4, 3), (2, 2), (3, 3), (4, 4), (12, 12), (2, 5)])
def test_transposed_convolution_matches_flax(k, s):
    """One flax ``ConvTranspose`` (SAME, kernel not flipped), k = s and
    k != s, against ``_ConvTranspose`` with the converted kernel."""
    import flax.linen as nn

    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((1, 5, 7, 3)).astype(np.float32)
    layer = nn.ConvTranspose(4, (k, k), strides=(s, s), padding="SAME")
    params = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.PRNGKey(1), x))
    params["params"]["bias"] = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(layer.apply(params, x))
    conv = models._ConvTranspose(3, 4, k, s)
    kernel = params["params"]["kernel"]
    conv.weight.data = torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    conv.bias.data = torch.from_numpy(params["params"]["bias"].copy())
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=RTOL, atol=ATOL)


def test_state_dict_from_flax_refuses_parameters_of_another_preset():
    params = {"enc0": {"kernel": np.zeros((2, 2, 10, 16), np.float32),
                       "bias": np.zeros(16, np.float32)}}
    with pytest.raises(ValueError, match="do not fit cnn_one"):
        models.state_dict_from_flax(models.PRESETS["cnn_one"], params)


def test_forward_refuses_missing_aux_planes():
    model = models.make_model("cnn_eight")
    with pytest.raises(ValueError, match="aux"):
        model(torch.zeros(1, 192, 192, 10))
