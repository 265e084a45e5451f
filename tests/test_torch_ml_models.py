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

from latticeboltzmannsimulations_torch.ml import models, train
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


@pytest.mark.parametrize("name", ["cnn_nine", "cnn_ten"])
def test_initial_weights_have_flaxs_distribution(name):
    """The port's draw (``reset_parameters``, seed 0; flax's own sample,
    which ``test_torch_ml_flax_init.py`` holds bit for bit) against flax's
    jitted ``model.init(PRNGKey(0))`` of the JAX package, layer by layer: each
    kernel's standard deviation, and the other's, within six standard
    errors of a sample deviation (6 / sqrt(2n) relative) of LeCun normal's
    sqrt(1 / fan_in), with flax's fan_in (kernel height x width x input
    features, for a transposed convolution too); every value inside the
    truncation at two deviations of the underlying normal, the largest
    within 5 % of it where a layer has 1 000 values or more; the mean within
    six standard errors of 0; every bias zero.  The parameters' shapes do
    not depend on the grid: flax's init runs, jitted, at the smallest grid
    of the stride pyramid (192^2)."""
    import jax.numpy as jnp

    preset = jmodels.PRESETS[name]
    args = [jnp.zeros((1, *(2 * (jmodels.stride_product(preset),)), c), jnp.float32)
            for c in (10, 2)[:2 if preset.aux_bc_at_input or preset.aux_bc_at_head else 1]]
    # XLA's cheapest compile: the draws agree with the default compile's to
    # 2.1e-7 of a layer's largest value (float rounding), the compile takes
    # a third of the time
    init = jax.jit(jmodels.make_model(name).init, compiler_options={
        "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    flax = init(jax.random.PRNGKey(0), *args)["params"]
    port = models.make_model(name, seed=0).state_dict()
    assert set(port) == {f"{layer}.{p}" for layer in flax for p in ("weight", "bias")}
    for layer, leaf in flax.items():
        kernel = np.asarray(leaf["kernel"], np.float64)
        drawn = port[f"{layer}.weight"].double().numpy()
        n = kernel.size
        std = np.sqrt(1.0 / np.prod(kernel.shape[:-1]))
        cut = 2 * std / 0.87962566103423978
        tol = 6 / np.sqrt(2 * n)
        assert drawn.size == n, layer
        for w in (drawn, kernel):
            assert abs(w.std() / std - 1) <= tol, (layer, w.std(), std)
            assert np.abs(w).max() <= cut * (1 + 1e-6), layer
            assert n < 1000 or np.abs(w).max() >= 0.95 * cut, layer
            assert abs(w.mean()) <= 6 * std / np.sqrt(n), layer
        assert abs(drawn.std() / kernel.std() - 1) <= 2 * tol, layer
        assert not np.asarray(leaf["bias"]).any() and not port[f"{layer}.bias"].any(), layer


# --- the 384^2 presets' training step against JAX's ------------------------------

GRAD_F64 = 1e-5         # float64 both sides: per-leaf relative norm
GRAD_F32_PLAIN = 1e-4   # float32, the port's convolutions without oneDNN
GRAD_F32 = 1e-2         # float32 as the port runs on the CPU (oneDNN's convolutions)


def _rel_norms(got: dict, want: dict) -> dict:
    """Each leaf's ``|got - want| / |want|`` (2-norms over the leaf)."""
    return {k: float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])) for k in want}


@pytest.mark.parametrize("name", ["cnn_eight", "cnn_nine", "cnn_ten"])
def test_384_preset_step_matches_jax_value_and_grad(name):
    """The 384^2 presets (aux-BC planes at the input and the head, the
    multiscale front, the twin decoders, leaky ReLU) at 192^2, their stride
    product: a seeded batch of 2 with its aux planes and flax's
    ``init(PRNGKey(0))`` carried across by ``state_dict_from_flax``; the
    port's loss (``train._mse``) and each leaf's gradient (``backward``)
    against ``jax.value_and_grad`` of JAX ``train``'s loss, leaf by leaf as
    a relative 2-norm over the leaf (an elementwise bound is no measure
    where a leaf's gradients are near 1e-7).

    - float64 on both sides (``compute_dtype``; ``head1`` stays float32 in
      both models): the loss to rel 1e-9, every leaf to ``GRAD_F64`` (read:
      at most 2.0e-6, in ``head1``'s bias, the float32 layer; every other
      leaf within 1.4e-7).  The same arithmetic: a wrong layer, padding or
      joined plane would show at order 1.
    - float32, the port's convolutions without oneDNN: the loss to rel
      1e-6, every leaf to ``GRAD_F32_PLAIN`` (read: at most 5.4e-6; each
      side within 3e-6 of the float64 gradient).
    - float32 as the port runs on the CPU: every leaf to ``GRAD_F32``.
      oneDNN's CPU float32 convolutions move ``cnn_nine``'s ``dec_b``
      decoder gradients (norms near 2e-5) by up to 1.3e-3 of their norm
      from the float64 gradient (read: 1.3e-3 in ``dec_b_deconv2``'s
      kernel); without oneDNN the same leaves lie within 1e-6 of it.  That
      is the CPU library's summation, not the port's arithmetic; on the
      card the port runs cuDNN."""
    import jax.numpy as jnp

    preset = jmodels.PRESETS[name]
    n = jmodels.stride_product(preset)
    x, aux = _inputs(preset, n)
    y = np.random.default_rng(1).standard_normal((2, n, n, 1)).astype(np.float32)
    params = jax.device_get(jmodels.make_model(name).init(jax.random.PRNGKey(0), x, aux)
                            ["params"])
    sd = models.state_dict_from_flax(models.PRESETS[name], params)

    def jax_step(dtype):
        model = jmodels.make_model(name, compute_dtype=dtype)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        args = [jnp.asarray(a, dtype) for a in (x, aux, y)]

        def loss_fn(p):
            return jnp.mean((model.apply({"params": p}, *args[:2]) - args[2]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        grads = models.state_dict_from_flax(models.PRESETS[name], jax.device_get(grads))
        return float(loss), {k: v.double().numpy() for k, v in grads.items()}

    def port_step(dtype, onednn=True):
        model = models.make_model(name, compute_dtype=dtype).to(dtype)
        model.load_state_dict(sd)
        with torch.backends.mkldnn.flags(enabled=onednn):
            loss = train._mse(model, *(torch.from_numpy(a).to(dtype) for a in (x, aux, y)))
            loss.backward()
        return float(loss.detach()), {k: p.grad.double().numpy()
                                     for k, p in model.named_parameters()}

    (jl64, jg64), (pl64, pg64) = jax_step(jnp.float64), port_step(torch.float64)
    assert pl64 == pytest.approx(jl64, rel=1e-9)
    assert set(pg64) == set(jg64) == set(sd)
    worst = _rel_norms(pg64, jg64)
    assert max(worst.values()) <= GRAD_F64, max(worst.items(), key=lambda kv: kv[1])
    jl32, jg32 = jax_step(jnp.float32)
    pl32, pg32 = port_step(torch.float32, onednn=False)
    assert pl32 == pytest.approx(jl32, rel=1e-6)
    worst = _rel_norms(pg32, jg32)
    assert max(worst.values()) <= GRAD_F32_PLAIN, max(worst.items(), key=lambda kv: kv[1])
    _, pg32 = port_step(torch.float32)
    worst = _rel_norms(pg32, jg32)
    assert max(worst.values()) <= GRAD_F32, max(worst.items(), key=lambda kv: kv[1])
