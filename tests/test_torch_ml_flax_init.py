"""The port's initial draw (``ml.flax_init``) against JAX's and flax's on the
CPU: ``jax.random``'s bits, ``fold_in``, ``uniform``, ``erf_inv`` and
``truncated_normal``, flax's key per parameter, ``jax.nn.initializers``'
two initialisers, the whole draw of every preset, and ``train(seed=0)``
from it against JAX's ``train(seed=0)``.

Tolerance: none for the draw.  Every value equals JAX's eager evaluation
on the CPU bit for bit (flax's ``lazy_init`` runs the initialisers as
``init`` does, eagerly, without the forward pass).  The training losses
rel 1e-4, as ``test_torch_ml_jax_init.py`` holds a run from the same
parameters: the same steps in another library's convolutions."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import LazyRng
from jax import lax

from latticeboltzmannsimulations_torch.ml import datagen, flax_init, flax_msgpack, models, train
from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen
from latticeboltzmannsimulations_tpu.ml import models as jmodels
from latticeboltzmannsimulations_tpu.ml import train as jtrain

SEEDS = (0, 1, 7, 2**31 - 1)
SHAPES = ((1,), (3, 5, 7), (2, 3, 11_000))      # one value, an odd count, above 2^16
BOUNDS = ((0.0, 1.0), (-1.0, 1.0), (-0.3, 2.5))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_fold_in_and_uniform_equal_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    port_key = flax_init.prng_key(seed)
    assert port_key == tuple(int(v) for v in np.asarray(key))
    bits = flax_init.random_bits(port_key, shape)
    assert bits.dtype == np.uint32 and bits.shape == shape
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    for lo, hi in BOUNDS:
        got = flax_init.uniform(port_key, shape, lo, hi)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi)))
    for data in (0, 1, int(np.prod(shape)), 2**32 - 1):
        want = jax.random.fold_in(key, jnp.uint32(data))
        assert flax_init.fold_in(port_key, data) == tuple(int(v) for v in np.asarray(want))


def test_erfinv_and_truncated_normal_equal_xla():
    """``erfinv`` on seeded float32 values, both of Giles' branches (w < 5 up
    to |u| = 0.9966, w >= 5 beyond), against ``lax.erf_inv``; the truncated
    normal of the kernels' bounds and of others against
    ``jax.random.truncated_normal``."""
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.uniform(-1, 1, 200_000), rng.uniform(0.9966, 1, 20_000),
                        -rng.uniform(0.9966, 1, 20_000)]).astype(np.float32)
    u = u[np.abs(u) < 1]
    np.testing.assert_array_equal(flax_init.erfinv(u), np.asarray(jax.jit(lax.erf_inv)(u)))
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        for lo, hi in ((-2.0, 2.0), (-1.0, 3.0)):
            want = jax.random.truncated_normal(key, lo, hi, (70_001,), jnp.float32)
            np.testing.assert_array_equal(
                flax_init.truncated_normal(flax_init.prng_key(seed), lo, hi, (70_001,)),
                np.asarray(want))


@pytest.mark.parametrize("layer", ["enc0", "ms12", "dec_b_deconv4", "head1"])
def test_param_key_is_flaxs(layer):
    """flax's key for a child module's first and second ``self.param``."""
    for seed in (0, 3):
        for count in (1, 2, 300):
            want = LazyRng.create(jax.random.PRNGKey(seed), layer, count).as_jax_rng()
            got = flax_init.param_key(flax_init.prng_key(seed), layer, count)
            assert got == tuple(int(v) for v in np.asarray(want)), (layer, count)


@pytest.mark.parametrize("kernel_init", ["lecun_normal", "glorot_uniform"])
def test_variance_scaling_equals_jaxs_initialisers(kernel_init):
    """Kernels of a convolution's shapes, and of a layer with one input."""
    init = getattr(jax.nn.initializers, kernel_init)()
    for shape in ((12, 12, 10, 128), (3, 3, 128, 256), (1, 1, 16, 1), (2, 2, 512, 256)):
        key = jax.random.PRNGKey(5)
        got = flax_init.variance_scaling(flax_init.prng_key(5), shape, kernel_init)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, np.asarray(init(key, shape, jnp.float32)))


def _flax_params(name: str, kernel_init: str, seed: int) -> dict:
    """flax's draw of the JAX package's preset, as ``init`` makes it, without
    the forward pass (the shapes do not depend on the grid: the smallest of
    the stride pyramid)."""
    preset = jmodels.PRESETS[name]
    sp = jmodels.stride_product(preset)
    args = [jax.ShapeDtypeStruct((1, sp, sp, c), jnp.float32)
            for c in (10, 2)[:2 if preset.aux_bc_at_input or preset.aux_bc_at_head else 1]]
    model = jmodels.make_model(name, kernel_init=kernel_init)
    return jax.device_get(model.lazy_init(jax.random.PRNGKey(seed), *args)["params"])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kernel_init", ["lecun_normal", "glorot_uniform"])
@pytest.mark.parametrize("name", list(jmodels.PRESETS))
def test_make_model_draws_flaxs_init(name, kernel_init, seed):
    """``make_model(name, kernel_init=..., seed=s)`` holds the parameters of
    flax's ``init(PRNGKey(s))`` of the JAX package's model, layer for layer."""
    want = models.state_dict_from_flax(models.PRESETS[name], _flax_params(name, kernel_init, seed))
    got = models.make_model(name, kernel_init=kernel_init, seed=seed).state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_cnn_nine_seed0_is_the_committed_draw():
    """The committed ``PRNGKey(0)`` draw of ``cnn_nine`` (flax's eager
    ``init``) is ``flax_init.init_params``' bit for bit, without JAX."""
    committed = flax_msgpack.load(
        "docs/artifacts/torch/init/cnn_nine_prngkey0.msgpack")
    drawn = flax_init.init_params(models.PRESETS["cnn_nine"], 0)
    assert set(drawn) == set(committed)
    for layer, leaf in committed.items():
        for p, want in leaf.items():
            assert drawn[layer][p].dtype == want.dtype == np.float32
            np.testing.assert_array_equal(drawn[layer][p], want, err_msg=f"{layer}.{p}")


def _dataset(module, n=5, res=192, seed=5):
    """``test_torch_ml_jax_init.py``'s seeded cavities: 4 train, 1 validates."""
    rng = np.random.default_rng(seed)
    return module.DatasetArrays(
        re_range=np.linspace(100.0, 2000.0, n),
        feq_initial=rng.uniform(0.0, 0.5, (9, res, res)).astype(np.float32),
        f_final=np.zeros((n, 9, res, res), np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, res, res))).astype(np.float32),
        failed=None)


def test_train_seed0_matches_jax_train_seed0():
    """``cnn_nine``'s x half for one epoch of two steps, Adam at lr 1e-3,
    with no ``init_params`` on either side: the port's ``train(seed=0)``
    starts from JAX's draw and takes JAX's shuffle, so its losses are
    JAX's."""
    name = "cnn_nine"
    kw = dict(component="x", epochs=1, batch_size=2, learning_rate=1e-3, optimizer="adam",
              seed=0)
    jdata = jtrain.prepare_inputs(_dataset(jdatagen), jmodels.PRESETS[name])
    want = jtrain.train(name, jdata, **kw).history
    data = train.prepare_inputs(_dataset(datagen), models.PRESETS[name])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = train.train(name, data, device="cpu", **kw).history
    finally:
        torch.set_num_threads(threads)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-4)


def _copy_with_recipe(src, dst, edit) -> None:
    """The checkpoint ``src`` written to ``dst`` with its header's recipe
    passed through ``edit``, its blob as it was."""
    with open(src, "rb") as fh:
        header = json.loads(fh.read(int.from_bytes(fh.read(8), "little")))
        blob = fh.read()
    header["recipe"] = edit(header["recipe"])
    raw = json.dumps(header).encode()
    with open(dst, "wb") as fh:
        fh.write(len(raw).to_bytes(8, "little") + raw + blob)


def test_a_checkpoint_of_the_former_draw_is_not_resumed(tmp_path, capsys):
    """A ``.ckpt`` whose recipe names no draw (the port's before it drew as
    flax does) is refused and the run starts fresh; the same checkpoint
    with the recipe that names the draw resumes to the uninterrupted run."""
    data = train.prepare_inputs(_dataset(datagen, res=48), models.PRESETS["cnn_one"])
    kw = dict(component="x", batch_size=2, learning_rate=1e-3, device="cpu")
    ckpt, former = str(tmp_path / "run.ckpt"), str(tmp_path / "former.ckpt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.train("cnn_one", data, epochs=1, checkpoint_path=ckpt, checkpoint_every=1, **kw)
        _copy_with_recipe(ckpt, former, lambda r: {k: v for k, v in r.items() if k != "init"})
        whole = train.train("cnn_one", data, epochs=2, **kw).history
        capsys.readouterr()
        refused = train.train("cnn_one", data, epochs=2, checkpoint_path=former, **kw).history
        assert "starting fresh" in capsys.readouterr().out
        resumed = train.train("cnn_one", data, epochs=2, checkpoint_path=ckpt, **kw).history
        assert "starting fresh" not in capsys.readouterr().out
    finally:
        torch.set_num_threads(threads)
    assert refused == whole and resumed == whole
