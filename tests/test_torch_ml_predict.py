"""The port's serving path against the JAX package's on the CPU:
``train.prepare_inputs``, ``predict.build_input`` and
``predict.predict_velocity`` with the same weights carried across by
``models.state_dict_from_flax``, and ``predict.lbm_reference``.

Tolerances: the assembled inputs byte for byte (the same NumPy on the
same arrays); the prediction rtol 1e-4, atol 1e-5 (float32 convolutions
summed in another order); the LBM reference in float64 to 1e-12."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.ml import datagen, models, predict, train
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen
from latticeboltzmannsimulations_tpu.ml import models as jmodels
from latticeboltzmannsimulations_tpu.ml import predict as jpredict
from latticeboltzmannsimulations_tpu.ml import train as jtrain

RTOL, ATOL = 1e-4, 1e-5
WEIGHTS = (Path(__file__).resolve().parent.parent / "docs" / "artifacts"
           / "ml_early_ref_budget" / "cnn_one_192" / "cnn_one_x.msgpack")


@pytest.fixture(scope="module")
def small_dataset():
    """A 48^2 sweep of three Re through the port's ``generate_dataset``
    (float32, the plain batched engine), the middle cavity marked failed
    so that the inputs drop it."""
    cfg = SimConfig(nx=48, ny=48, collision="srt", max_steps=200, report_interval=100,
                    convergence_tol=1e-5, convergence_hits=2)
    ds = datagen.generate_dataset(cfg, re_values=np.array([100.0, 150.0, 200.0]),
                                  batch_size=3, device="cpu")
    ds.failed = np.array([False, True, False])
    return cfg, ds


def _random_dataset(res, n=3, seed=5):
    rng = np.random.default_rng(seed)
    return datagen.DatasetArrays(
        re_range=np.linspace(100.0, 2000.0, n),
        feq_initial=rng.uniform(0.0, 0.5, (9, res, res)).astype(np.float32),
        f_final=rng.standard_normal((n, 9, res, res)).astype(np.float32),
        u_final=(0.05 * rng.standard_normal((n, 2, res, res))).astype(np.float32),
        failed=None)


def _jax_dataset(ds):
    return jdatagen.DatasetArrays(re_range=ds.re_range, feq_initial=ds.feq_initial,
                                  f_final=ds.f_final, u_final=ds.u_final, failed=ds.failed)


def _same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["cnn_one", "cnn_four", "cnn_eight"])
def test_inputs_are_byte_equal_to_jax(small_dataset, name):
    """``prepare_inputs`` and ``build_input`` for the three scalings (max,
    minmax of Re only, minmax of all, with the aux planes)."""
    cfg, ds = small_dataset
    data = train.prepare_inputs(ds, models.PRESETS[name], u_lid=cfg.u_lid)
    jdata = jtrain.prepare_inputs(_jax_dataset(ds), jmodels.PRESETS[name], u_lid=cfg.u_lid)
    assert data.fnet.shape == (2, cfg.nx, cfg.ny, 10)
    _same(data.fnet, jdata.fnet)
    _same(data.aux, jdata.aux)
    for c in ("x", "y"):
        _same(data.targets[c], jdata.targets[c])
    assert data.scalers == jdata.scalers
    for got, want in zip(predict.build_input(name, 120.0, ds.feq_initial, data.scalers,
                                             u_lid=cfg.u_lid),
                         jpredict.build_input(name, 120.0, ds.feq_initial, jdata.scalers,
                                              u_lid=cfg.u_lid)):
        _same(got, want)
    assert [a.tolist() for a in train.train_val_split(7)] == \
        [a.tolist() for a in jtrain.train_val_split(7)]


def _flax_params(name, fnet, aux, seed):
    args = (fnet,) if aux is None else (fnet, aux)
    params = jmodels.make_model(name).init(jax.random.PRNGKey(seed), *args)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("name", ["cnn_one", "cnn_eight"])
def test_prediction_matches_jax(small_dataset, name):
    """Both components un-scaled, with the x weights as a state dict and the
    y weights as a module: ``cnn_one`` on the 48^2 sweep with its trained
    weights (where they are in the checkout; else flax's initial ones), and
    ``cnn_eight`` with its aux planes on a seeded 192^2 dataset."""
    if name == "cnn_one":
        cfg, ds = small_dataset
    else:
        cfg, ds = SimConfig(nx=192, ny=192), _random_dataset(192)
    data = train.prepare_inputs(ds, models.PRESETS[name], u_lid=cfg.u_lid)
    fnet, aux = predict.build_input(name, 170.0, ds.feq_initial, data.scalers,
                                    u_lid=cfg.u_lid)
    if name == "cnn_one" and WEIGHTS.exists():
        from flax import serialization

        params_x = serialization.msgpack_restore(WEIGHTS.read_bytes())
    else:
        params_x = _flax_params(name, fnet, aux, 0)
    params_y = _flax_params(name, fnet, aux, 1)
    want = jpredict.predict_velocity(name, params_x, params_y, fnet, aux, data.scalers)
    preset = models.PRESETS[name]
    model_y = models.make_model(name)
    model_y.load_state_dict(models.state_dict_from_flax(preset, params_y))
    got = predict.predict_velocity(name, models.state_dict_from_flax(preset, params_x),
                                   model_y, fnet, aux, data.scalers, device="cpu")
    assert got.dtype == np.float32 and got.shape == (2, cfg.nx, cfg.ny)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lbm_reference_matches_jax_in_float64():
    """The comparison run through each package's router (the plain fused
    engine on the CPU for float64), to convergence or ``max_steps``."""
    kw = dict(nx=32, ny=32, reynolds=100.0, collision="mrt", precision="float64",
              max_steps=600, report_interval=100, convergence_tol=1e-6,
              convergence_hits=1)
    got = predict.lbm_reference(SimConfig(**kw), device="cpu")
    want = jpredict.lbm_reference(JConfig(**kw))
    assert got.dtype == np.float64 and got.shape == (2, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_predict_velocity_runs_where_it_is_asked():
    """A CPU module stays on the CPU; the model's precision is float32
    without TF32 unless asked (the flag is put back after the call)."""
    model = models.make_model("cnn_one", seed=3)
    assert model.allow_tf32 is False
    before = torch.backends.cudnn.allow_tf32
    fnet = np.zeros((1, 48, 48, 10), np.float32)
    u = predict.predict_velocity("cnn_one", model, model, fnet, None,
                                 {"vel": None}, device="cpu")
    assert u.shape == (2, 48, 48) and np.isfinite(u).all()
    assert next(model.parameters()).device.type == "cpu"
    assert torch.backends.cudnn.allow_tf32 == before
