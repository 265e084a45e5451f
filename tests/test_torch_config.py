"""The port's SimConfig and lattice tables equal the JAX package's."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import lattice as t_lat
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.config import resolve_device
from latticeboltzmannsimulations_tpu import lattice as j_lat
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig

_GRID = list(itertools.product((0.05, 0.08, 0.1), (32, 160), (1.0 / 3.5, 0.25)))


@pytest.mark.parametrize("collision", ["srt", "trt", "mrt"])
@pytest.mark.parametrize("reynolds", [10.0, 100.0, 1000.0, 5000.0])
def test_derived_values_match(reynolds, collision):
    for u_lid, ny, magic in _GRID:
        kw = dict(nx=48, ny=ny, reynolds=reynolds, u_lid=u_lid,
                  collision=collision, trt_magic=magic)
        t, j = TConfig(**kw), JConfig(**kw)
        # the same Python float arithmetic: exact equality
        for name in ("nu", "omega", "tau", "trt_omega_plus",
                     "trt_omega_minus", "tau_min_stable"):
            assert getattr(t, name) == getattr(j, name), name
        np.testing.assert_array_equal(t.mrt_omegas(), j.mrt_omegas())
        assert t.describe() == j.describe()
        assert t.validate() is t and j.validate() is j


@pytest.mark.parametrize("kw", [
    dict(collision="bgk"),
    dict(boundary="periodic"),
    dict(turbulence="wale"),
    dict(nx=3),
    dict(ny=2),
    dict(reynolds=-1000.0),
    dict(reynolds=-0.5),
])
def test_validate_errors_match(kw):
    with pytest.raises(ValueError) as j_err:
        JConfig(**kw).validate()
    with pytest.raises(ValueError) as t_err:
        TConfig(**kw).validate()
    assert str(t_err.value) == str(j_err.value)


def test_config_is_frozen_hashable_and_maps_dtype():
    cfg = TConfig(precision="float64")
    assert hash(cfg) == hash(TConfig(precision="float64"))
    with pytest.raises(AttributeError):
        cfg.nx = 10
    assert cfg.dtype is torch.float64
    assert TConfig().dtype is torch.float32
    assert JConfig().dtype == jnp.float32
    assert [f.name for f in TConfig.__dataclass_fields__.values()] == \
        [f.name for f in JConfig.__dataclass_fields__.values()]


@pytest.mark.parametrize("name", [
    "Q", "C", "CX", "CY", "W", "OPP", "LEFT", "CENT_V", "RIGHT", "UP",
    "CENT_H", "DOWN", "TOP_STENCIL", "BOT_STENCIL", "CS2", "M_GS",
    "M_GS_INV", "MOMENT_NAMES", "CONSERVED_MOMENTS",
])
def test_lattice_tables_match(name):
    np.testing.assert_array_equal(np.asarray(getattr(t_lat, name)),
                                  np.asarray(getattr(j_lat, name)))


def test_mrt_omega_vec_and_self_check():
    np.testing.assert_array_equal(t_lat.mrt_omega_vec(1.7, 1.1, 0.9, 1.3),
                                  j_lat.mrt_omega_vec(1.7, 1.1, 0.9, 1.3))
    t_lat._self_check()
    np.testing.assert_allclose(t_lat.M_GS @ t_lat.M_GS_INV, np.eye(9), atol=1e-12)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
