"""The port's reader of flax's msgpack files (``ml.flax_msgpack``) against
``flax.serialization.msgpack_restore``, and ``ml.train.load_weights`` on the
JAX package's weight files.

The decoder must give flax's tree exactly: the same keys in the same order,
the same types, and arrays of the same dtype, shape and bytes.  The forward
of weights loaded through it is held to flax's forward of the same file at
``test_torch_ml_models_384.py``'s tolerance, rtol 1e-4, atol 1e-5 in
float32 (the same convolutions summed in another order)."""

import shutil
from pathlib import Path

import flax.serialization as serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.ml import flax_msgpack, models, predict, train
from latticeboltzmannsimulations_tpu.ml import models as jmodels
from latticeboltzmannsimulations_tpu.ml import train as jtrain

RTOL, ATOL = 1e-4, 1e-5
ARTIFACTS = Path(__file__).resolve().parent.parent / "docs" / "artifacts"
NINE = ARTIFACTS / "ml_full" / "cnn_nine"


def _same(got, want, path="tree"):
    """``got`` is ``want``: types, key order, dtypes, shapes, bytes."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
        if isinstance(want, np.ndarray):
            assert got.flags.writeable == want.flags.writeable, path
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


def _trees():
    rng = np.random.default_rng(0)
    return {
        "float32": {"w": rng.standard_normal((3, 4, 2)).astype(np.float32)},
        "float64": {"w": rng.standard_normal((5, 7)), "nan": np.array([np.nan, np.inf])},
        "int32_bool": {"i": np.arange(-3, 9, dtype=np.int32),
                       "b": np.array([[True, False], [False, True]]),
                       "u8": np.arange(5, dtype=np.uint8)},
        "zero_d_and_scalars": {"a": np.array(3.5, np.float32), "f": np.float64(-2.25),
                               "i": np.int32(-4), "b": np.bool_(True),
                               "c": np.complex64(1 - 2j)},
        "empty_dicts": {"a": {}, "b": {"c": {}, "d": np.zeros((0, 3), np.float32)}},
        "nested_tuples": (1, (2.5, "two", (None, True, False)), [-1, -33, 2**40, -2**40]),
        "python_leaves": {"s": "héllo" * 20, "raw": b"\x00\xff" * 40000, "z": 1 + 2j,
                          "big": 2**63 - 1, "neg": -2**63, "x": 1e300},
        "jax_arrays": {"p": jnp.linspace(0.0, 1.0, 12).reshape(3, 4),
                       "n": jnp.arange(6, dtype=jnp.int32)},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_decoder_equals_flax_on_written_trees(name):
    blob = serialization.to_bytes(_trees()[name])
    _same(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_decoder_joins_chunked_arrays_as_flax_does(monkeypatch):
    """flax splits an array above ``MAX_CHUNK_SIZE`` bytes into chunks; with
    the limit lowered, small arrays show the form."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    blob = serialization.to_bytes({"w": {"k": rng.standard_normal((5, 7))},
                                   "v": np.arange(40, dtype=np.int32)})
    raw = flax_msgpack._decode(blob)
    assert "__msgpack_chunked_array__" in raw["w"]["k"]
    _same(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


@pytest.mark.parametrize("path", [
    "ml_full/cnn_nine/cnn_nine_x.msgpack",
    "ml_full_b/cnn_ten/cnn_ten_x.msgpack",
    "ml_full/cnn_eight_faithful/cnn_eight_x.ckpt",
])
def test_decoder_equals_flax_on_tracked_files(path):
    """Two weight files and a training checkpoint's blob (behind its 8-byte
    header length and JSON header)."""
    data = (ARTIFACTS / path).read_bytes()
    if path.endswith(".ckpt"):
        data = data[8 + int.from_bytes(data[:8], "little"):]
    got = flax_msgpack.msgpack_restore(data)
    _same(got, serialization.msgpack_restore(data))
    assert got


@pytest.mark.parametrize("blob, match", [
    (serialization.to_bytes({"a": np.ones(3)})[:-5], "truncated"),
    (serialization.to_bytes({"a": 1}) + b"\x00", "after the msgpack value"),
    (b"\xc1", "begins no msgpack value"),
    (b"\xd4\x07\x00", "extension type 7"),
    (serialization.to_bytes({"a": jnp.ones(2, jnp.bfloat16)}), "bfloat16"),
    (b"\x81\x01\x02", "map key"),
])
def test_decoder_refuses_what_flax_does_not_write(blob, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(blob)


def test_load_weights_serves_the_committed_msgpack_as_flax_does():
    """``cnn_nine``'s trained x weights: the port's ``load_weights`` (no
    ``.pt`` beside them) and ``CavityCNN`` against the JAX package's
    ``load_weights`` and flax forward, on one 384^2 input built by
    ``predict.build_input`` from the sidecar's scalers."""
    params, meta = train.load_weights("cnn_nine", "x", str(NINE))
    assert meta["preset"] == "cnn_nine" and "scalers" in meta
    cfg = SimConfig(nx=384, ny=384, precision="float32")
    feq = engine.init_state(cfg, "cpu").f.numpy()
    fnet, aux = predict.build_input("cnn_nine", 2500.0, feq, meta["scalers"])
    args = (fnet,) if aux is None else (fnet, aux)
    jparams, jmeta = jtrain.load_weights("cnn_nine", "x", str(NINE), args)
    assert jmeta == meta
    want = np.asarray(jmodels.make_model("cnn_nine").apply({"params": jparams}, *args))
    model = models.make_model("cnn_nine")
    model.load_state_dict(params)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape == (1, 384, 384, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_a_pt_file_wins_over_the_msgpack(tmp_path):
    for name in ("cnn_nine_x.msgpack", "cnn_nine_x.json"):
        shutil.copy(NINE / name, tmp_path / name)
    from_flax, _ = train.load_weights("cnn_nine", "x", str(tmp_path))
    own = models.make_model("cnn_nine", seed=3).state_dict()
    torch.save(own, tmp_path / "cnn_nine_x.pt")
    got, meta = train.load_weights("cnn_nine", "x", str(tmp_path))
    assert meta["preset"] == "cnn_nine"
    for name, w in own.items():
        assert torch.equal(got[name], w), name
    assert not torch.equal(got["head1.weight"], from_flax["head1.weight"])


def test_a_msgpack_of_another_preset_raises(tmp_path):
    shutil.copy(ARTIFACTS / "ml_full_b" / "cnn_ten" / "cnn_ten_x.msgpack",
                tmp_path / "cnn_nine_x.msgpack")
    with pytest.raises(ValueError, match="do not fit cnn_nine"):
        train.load_weights("cnn_nine", "x", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="cnn_nine_y"):
        train.load_weights("cnn_nine", "y", str(tmp_path))
