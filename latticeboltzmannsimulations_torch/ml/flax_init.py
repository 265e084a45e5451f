"""flax's initial draw of the JAX package's ``CavityCNN``, without JAX or flax.

The JAX package's ``train(seed=k)`` starts from ``model.init(PRNGKey(k),
...)``.  This module draws the same weights on the host, in NumPy uint32
and float32, so that the port's ``make_model(..., seed=k)`` and
``train(..., seed=k)`` start where JAX's do.  It reproduces:

* JAX 0.9.0's threefry PRNG with ``jax_threefry_partitionable`` on (the
  default since JAX 0.5): ``PRNGKey(seed)`` is the seed's two 32-bit
  halves; ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
  ``random_bits`` hashes a 64-bit iota split into high and low words and
  returns the XOR of the two output words.  The JAX package's committed
  draw (``docs/artifacts/torch/init/cnn_nine_prngkey0.msgpack``) is in this
  mode, and JAX's trained ``cnn_nine`` halves started from it: each layer
  correlates 0.64-0.998 with it, at most 0.12 with the draw of the same key
  under the older, non-partitionable threefry
  (``docs/artifacts/torch/init/init_correlations.json``);
* ``jax.random.uniform`` (the mantissa of 1.0 filled with random bits, less
  1, scaled and clipped below) and ``jax.random.truncated_normal`` (a
  uniform on ``[erf(lower/sqrt2), erf(upper/sqrt2)]``, ``sqrt2 * erfinv``,
  clipped inside ``(lower, upper)``), in float32 as XLA's CPU backend
  evaluates them: its ``erf_inv`` (Giles' polynomial of ``-log1p(-u*u)``),
  its ``log1p`` and ``log`` (Cephes' rational and polynomial), and each
  multiply that feeds an add contracted into one fused multiply-add, as
  the backend does on a processor that has one (``fma32``);
* ``jax.nn.initializers.variance_scaling`` for ``lecun_normal`` (fan in,
  truncated normal) and ``glorot_uniform`` (fan average, uniform), with
  each scale rounded to float32 where JAX rounds it;
* flax 0.12.3's key for each parameter (``flax/core/scope.py``,
  ``flax_fix_rng_separator`` off): a layer's ``n``-th ``self.param`` draws
  from ``fold_in(PRNGKey(seed), sha1(name + n as big-endian bytes)[:4])``;
  ``nn.Conv`` and ``nn.ConvTranspose`` ask for the kernel first (``n = 1``)
  and the bias second (zeros, which draw nothing).

Tolerance: none.  The random bits, the uniforms, ``erfinv`` and every
kernel, LeCun-normal and Glorot-uniform, equal flax's eager draw on the CPU
bit for bit (``tests/test_torch_ml_flax_init.py``), and so does the
committed ``PRNGKey(0)`` draw of ``cnn_nine``.  Only the arithmetic is
emulated, in float64 where a fused multiply-add rounds once, so the draw
is the same on every host.  XLA's other backends evaluate ``erf_inv`` in
their own way: a TPU's draw, and a jitted draw on the CPU that fuses the
scale into the sample, differ from the eager one in the last bits
(within 2.1e-7 of a layer's largest value for the cheapest compile).
"""

from __future__ import annotations

import hashlib
import math
import threading
from typing import Dict, Tuple

import numpy as np

DRAW = "flax-threefry"      # the draw's name in a training run's recipe

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32
_CHUNK = 1 << 14      # values a block of threefry or erfinv takes: its temporaries stay in cache

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed as 64 bits, high word first
    (a negative seed in two's complement, as JAX's 64-bit mode takes it)."""
    seed %= 1 << 64
    return seed >> 32, seed & _MASK


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) of the counter
    words ``x0``, ``x1`` (uint32 arrays of one shape) under ``key``."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = x0.astype(np.uint32) + np.uint32(ks[0])
    x1 = x1.astype(np.uint32) + np.uint32(ks[1])
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _MASK)
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key's hash of the counter pair
    ``(0, data)``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data & _MASK], np.uint32))
    return int(y0[0]), int(y1[0])


def random_bits(key: Key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable threefry): the
    hash of each element's 64-bit flat index, high and low word, the two
    output words XORed."""
    n = math.prod(shape)
    out = np.empty(n, np.uint32)
    for i in range(0, n, _CHUNK):
        idx = np.arange(i, min(i + _CHUNK, n), dtype=np.uint64)
        y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                              idx.astype(np.uint32))
        np.bitwise_xor(y0, y1, out=out[i:i + _CHUNK])
    return out.reshape(shape)


def _mantissas(key: Key, shape) -> np.ndarray:
    """The 23 random bits ``uniform`` puts into the mantissa of 1.0."""
    return random_bits(key, shape) >> np.uint32(9)


def _uniform_of(mantissas: np.ndarray, lo, hi) -> np.ndarray:
    floats = (mantissas | np.uint32(0x3F800000)).view(np.float32) - _F32(1.0)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


def uniform(key: Key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    float in [1, 2) of 23 random mantissa bits, less 1, times
    ``maxval - minval`` plus ``minval`` (one rounding: XLA's CPU backend
    contracts it), and at least ``minval``."""
    return _uniform_of(_mantissas(key, shape), _F32(minval), _F32(maxval))


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 arrays with one rounding, as XLA's CPU backend
    contracts a multiply feeding an add.  The float64 product is exact; the
    float64 sum, rounded to float32, is rounded twice only where it lies
    halfway between two float32 values, and there the sum's own error
    decides."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b
    s = p + c
    r = s.astype(np.float32)
    half = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    if not half.any():
        return r
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    d = s - r
    up = np.nextafter(r, np.where(d > 0, np.float32(np.inf), np.float32(-np.inf)))
    return np.where(half & (err != 0) & ((err > 0) == (d > 0)), up, r)


def _poly(x: np.ndarray, coefficients) -> np.ndarray:
    """Horner's rule from the highest power, each step one ``fma32``."""
    p = np.full_like(x, coefficients[0])
    for c in coefficients[1:]:
        p = fma32(p, x, c)
    return p


# XLA's float32 log (Cephes' polynomial, as Eigen's ``plog``).
_LOG_P = tuple(_F32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _F32(-2.12194440e-4), _F32(0.693359375)


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive normal ``x``."""
    bits = x.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(np.float32) + _F32(1)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    low = m < _F32(0.707106781186547524)
    e = e - low.astype(np.float32)
    t = (m - _F32(1)) + np.where(low, m, _F32(0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma32(t, p[0], p[1])
    y1 = fma32(t, p[3], p[4])
    y2 = fma32(t, p[6], p[7])
    y = fma32(y, t, p[2])
    y1 = fma32(y1, t, p[5])
    y2 = fma32(y2, t, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, _LOG_Q1 * e)
    t = fma32(_F32(-0.5), x2, t)
    return fma32(_LOG_Q2, e, t + y)


# XLA's float32 log1p: a Cephes rational below sqrt2 - 1, else log(1 + x).
_LOG1P_NUM = tuple(_F32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_F32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` of ``x`` in (-1, 0]."""
    out = np.empty_like(x)
    small = np.abs(x) < _F32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    out[small] = xs + fma32(_F32(-0.5), x2, (xs * x2) * (_poly(xs, _LOG1P_NUM)
                                                         / _poly(xs, _LOG1P_DEN)))
    large = ~small
    out[large] = _log(_F32(1) + x[large])
    return out


# Giles' float32 erfinv coefficients, for w < 5 and w >= 5 (XLA's ``ErfInv``).
_ERFINV_LT5 = tuple(_F32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(_F32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _erfinv_block(u: np.ndarray) -> np.ndarray:
    w = -_log1p(u * -u)
    lt5 = w < _F32(5)
    if lt5.all():
        t, coefficients = w - _F32(2.5), _ERFINV_LT5
    else:
        t = np.where(lt5, w - _F32(2.5), np.sqrt(w) - _F32(3))
        coefficients = [np.where(lt5, c_lt, c_ge).astype(np.float32)
                        for c_lt, c_ge in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = np.broadcast_to(coefficients[0], u.shape)
    for c in coefficients[1:]:
        p = fma32(p, t, c)
    return p * u


def erfinv(u: np.ndarray) -> np.ndarray:
    """``lax.erf_inv`` of float32 ``u`` in (-1, 1) as XLA's CPU backend
    evaluates it: ``w = -log1p(-u*u)``, Giles' polynomial in ``w - 2.5``
    (``w < 5``) or ``sqrt(w) - 3``, times ``u``; in blocks of ``_CHUNK``
    values, whose temporaries stay in cache."""
    u = np.ascontiguousarray(u, np.float32)
    flat, out = u.reshape(-1), np.empty(u.size, np.float32)
    for i in range(0, u.size, _CHUNK):
        out[i:i + _CHUNK] = _erfinv_block(flat[i:i + _CHUNK])
    return out.reshape(u.shape)


_SQRT2 = _F32(math.sqrt(2.0))


def _truncated_of(mantissas: np.ndarray, lower, upper) -> np.ndarray:
    # the uniform's bounds, erf(lower / sqrt2) and erf(upper / sqrt2) in
    # float64 rounded to float32: XLA's float32 erf at the bounds held
    # against it (-2, 2 and -1, 3)
    a, b = _F32(math.erf(lower / _SQRT2)), _F32(math.erf(upper / _SQRT2))
    out = _SQRT2 * erfinv(_uniform_of(mantissas, a, b))
    return np.clip(out, np.nextafter(lower, _F32(np.inf)), np.nextafter(upper, _F32(-np.inf)))


# truncated_normal(-2, 2) is a function of the 23 mantissa bits alone: its
# values, filled in as draws ask for them (32 MiB when all are).  The table
# only grows and each entry is that function's value, so callers cannot see
# one another through it.
_TRUNC2 = {"value": None, "known": None, "lock": threading.Lock()}


def _truncated2(mantissas: np.ndarray) -> np.ndarray:
    with _TRUNC2["lock"]:
        if _TRUNC2["value"] is None:
            _TRUNC2["value"] = np.empty(1 << 23, np.float32)
            _TRUNC2["known"] = np.zeros(1 << 23, bool)
        value, known = _TRUNC2["value"], _TRUNC2["known"]
        new = mantissas[~known[mantissas]]
        if new.size:
            value[new] = _truncated_of(new, _F32(-2.0), _F32(2.0))
            known[new] = True
        return value[mantissas]


def truncated_normal(key: Key, lower: float, upper: float, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``: a
    ``uniform`` on ``[erf(lower/sqrt2), erf(upper/sqrt2)]``, ``sqrt2 *
    erfinv`` of it, clipped inside ``(lower, upper)``."""
    lower, upper = _F32(lower), _F32(upper)
    m = _mantissas(key, shape)
    if (float(lower), float(upper)) == (-2.0, 2.0):
        return _truncated2(m.reshape(-1)).reshape(shape)
    return _truncated_of(m, lower, upper)


def _fans(shape) -> Tuple[float, float]:
    """``jax.nn.initializers``' ``_compute_fans`` of a kernel (..., in, out)."""
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(key: Key, shape, kernel_init: str) -> np.ndarray:
    """``lecun_normal()`` or ``glorot_uniform()`` of ``jax.nn.initializers``
    (``variance_scaling`` with scale 1), drawn as float32."""
    fan_in, fan_out = _fans(shape)
    if kernel_init == "lecun_normal":
        variance = _F32(1.0 / fan_in)
        stddev = np.sqrt(variance) / _F32(0.87962566103423978)
        return truncated_normal(key, -2.0, 2.0, shape) * stddev
    if kernel_init == "glorot_uniform":
        variance = _F32(1.0 / ((fan_in + fan_out) / 2))
        return uniform(key, shape, -1.0, 1.0) * np.sqrt(_F32(3.0) * variance)
    raise ValueError(f"unknown kernel_init {kernel_init!r}")


def param_key(key: Key, layer: str, count: int) -> Key:
    """flax's key for the ``count``-th ``self.param`` of the child module
    ``layer`` of the root: ``LazyRng`` folds the SHA-1 of the name and the
    counter's big-endian bytes into the root key."""
    h = hashlib.sha1(layer.encode("utf-8") + count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(h.digest()[:4], "big"))


def kernel_shapes(preset) -> Dict[str, Tuple[int, ...]]:
    """Each layer's flax kernel shape (HWIO; a ``ConvTranspose`` is also
    ``(kh, kw, in, out)``), in flax's layer names (JAX ``ml/models.py``)."""
    c_in = 10 + (2 if preset.aux_bc_at_input else 0)
    shapes, c = {}, c_in
    if preset.multiscale_front:
        for k in preset.multiscale_front:
            shapes[f"ms{k}"] = (k, k, c_in, 8)
        c = 8 * len(preset.multiscale_front)
    for i, (feat, k, _) in enumerate(preset.encoder):
        shapes[f"enc{i}"] = (k, k, c, feat)
        c = feat
    z = c
    for name in (("dec_a", "dec_b") if preset.twin_decoders else ("dec",)):
        c = z
        for i, (feat, k, _) in enumerate(preset.decoder):
            shapes[f"{name}_deconv{i}"] = (k, k, c, feat)
            c = feat
    branches = 2 if preset.twin_decoders else 1
    shapes["head0"] = (1, 1, branches * c + c_in + (2 if preset.aux_bc_at_head else 0), 16)
    shapes["head1"] = (1, 1, 16, 1)
    return shapes


def init_params(preset, seed: int = 0, kernel_init: str = "lecun_normal") -> dict:
    """flax's ``CavityCNN(preset, kernel_init=...).init(PRNGKey(seed), ...)
    ["params"]``: ``{layer: {"kernel": HWIO float32, "bias": zeros}}``."""
    root = prng_key(seed)
    return {layer: {"kernel": variance_scaling(param_key(root, layer, 1), shape, kernel_init),
                    "bias": np.zeros(shape[-1], np.float32)}
            for layer, shape in kernel_shapes(preset).items()}
