"""Read what ``flax.serialization.to_bytes`` writes, without flax, msgpack or
JAX.

The JAX package saves the surrogate's weights (``<preset>_<component>.msgpack``)
and the blob of its training checkpoints (``.ckpt``, behind a JSON header)
with flax's msgpack serialization.  This module decodes that format in plain
Python and NumPy and returns what ``flax.serialization.msgpack_restore``
returns: the nested dict of NumPy arrays, numbers and strings.

It reads msgpack's nil, bool, integers, float32 and float64, str, bin,
arrays (as lists, as msgpack does) and maps (as dicts, keys str or bytes),
and flax's three extension types: 1, an ndarray, itself a msgpack
``(shape, dtype name, C-order bytes)``; 2, a complex number, a msgpack
``(real, imag)``; 3, a NumPy scalar, packed as a 0-d ndarray.  Arrays that
flax split into chunks (``__msgpack_chunked_array__``, for leaves over 1 GiB)
are joined back as flax joins them.  A ``bfloat16`` array is refused: NumPy
has no such dtype.  Arrays are read-only views of their bytes, as flax's are.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# msgpack's fixed-width formats: first byte -> struct format of the value.
_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# Formats with a length: first byte -> (kind, struct format of the length).
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
# fixext 1, 2, 4, 8 and 16: first byte -> the data's length.
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """One pass over a msgpack buffer.  ``raw``: str values as bytes (flax
    reads the ndarray extension so)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = data
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.number(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return getattr(self, kind)(self.number(fmt))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} begins no msgpack value")

    def str(self, n: int):
        s = self.take(n)
        return s if self.raw else s.decode("utf-8")

    def bin(self, n: int) -> bytes:
        return self.take(n)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"a map key of type {type(key).__name__}; msgpack "
                                 f"restores only str and bytes keys")
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _decode(data)
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not one that flax writes")


def _decode(data: bytes, raw: bool = False):
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack value")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray extension: ``(shape, dtype name, C-order bytes)``."""
    shape, name, buffer = _decode(data, raw=True)
    if name == b"bfloat16":
        raise ValueError("a bfloat16 array: NumPy has no bfloat16 dtype to read it into")
    return np.frombuffer(buffer, dtype=np.dtype(name.decode("ascii"))).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked arrays in dicts
    (and at the top) joined back."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_leaves(v)
    return tree


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns."""
    return _unchunk_leaves(_decode(bytes(data)))


def load(path) -> dict:
    """``msgpack_restore`` of a file's bytes (a ``.msgpack`` weight file)."""
    return msgpack_restore(Path(path).read_bytes())
