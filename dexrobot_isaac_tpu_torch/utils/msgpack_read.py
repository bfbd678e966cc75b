"""A msgpack reader for the subset that flax's serialization writes (pure
Python and numpy).

The JAX package saves checkpoints as `flax.serialization.to_bytes(payload)`
(`dexrobot_isaac_tpu/rl/checkpoint.py`): msgpack of nested maps whose leaves
are msgpack scalars, strings and flax's ext types. Neither `msgpack` nor
`flax` is a dependency of the port, so `unpackb` decodes that subset itself:

- nil, bool, ints (fixint, u/int 8-64), float32/64, str, bin, array, map;
- ext 1, an ndarray: the msgpack triple (shape, dtype name, raw C-order
  bytes), decoded to a writable numpy array;
- ext 3, a numpy scalar, packed as a 0-d ndarray and returned as its scalar;
- ext 2, a Python complex, packed as the pair (real, imag).

Strings decode as UTF-8 and arrays as lists, as `msgpack.unpackb(raw=False)`
returns them (so `flax.serialization.msgpack_restore` and this reader give
equal trees). Any other type code raises ValueError.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# type byte -> (struct format, size) of fixed-width scalars
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
# type byte -> width of the length field of str / bin / array / map / ext
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return struct.unpack(_UINT[width], self.take(width))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            fmt, size = _SCALARS[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _STR:
            return str(self.take(self.uint(_STR[b])), "utf-8")
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _ARRAY:
            return self.array(self.uint(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.uint(_MAP[b]))
        if b in _EXT or b in _FIXEXT:
            size = self.uint(_EXT[b]) if b in _EXT else _FIXEXT[b]
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, bytes(self.take(size)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset flax writes")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(payload).obj()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"ndarray of dtype {dtype_name!r}: numpy has no such dtype") from None
    return np.frombuffer(raw, dtype=dtype).reshape(tuple(shape)).copy()


def _ext(code: int, payload: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(payload).obj()
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills `data`."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack object")
    return out
