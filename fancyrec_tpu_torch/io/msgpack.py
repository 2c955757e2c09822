"""A msgpack decoder for the trees that flax.serialization writes.

Pure Python and numpy, so the port reads the JAX package's FRTPU1
checkpoints on a machine without the msgpack or flax packages. It reads
every msgpack type flax writes (nil, bool, ints, floats, str, bin, arrays,
maps, ext) and flax's ext codes:
  * 1, ndarray: a packed (shape, dtype name, C-order bytes) triple;
  * 2, native_complex: a packed (real, imag) pair;
  * 3, npscalar: an ndarray triple of shape ();
then reassembles flax's chunked form of large arrays (a map with
`__msgpack_chunked_array__`, `shape` and `chunks`, both keyed "0", "1",
...). numpy has no bfloat16, so a bfloat16 leaf comes back as the float32
array of the same values (exact: bfloat16 is float32's top half).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType:
    """An ext value of a code flax does not define."""

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data

    def __eq__(self, other):
        return (isinstance(other, ExtType)
                and (self.code, self.data) == (other.code, other.data))

    def __repr__(self):
        return "ExtType(%d, %r)" % (self.code, self.data)


class _Reader:
    def __init__(self, data: bytes, raw: bool, ext_hook):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input at byte %d" % self.pos)
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))

    def value(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: (">B", bytes), 0xC5: (">H", bytes), 0xC6: (">I", bytes),
                 0xD9: (">B", self.str_), 0xDA: (">H", self.str_),
                 0xDB: (">I", self.str_),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map_), 0xDF: (">I", self.map_),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
                 0xC9: (">I", self.ext)}
        if t in sized:
            fmt, fn = sized[t]
            n = self.unpack(fmt)
            return bytes(self.take(n)) if fn is bytes else fn(n)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError("msgpack: unknown type byte 0x%02x at %d"
                         % (t, self.pos - 1))

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes, raw: bool = False, ext_hook=None) -> Any:
    """Decode one msgpack value that fills `data`. raw=True leaves str as
    bytes; ext_hook(code, data) decodes ext values (default: ExtType)."""
    r = _Reader(data, raw, ext_hook or ExtType)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: %d trailing bytes" % (len(r.buf) - r.pos))
    return out


def _dtype(name: bytes) -> Tuple[np.dtype, bool]:
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    return np.dtype(name), False


def ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ndarray encoding -> a numpy array (writable, C order)."""
    shape, name, buf = unpackb(data, raw=True)
    dt, bf16 = _dtype(name)
    arr = np.frombuffer(buf, dtype=dt).reshape(shape).copy()
    if bf16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _flax_ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        return ndarray_from_bytes(data)[()]
    return ExtType(code, data)


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without flax: the state-dict tree
    (nested dicts with str keys) of numpy arrays and Python scalars."""
    return _unchunk_tree(unpackb(data, ext_hook=_flax_ext))
