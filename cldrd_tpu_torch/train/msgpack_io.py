"""Read flax ``.msgpack`` checkpoints without the ``msgpack`` package.

``flax.serialization.msgpack_serialize`` writes a tree of maps with array
leaves. This module decodes the msgpack format (maps, arrays, str, bin,
ints, floats, nil, bool) and flax's extension types:

- ext 1, an ndarray: a packed ``(shape, dtype name, bytes)``, C order;
- ext 3, a numpy scalar: the same payload, read as a 0-d array's value;
- ext 2, a complex number: a packed ``(real, imag)``;
- the ``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` form flax
  gives leaves over 2**30 bytes, joined back into one array.

``bfloat16`` leaves are read through a ``uint16`` view and widened to
float32, which is exact. ``load_flax_checkpoint(path)`` returns the
decoded tree; ``flax_params(tree)`` takes ``params`` from a JAX
``Trainer`` checkpoint (``{params, opt_state, step, epoch}``) or the
root of a bare parameter tree, as ``cldrd_tpu/train/checkpoint.py``
does.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = _Decoder(payload, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name))
    return arr.reshape(tuple(shape), order="C")


class _Decoder:
    """A msgpack reader over one bytes object. ``raw`` keeps str as
    bytes (flax reads an ndarray's dtype name that way)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        b = self._take(n)
        return b if self.raw else b.decode("utf-8")

    def _ext(self, code: int, n: int) -> Any:
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            re_, im = _Decoder(payload).value()
            return complex(re_, im)
        raise ValueError(f"msgpack: unknown ext type {code}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return self._str(n)
            return self._array(n) if kind == "array" else self._map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self._unpack(">b")
            return self._ext(code, fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self._unpack(">b")
            return self._ext(code, n)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")


def _tuple_of(d: Dict[str, Any]) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked leaves back into arrays, everywhere in
    ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = _tuple_of(tree["shape"])
        return np.concatenate(_tuple_of(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(blob: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: bytes -> tree."""
    dec = _Decoder(blob)
    tree = dec.value()
    if dec.pos != len(dec.data):
        raise ValueError(f"msgpack: {len(dec.data) - dec.pos} trailing "
                         "bytes")
    return _unchunk(tree)


def load_flax_checkpoint(path: str) -> Any:
    """The decoded tree of a flax ``.msgpack`` file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def flax_params(tree: Any) -> Any:
    """``params`` of a JAX ``Trainer`` checkpoint, or the root of a bare
    parameter tree."""
    return tree["params"] if isinstance(tree, dict) and "params" in tree \
        else tree
