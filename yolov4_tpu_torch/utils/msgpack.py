"""A first-party decoder of the JAX package's ``.ckpt`` files.

The JAX package writes checkpoints with flax's ``msgpack_serialize``
(its utils/checkpoint.py): a msgpack document of nested maps whose array
leaves are msgpack ext values. The port may import neither flax nor the
``msgpack`` package (the card's machine has neither), so this module reads
the format itself. It decodes:

  * msgpack maps, arrays (as lists), str, bin, ints, floats, nil and
    bools;
  * ext type 1, an ndarray: a packed ``(shape, dtype name, C bytes)``.
    ``bfloat16``, which numpy lacks, is read as uint16 and viewed as a
    ``torch.bfloat16`` tensor; every other dtype is a numpy array;
  * ext type 3, a numpy scalar: the same encoding of a 0-d array;
  * flax's chunked leaves (``{"__msgpack_chunked_array__": True, "shape":
    {"0": ...}, "chunks": {"0": ...}}``, written for arrays above 2**30
    bytes), joined back into one array.

Only decoding is implemented: the port writes ``torch.save`` files.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # marker -> (struct format, size)
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LENGTH = {  # marker -> (kind, length format, length size)
    0xc4: ("bin", ">B", 1), 0xc5: ("bin", ">H", 2), 0xc6: ("bin", ">I", 4),
    0xc7: ("ext", ">B", 1), 0xc8: ("ext", ">H", 2), 0xc9: ("ext", ">I", 4),
    0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2), 0xdb: ("str", ">I", 4),
    0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
    0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """``bin_type``: what a bin value becomes (an array's buffer is read as
    a ``bytearray``, so that the array over it is writable without a
    copy)."""

    def __init__(self, data: bytes, bin_type=bytes):
        self.view = memoryview(data)
        self.pos = 0
        self.bin_type = bin_type

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError("msgpack data ends inside a value")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, self.take(_FIXEXT[b]))
        if b in _LENGTH:
            kind, fmt, size = _LENGTH[b]
            n = self.unpack(fmt, size)
            if kind == "bin":
                return self.bin_type(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b", 1)
            return _ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack marker 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack document -> Python values, with the JAX package's ext
    types decoded (see the module docstring)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.view):
        raise ValueError(f"{len(reader.view) - reader.pos} trailing bytes "
                         "after the msgpack document")
    return out


def _array(data: memoryview):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C bytes)."""
    shape, name, buf = _Reader(data, bytearray).value()
    shape = tuple(shape)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        arr = _array(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = _tuple(d["shape"])
    chunks = _tuple(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """flax's ``serialization.msgpack_restore``: the nested dicts of a
    ``.ckpt`` file's bytes, chunked leaves joined."""
    return _unchunk_tree(unpackb(data))
