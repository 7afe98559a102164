"""A standard-library reader of flax's msgpack files.

Counterpart of ``flax.serialization.msgpack_restore`` as flax 0.12 writes
(``msgpack_serialize``, ``to_bytes``): the JAX package's checkpoints
(``interface.py:save_experiment_checkpoint``) and the trained weights under
``results/skill_*`` are such files, and the port imports neither flax nor
msgpack. ``restore`` decodes

* the msgpack families: nil, bool, positive and negative fixint, int and
  uint of 8 to 64 bits, float32 and float64, str, bin, array, map, ext and
  fixext (arrays become lists; map keys must be str or bin, as msgpack's
  ``strict_map_key``);
* flax's ext codes: 1, an ndarray ``(shape, dtype name, C-order bytes)``;
  2, a Python complex ``(real, imag)``; 3, a numpy scalar (an ndarray of
  shape ``()``, unpacked);
* chunked leaves (``{"__msgpack_chunked_array__": True, "shape": {...},
  "chunks": {...}}``, written for leaves above ``MAX_CHUNK_SIZE``), joined
  back as flax does.

numpy has no bfloat16, so bfloat16 leaves (and scalars) become
``torch.bfloat16`` tensors; every other array is a read-only numpy array
over the file's bytes, as flax returns it. An unknown type byte or ext code
raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["restore", "read"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
          0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("flax msgpack: truncated data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

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
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xc4])))
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xd9]))
        if b in (0xdc, 0xdd):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack((">B", ">H", ">I")[b - 0xc7])
            return _ext(self.unpack(">b"), self.take(n))
        if 0xd4 <= b <= 0xd8:
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xd4)))
        raise ValueError(f"flax msgpack: unknown type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"flax msgpack: map key {k!r} is not str or bin")
            out[k] = self.value()
        return out


def _ndarray(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes)."""
    r = _Reader(payload)
    head = r.take(1)[0]
    if head != 0x93:
        raise ValueError("flax msgpack: an ndarray ext is not a 3-element array")
    shape = tuple(r.value())
    name = r.value()
    name = name.decode() if isinstance(name, bytes) else name
    b = r.take(1)[0]
    if b not in (0xc4, 0xc5, 0xc6):
        raise ValueError("flax msgpack: an ndarray ext's buffer is not bin")
    buf = r.take(r.unpack((">B", ">H", ">I")[b - 0xc4]))
    if name == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        re_im = _Reader(payload).value()
        return complex(re_im[0], re_im[1])
    raise ValueError(f"flax msgpack: unknown ext code {code}")


def _dict_to_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = _dict_to_tuple(d["shape"])
    chunks = _dict_to_tuple(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place`` (dicts only, as there)."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def restore(data) -> Any:
    """Decode flax msgpack bytes into the tree ``msgpack_restore`` gives."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"flax msgpack: {len(r.buf) - r.pos} bytes after the tree")
    return _unchunk_leaves(out)


def read(path: str) -> Any:
    with open(path, "rb") as f:
        return restore(f.read())
