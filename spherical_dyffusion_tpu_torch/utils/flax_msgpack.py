"""A standard-library reader and writer of flax's msgpack files.

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

``serialize`` (and ``write``) encode a tree of str-keyed dicts with array
leaves as ``msgpack_serialize`` does, byte for byte: numpy arrays and torch
tensors (bfloat16 ones under numpy's name for it, "bfloat16") as ext 1,
numpy scalars as ext 3, Python complex as ext 2, leaves above
``MAX_CHUNK_SIZE`` bytes chunked, dicts in sorted key order (flax runs the
tree through ``jax.tree_util.tree_map`` first); ints, floats (float64),
str, bytes, bools, None, lists and tuples as msgpack packs them.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["restore", "read", "serialize", "write"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's: leaves above it are written in chunks
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


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, heads, what: str) -> None:
    """The head of a str, bin, array or map of ``n`` entries: the fix form
    (``fix | n``) up to ``fix_max`` where there is one, else the smallest of
    ``heads`` (type bytes of 8-, 16- and 32-bit lengths; None where the
    family has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for head, fmt, top in zip(heads, (">B", ">H", ">I"), (0xff, 0xffff, 0xffffffff)):
        if head is not None and n <= top:
            out.append(head)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"flax msgpack: {what} of {n} entries is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xcc, ">B", 0, 0xff), (0xcd, ">H", 0, 0xffff), (0xce, ">I", 0, 0xffffffff),
             (0xcf, ">Q", 0, 2 ** 64 - 1)) if v > 0 else (
        (0xd0, ">b", -0x80, 0), (0xd1, ">h", -0x8000, 0), (0xd2, ">i", -2 ** 31, 0),
        (0xd3, ">q", -2 ** 63, 0))
    for head, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(head)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"flax msgpack: int {v} does not fit 64 bits")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9), "ext")
    out += struct.pack(">b", code)
    out += payload


def _array(v):
    """``(shape, dtype name, C-order bytes)`` of a numpy array or a tensor."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            return tuple(v.shape), "bfloat16", v.view(torch.int16).numpy().tobytes()
        v = v.numpy()
    if v.dtype.hasobject or v.dtype.isalignedstruct:
        raise ValueError("flax msgpack: object and structured dtypes are not written")
    return v.shape, v.dtype.name, v.tobytes("C")


def _chunked(v):
    """flax's ``_chunk``: a leaf above ``MAX_CHUNK_SIZE`` bytes as a dict
    of flat chunks of ``MAX_CHUNK_SIZE`` bytes."""
    flat = v.reshape(-1)
    size = max(1, MAX_CHUNK_SIZE // flat.element_size() if isinstance(v, torch.Tensor)
               else int(MAX_CHUNK_SIZE / v.dtype.itemsize))
    n = flat.numel() if isinstance(v, torch.Tensor) else flat.size
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(v.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return v.size * v.dtype.itemsize


def _pack(out: bytearray, v, tree: bool = True, chunk: bool = True) -> None:
    """Append ``v``. ``tree``: ``v`` is a part of the caller's tree, whose
    dicts are written in sorted key order (jax's ``tree_map`` rebuilds them
    so before flax packs them), not of a chunked leaf's own dicts, which keep
    their order; ``chunk``: a leaf here above ``MAX_CHUNK_SIZE`` bytes is
    chunked (flax chunks the leaves that dicts hold, and a root leaf)."""
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        if chunk and _nbytes(v) > MAX_CHUNK_SIZE:
            _pack(out, _chunked(v), tree=False)
            return
        inner = bytearray()
        _pack(inner, _array(v), tree=False)
        _pack_ext(out, _EXT_NDARRAY, bytes(inner))
    elif isinstance(v, np.generic):
        inner = bytearray()
        _pack(inner, _array(np.asarray(v)), tree=False)
        _pack_ext(out, _EXT_NPSCALAR, bytes(inner))
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(0xcb)
        out += struct.pack(">d", v)
    elif type(v) is complex:
        inner = bytearray()
        _pack(inner, [v.real, v.imag], tree=False)
        _pack_ext(out, _EXT_COMPLEX, bytes(inner))
    elif type(v) is str:
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 31, (0xd9, 0xda, 0xdb), "str")
        out += b
    elif type(v) in (bytes, bytearray, memoryview):
        b = bytes(v)
        _pack_len(out, len(b), None, 0, (0xc4, 0xc5, 0xc6), "bin")
        out += b
    elif type(v) in (list, tuple):
        _pack_len(out, len(v), 0x90, 15, (None, 0xdc, 0xdd), "array")
        for x in v:
            _pack(out, x, tree, chunk=False)
    elif type(v) is dict:
        _pack_len(out, len(v), 0x80, 15, (None, 0xde, 0xdf), "map")
        for k, x in (sorted(v.items()) if tree else v.items()):
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"flax msgpack: map key {k!r} is not str or bin")
            _pack(out, k)
            _pack(out, x, tree, chunk=tree)
    else:
        raise TypeError(f"flax msgpack: cannot write a {type(v).__name__}")


def serialize(tree) -> bytes:
    """The bytes of flax's ``msgpack_serialize(tree)`` for a tree of
    str-keyed dicts whose leaves are numpy arrays, torch tensors (on any
    device), numpy scalars or Python values."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def write(path: str, tree) -> None:
    with open(path, "wb") as f:
        f.write(serialize(tree))
