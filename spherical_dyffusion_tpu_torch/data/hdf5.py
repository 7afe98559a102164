"""Read and write the HDF5 subset that netCDF-4 files use, with the standard
library and numpy alone (no h5py).

The counterpart of h5py's read side as the JAX package's
``data/netcdf.py`` uses it: ``File(path)`` opens a file, ``file[name]``
gives a ``Group`` or a ``Dataset``, ``.attrs`` their attributes, and
``dataset[sl]`` reads a slice along the leading axis. Every read goes
through ``os.pread``, so threads that share a ``File`` never share a file
position. What it reads:

* superblocks v0-v3; object headers v1 (with continuation blocks) and v2
  (``OHDR``/``OCHK``, lookup3 checksums verified);
* groups: symbol tables (B-tree v1 type 0, local heap, ``SNOD``), compact
  link messages, and dense links (link info, the fractal heap's direct and
  indirect blocks, the v2 B-tree name index); attributes compact and dense
  (attribute info);
* datatypes: fixed-point and IEEE floats in both byte orders, fixed-length
  strings, variable-length strings and sequences of object references
  (``DIMENSION_LIST``) through the global heap (``GCOL``), object
  references;
* dataspaces, fill values, compact, contiguous and chunked layouts (B-tree
  v1 type 1 index), the filter pipeline (v1 and v2 messages) with deflate
  and shuffle.

A slice along the leading axis decodes only the chunks it touches, and
reads only its byte range of a contiguous dataset. Anything else raises
``NotImplementedError`` naming the structure (layout-v4 chunk indexes,
fletcher32, szip, nbit, scale-offset, compound types, shared messages, soft
and external links, a user block):
the reader never returns bytes it has not decoded. Values follow h5py's
types: an attribute is a ``str`` for a variable-length string, a
``numpy.bytes_`` for a fixed-length one, a numpy scalar or array
otherwise; arrays are writable; members are listed by name, or by
creation order where the file tracks it.

``write_hdf5`` writes the same subset back: contiguous datasets with
numeric and string attributes (``str`` as variable-length strings, as h5py
writes them), readable by h5py and by this reader.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "Reference", "AttributeManager", "Writer",
           "GrowingDataset", "write_hdf5", "lookup3"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x06, 0x08, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scale-offset"}
_CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                  5: "v2 B-tree"}

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of HDF5's v2
    metadata."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    i = 0
    while n - i > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & _M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & _M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32  # noqa: E702
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32  # noqa: E702
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32  # noqa: E702
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32  # noqa: E702
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32  # noqa: E702
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32  # noqa: E702
        i += 12
    if n == i:
        return c
    tail = bytes(data[i:]) + b"\0" * (12 - (n - i))
    a = (a + int.from_bytes(tail[0:4], "little")) & _M32
    b = (b + int.from_bytes(tail[4:8], "little")) & _M32
    c = (c + int.from_bytes(tail[8:12], "little")) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M32  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M32  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M32  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M32  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M32  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M32  # noqa: E702
    return c


def _checked(block: bytes, what: str) -> bytes:
    """``block`` without its trailing lookup3 checksum, which must match."""
    want = int.from_bytes(block[-4:], "little")
    if lookup3(block[:-4]) != want:
        raise ValueError(f"HDF5 {what}: checksum mismatch")
    return block[:-4]


def _enc_size(n: int) -> int:
    """Bytes that encode values up to ``n`` (HDF5's ``H5VM_limit_enc_size``)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


class _Reader:
    """A cursor over bytes of metadata."""

    def __init__(self, data: bytes, so: int, sl: int, pos: int = 0):
        self.data, self.so, self.sl, self.pos = data, so, sl, pos

    def uint(self, n: int) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        if self.pos + n > len(self.data):
            raise ValueError("HDF5 metadata ends early")
        self.pos += n
        return v

    def u8(self) -> int:
        return self.uint(1)

    def u16(self) -> int:
        return self.uint(2)

    def u32(self) -> int:
        return self.uint(4)

    def addr(self) -> Optional[int]:
        v = self.uint(self.so)
        return None if v == (1 << (8 * self.so)) - 1 else v

    def length(self) -> int:
        return self.uint(self.sl)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("HDF5 metadata ends early")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def expect(self, sig: bytes, what: str) -> None:
        if self.take(len(sig)) != sig:
            raise ValueError(f"HDF5 {what}: no {sig!r} signature")


class Reference:
    """An object reference: the address of the object header it points to
    (``File.deref`` opens it)."""

    __slots__ = ("addr",)

    def __init__(self, addr: int):
        self.addr = addr

    def __repr__(self):
        return f"<HDF5 object reference {self.addr:#x}>"


# ---------------------------------------------------------------- datatypes

class _Type:
    """A decoded datatype message: ``kind`` is "fixed" (``dtype`` a numpy
    dtype: integers, floats, fixed-length strings), "vlen_str",
    "vlen_seq" (of object references, ``base``), "ref" or "unsupported"
    (``what`` names it; raised when a value of the type is read)."""

    def __init__(self, kind: str, size: int, dtype=None, base=None, what: str = ""):
        self.kind, self.size, self.dtype, self.base, self.what = kind, size, dtype, base, what

    @property
    def numpy_dtype(self):
        return self.dtype if self.kind == "fixed" else np.dtype(object)


def _parse_type(r: _Reader) -> _Type:
    b0 = r.u8()
    cls, bits = b0 & 0x0F, r.uint(3)
    size = r.u32()
    if cls == 0:  # fixed-point
        order = ">" if bits & 1 else "<"
        r.u16(), r.u16()
        if size not in (1, 2, 4, 8):
            return _Type("unsupported", size, what=f"{size}-byte integer")
        return _Type("fixed", size, np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
    if cls == 1:  # IEEE float
        if bits & 0x40:
            return _Type("unsupported", size, what="VAX float")
        order = ">" if bits & 1 else "<"
        _, prec, _, _, _, _, _ = struct.unpack("<HHBBBBI", r.take(12))
        if size not in (2, 4, 8) or prec != 8 * size:
            return _Type("unsupported", size, what=f"{size}-byte float of {prec} bits")
        return _Type("fixed", size, np.dtype(f"{order}f{size}"))
    if cls == 3:  # fixed-length string
        return _Type("fixed", size, np.dtype(f"S{size}"))
    if cls == 7:  # reference
        if bits & 0x0F != 0:
            return _Type("unsupported", size, what="dataset region reference")
        return _Type("ref", size)
    if cls == 9:  # variable-length
        base = _parse_type(r)
        if bits & 0x0F == 1:
            return _Type("vlen_str", size, base=base)
        if base.kind != "ref":
            return _Type("unsupported", size,
                         what="variable-length sequence of other than object references")
        return _Type("vlen_seq", size, base=base)
    names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 8: "enumeration",
             10: "array"}
    return _Type("unsupported", size, what=f"{names.get(cls, f'class {cls}')} datatype")


def _parse_space(r: _Reader) -> Optional[Tuple[int, ...]]:
    """A dataspace message's shape: () scalar, None null."""
    version, rank, flags = r.u8(), r.u8(), r.u8()
    if version == 1:
        r.take(5)
        kind = 1 if rank else 0
    elif version == 2:
        kind = r.u8()
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    shape = tuple(r.length() for _ in range(rank))
    if kind == 2:
        return None
    return shape if kind == 1 else ()


# ------------------------------------------------------------------- the file

class File:
    """An HDF5 file opened for reading; ``file[path]`` opens a member."""

    def __init__(self, path: str):
        self.filename = str(path)
        self._fd = os.open(self.filename, os.O_RDONLY)
        try:
            self._objects: Dict[int, Any] = {}
            self._gheaps: Dict[int, Dict[int, bytes]] = {}
            self._paths: Optional[Dict[int, str]] = None
            root = self._superblock()
            self.root = Group(self, root, "/")
        except BaseException:
            os.close(self._fd)
            raise
        self._objects[root] = self.root

    # -- raw reads
    def read_into(self, buf: memoryview, addr: int) -> None:
        """Fills ``buf`` with the bytes at ``addr`` (relative to the base
        address), through ``os.preadv``."""
        off, got = self._base + addr, 0
        while got < len(buf):
            n = os.preadv(self._fd, [buf[got:]], off + got)
            if n <= 0:
                raise ValueError(f"{self.filename}: truncated at byte {off + got}")
            got += n

    def pread(self, addr: int, n: int) -> bytearray:
        buf = bytearray(n)
        self.read_into(memoryview(buf), addr)
        return buf

    def _reader(self, addr: int, n: int) -> _Reader:
        return _Reader(bytes(self.pread(addr, n)), self.so, self.sl)

    def _superblock(self) -> int:
        if bytes(os.pread(self._fd, 8, 0)) != SIGNATURE:
            raise ValueError(f"{self.filename}: not an HDF5 file (or one with a user block)")
        self._base = 0
        head = bytes(os.pread(self._fd, 16, 0))
        version = head[8]
        if version in (0, 1):
            so, sl = head[13], head[14]
            r = _Reader(bytes(os.pread(self._fd, 128 + 6 * so, 0)), so, sl, 16)
            r.u16(), r.u16(), r.u32()  # group K values, consistency flags
            if version == 1:
                r.u16(), r.u16()
            base = r.addr()
            r.addr(), r.addr(), r.addr()  # free-space, end-of-file and VFD-info addresses
            r.addr()  # root symbol table entry: link name offset
            root = r.addr()
        elif version in (2, 3):
            so, sl = head[9], head[10]
            block = bytes(os.pread(self._fd, 12 + 4 * so + 4, 0))
            _checked(block, "superblock")
            r = _Reader(block, so, sl, 12)
            base = r.addr()
            r.addr(), r.addr()  # superblock extension, end of file
            root = r.addr()
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        self.so, self.sl = so, sl
        self._base = base or 0
        return root

    # -- objects
    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, path: str):
        return self.root[path]

    def keys(self) -> List[str]:
        return self.root.keys()

    @property
    def attrs(self) -> "AttributeManager":
        return self.root.attrs

    def _open(self, addr: int, name: str):
        obj = self._objects.get(addr)
        if obj is None:
            hdr = _Header(self, addr)
            types = {m[0] for m in hdr.msgs}
            if _LAYOUT in types:
                obj = Dataset(self, addr, name, hdr)
            elif _DATATYPE in types:
                raise NotImplementedError(f"HDF5 committed datatype {name!r}")
            else:
                obj = Group(self, addr, name, hdr)
            self._objects[addr] = obj
        return obj

    def deref(self, ref: Reference):
        """The object an object reference points to, with its path as
        ``name`` (the first found from the root)."""
        if self._paths is None:
            paths, todo = {self.root.addr: "/"}, [self.root]
            while todo:
                g = todo.pop(0)
                for key, link in g._link_table().items():
                    if link[0] != "hard" or link[1] in paths:
                        continue
                    paths[link[1]] = g.name.rstrip("/") + "/" + key
                    child = g[key]
                    if isinstance(child, Group):
                        todo.append(child)
            self._paths = paths
        if ref.addr not in self._paths:
            raise KeyError(f"object reference {ref.addr:#x} points outside the group tree")
        return self._open(ref.addr, self._paths[ref.addr])

    def _global_heap_object(self, addr: int, index: int) -> bytes:
        heap = self._gheaps.get(addr)
        if heap is None:
            r = self._reader(addr, 8 + self.sl)
            r.expect(b"GCOL", "global heap")
            r.u8(), r.take(3)
            size = r.length()
            r = self._reader(addr, size)
            r.pos = 8 + self.sl
            heap = {}
            while r.pos + 8 + self.sl <= size:
                idx = r.u16()
                r.u16(), r.u32()
                n = r.length()
                if idx == 0:
                    break
                heap[idx] = r.take(n)
                r.pos += (-n) % 8
            self._gheaps[addr] = heap
        return heap[index]

    # -- values
    def decode(self, t: _Type, raw: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        """The values of ``shape`` elements of type ``t`` stored in ``raw``,
        as a writable numpy array (object arrays for variable-length
        values and references)."""
        n = math.prod(shape)
        if t.kind == "fixed":
            return np.frombuffer(bytes(raw[:n * t.size]), t.dtype, n).reshape(shape).copy()
        if t.kind == "unsupported":
            raise NotImplementedError(f"HDF5 {t.what}")
        out = np.empty(n, object)
        if t.kind == "ref":
            for i in range(n):
                out[i] = Reference(int.from_bytes(raw[i * t.size:i * t.size + self.so],
                                                  "little"))
            return out.reshape(shape)
        step = 4 + self.so + 4
        for i in range(n):
            r = _Reader(bytes(raw[i * step:(i + 1) * step]), self.so, self.sl)
            count, coll, index = r.u32(), r.uint(self.so), r.u32()
            data = self._global_heap_object(coll, index) if count else b""
            if t.kind == "vlen_str":
                out[i] = bytes(data[:count]).split(b"\0", 1)[0].decode("utf-8")
            else:
                out[i] = self.decode(t.base, data, (count,))
        return out.reshape(shape)


class _Header:
    """An object header's messages: ``msgs`` a list of ``(type, flags,
    data, creation order)``; ``attr_order`` is set where the header tracks
    its attributes' creation order."""

    def __init__(self, f: File, addr: int):
        self.msgs: List[Tuple[int, int, bytes, Optional[int]]] = []
        self.attr_order = False
        head = bytes(f.pread(addr, 16))
        blocks: List[Tuple[int, int]] = []
        if head[:4] == b"OHDR":
            flags = head[5]
            fixed = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            head = bytes(f.pread(addr, fixed + width))
            size0 = int.from_bytes(head[fixed:fixed + width], "little")
            block = _checked(bytes(f.pread(addr, fixed + width + size0 + 4)), "object header")
            self.attr_order = bool(flags & 0x04)
            self._v2(f, block, fixed + width, flags, blocks)
            while blocks:
                a, n = blocks.pop(0)
                block = _checked(bytes(f.pread(a, n)), "object header continuation")
                if block[:4] != b"OCHK":
                    raise ValueError("HDF5 object header continuation: no b'OCHK' signature")
                self._v2(f, block, 4, flags, blocks)
        elif head[0] == 1:
            size = int.from_bytes(head[8:12], "little")
            todo = [(addr + 16, size)]
            while todo:
                a, n = todo.pop(0)
                self._v1(f, bytes(f.pread(a, n)), todo)
        else:
            raise NotImplementedError(f"HDF5 object header version {head[0]} at {addr:#x}")

    def _v1(self, f: File, block: bytes, todo: list) -> None:
        pos = 0
        while pos + 8 <= len(block):
            mtype, size, flags = struct.unpack_from("<HHB", block, pos)
            data = block[pos + 8:pos + 8 + size]
            pos += 8 + size
            self._add(f, mtype, flags, data, None, todo)

    def _v2(self, f: File, block: bytes, pos: int, hflags: int, todo: list) -> None:
        hsize = 6 if hflags & 0x04 else 4
        while pos + hsize <= len(block):
            mtype, size, flags = struct.unpack_from("<BHB", block, pos)
            crt = int.from_bytes(block[pos + 4:pos + 6], "little") if hflags & 0x04 else None
            data = block[pos + hsize:pos + hsize + size]
            pos += hsize + size
            self._add(f, mtype, flags, data, crt, todo)

    def _add(self, f: File, mtype: int, flags: int, data: bytes, crt, todo: list) -> None:
        if mtype == 0:
            return
        if mtype == _CONTINUATION:
            r = _Reader(data, f.so, f.sl)
            todo.append((r.addr(), r.length()))
            return
        if flags & 0x02:
            raise NotImplementedError(f"HDF5 shared message (type {mtype:#x})")
        self.msgs.append((mtype, flags, data, crt))

    def first(self, mtype: int) -> Optional[bytes]:
        for m in self.msgs:
            if m[0] == mtype:
                return m[2]
        return None


# ------------------------------------------------------ fractal heap, B-trees

class _FractalHeap:
    """A fractal heap's managed and tiny objects, by heap ID."""

    def __init__(self, f: File, addr: int):
        self.f = f
        r = f._reader(addr, 26 + 12 * f.sl + 3 * f.so)
        r.expect(b"FRHP", "fractal heap")
        r.u8()
        self.id_len, filt_len, self.flags = r.u16(), r.u16(), r.u8()
        self.max_managed = r.u32()
        r.length(), r.addr(), r.length(), r.addr()
        r.length(), r.length(), r.length(), r.length()
        r.length(), r.length(), r.length(), r.length()
        self.width = r.u16()
        self.start_block, self.max_direct = r.length(), r.length()
        self.max_heap_bits = r.u16()
        r.u16()
        self.root, self.root_rows = r.addr(), r.u16()
        if filt_len:
            raise NotImplementedError("HDF5 fractal heap with I/O filters")
        r.u32()
        end = r.pos
        _checked(r.data[:end], "fractal heap header")
        self.off_size = (self.max_heap_bits + 7) // 8
        self.len_size = min((int(math.log2(self.max_direct)) + 7) // 8,
                            _enc_size(self.max_managed))
        self.max_direct_rows = (int(math.log2(self.max_direct))
                                - int(math.log2(self.start_block)) + 2)
        self._blocks: Optional[List[Tuple[int, int, int]]] = None

    def _row_size(self, row: int) -> int:
        return self.start_block if row < 2 else self.start_block << (row - 1)

    def _direct_blocks(self) -> List[Tuple[int, int, int]]:
        """(heap offset, address, size) of every direct block."""
        if self._blocks is None:
            out: List[Tuple[int, int, int]] = []
            if self.root is not None:
                if self.root_rows == 0:
                    out.append((0, self.root, self.start_block))
                else:
                    self._indirect(self.root, self.root_rows, out)
            self._blocks = sorted(out)
        return self._blocks

    def _indirect(self, addr: int, nrows: int, out: list) -> None:
        f = self.f
        ndirect = min(nrows, self.max_direct_rows) * self.width
        nindirect = max(0, nrows - self.max_direct_rows) * self.width
        r = f._reader(addr, 5 + f.so + self.off_size + (ndirect + nindirect) * f.so + 4)
        r.expect(b"FHIB", "fractal heap indirect block")
        r.u8(), r.addr()
        offset = r.uint(self.off_size)
        for i in range(ndirect + nindirect):
            child = r.addr()
            size = self._row_size(i // self.width)
            if child is not None:
                if i < ndirect:
                    out.append((offset, child, size))
                else:
                    rows = int(math.log2(size)) - int(math.log2(self.start_block * self.width)) + 1
                    self._indirect(child, rows, out)
            offset += size

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:  # tiny: the object is in the ID
            return bytes(heap_id[1:1 + (heap_id[0] & 0x0F) + 1])
        if kind != 0:
            raise NotImplementedError("HDF5 fractal heap huge object")
        off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
        n = int.from_bytes(heap_id[1 + self.off_size:1 + self.off_size + self.len_size], "little")
        for start, addr, size in self._direct_blocks():
            if start <= off < start + size:
                return bytes(self.f.pread(addr + off - start, n))
        raise ValueError(f"HDF5 fractal heap: no direct block holds offset {off}")


def _btree2_records(f: File, addr: int) -> Tuple[int, List[bytes]]:
    """(type, records) of a v2 B-tree, in key order."""
    r = f._reader(addr, 18 + f.so + f.sl + 4)
    r.expect(b"BTHD", "v2 B-tree header")
    r.u8()
    btype, node_size, rec_size, depth = r.u8(), r.u32(), r.u16(), r.u16()
    r.u8(), r.u8()
    root, root_n = r.addr(), r.u16()
    r.length()
    _checked(r.data[:r.pos + 4], "v2 B-tree header")
    # the widths of the child pointers' record counts (HDF5's H5B2__hdr_init)
    max_leaf = (node_size - 10) // rec_size
    nrec_size = _enc_size(max_leaf)
    cum, cum_size = [max_leaf], [0]
    for d in range(1, depth + 1):
        ptr = f.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        n_int = (node_size - (10 + ptr)) // (rec_size + ptr)
        cum.append((n_int + 1) * cum[d - 1] + n_int)
        cum_size.append(_enc_size(cum[d]))
    out: List[bytes] = []

    def walk(a: int, nrec: int, d: int) -> None:
        if a is None or (nrec == 0 and d == 0):
            return
        ptr = f.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        n = 6 + nrec * rec_size + ((nrec + 1) * ptr if d else 0) + 4
        rr = f._reader(a, n)
        rr.expect(b"BTIN" if d else b"BTLF", "v2 B-tree node")
        _checked(rr.data, "v2 B-tree node")
        rr.u8(), rr.u8()
        recs = [rr.take(rec_size) for _ in range(nrec)]
        if not d:
            out.extend(recs)
            return
        kids = []
        for _ in range(nrec + 1):
            ca, cn = rr.addr(), rr.uint(nrec_size)
            if d > 1:
                rr.uint(cum_size[d - 1])
            kids.append((ca, cn))
        for i, (ca, cn) in enumerate(kids):
            walk(ca, cn, d - 1)
            if i < nrec:
                out.append(recs[i])

    walk(root, root_n, depth)
    return btype, out


def _btree1(f: File, addr: int, key_size: int) -> List[Tuple[bytes, int]]:
    """(left key, child address) of every leaf entry of a v1 B-tree."""
    out: List[Tuple[bytes, int]] = []
    todo = [addr]
    while todo:
        a = todo.pop(0)
        head = f._reader(a, 8 + 2 * f.so)
        head.expect(b"TREE", "v1 B-tree node")
        head.u8()
        level, used = head.u8(), head.u16()
        r = f._reader(a + 8 + 2 * f.so, used * (key_size + f.so) + key_size)
        kids = []
        for _ in range(used):
            key = r.take(key_size)
            kids.append((key, r.addr()))
        if level:
            todo[0:0] = [c for _, c in kids]
        else:
            out.extend(kids)
    return out


# -------------------------------------------------------------------- groups

class Group:
    """A group: its members by name (``keys()`` in h5py's order), its
    attributes."""

    def __init__(self, f: File, addr: int, name: str, hdr: Optional[_Header] = None):
        self.file, self.addr, self.name = f, addr, name
        self._hdr = hdr if hdr is not None else _Header(f, addr)
        self.attrs = AttributeManager(f, self._hdr)
        self._links: Optional[Dict[str, tuple]] = None

    def _link_table(self) -> Dict[str, tuple]:
        """name -> ("hard", address) | ("soft",) | ("external",), in h5py's
        iteration order."""
        if self._links is not None:
            return self._links
        f, hdr = self.file, self._hdr
        entries: List[Tuple[str, Optional[int], tuple]] = []
        sym = hdr.first(_SYMBOL_TABLE)
        if sym is not None:
            r = _Reader(sym, f.so, f.sl)
            tree, heap_addr = r.addr(), r.addr()
            hr = f._reader(heap_addr, 8 + 2 * f.sl + f.so)
            hr.expect(b"HEAP", "local heap")
            hr.u8(), hr.take(3)
            heap_size, _ = hr.length(), hr.length()
            heap = bytes(f.pread(hr.addr(), heap_size))
            for _, snod in _btree1(f, tree, f.sl):
                sr = f._reader(snod, 8)
                sr.expect(b"SNOD", "symbol table node")
                sr.u8(), sr.u8()
                n = sr.u16()
                ent = 2 * f.so + 24
                er = f._reader(snod + 8, n * ent)
                for i in range(n):
                    er.pos = i * ent
                    name_off, obj = er.uint(f.so), er.addr()
                    name = heap[name_off:heap.index(b"\0", name_off)].decode("utf-8")
                    entries.append((name, None, ("hard", obj)))
        else:
            tracked = False
            for mtype, _, data, _ in hdr.msgs:
                if mtype == _LINK:
                    entries.append(self._parse_link(data))
                elif mtype == _LINK_INFO:
                    r = _Reader(data, f.so, f.sl)
                    r.u8()
                    flags = r.u8()
                    tracked = bool(flags & 1)
                    if flags & 1:
                        r.uint(8)
                    heap_addr, name_tree = r.addr(), r.addr()
                    if heap_addr is not None and name_tree is not None:
                        heap = _FractalHeap(f, heap_addr)
                        btype, recs = _btree2_records(f, name_tree)
                        if btype != 5:
                            raise NotImplementedError(f"HDF5 link name index of type {btype}")
                        for rec in recs:
                            entries.append(self._parse_link(heap.get(rec[4:])))
            if tracked and all(e[1] is not None for e in entries):
                entries.sort(key=lambda e: e[1])
                self._links = {e[0]: e[2] for e in entries}
                return self._links
        entries.sort(key=lambda e: e[0].encode("utf-8"))
        self._links = {e[0]: e[2] for e in entries}
        return self._links

    def _parse_link(self, data: bytes) -> Tuple[str, Optional[int], tuple]:
        f = self.file
        r = _Reader(data, f.so, f.sl)
        if r.u8() != 1:
            raise NotImplementedError("HDF5 link message version")
        flags = r.u8()
        ltype = r.u8() if flags & 0x08 else 0
        crt = r.uint(8) if flags & 0x04 else None
        if flags & 0x10:
            r.u8()
        name = r.take(r.uint(1 << (flags & 3))).decode("utf-8")
        if ltype == 0:
            return name, crt, ("hard", r.addr())
        return name, crt, ("soft" if ltype == 1 else "external",)

    def keys(self) -> List[str]:
        return list(self._link_table())

    def __getitem__(self, path: str):
        if path.startswith("/"):
            return self.file.root[path.lstrip("/")] if path.strip("/") else self.file.root
        obj = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name} is not a group")
            link = obj._link_table().get(part)
            if link is None:
                raise KeyError(f"no member {part!r} in {obj.name}")
            if link[0] != "hard":
                raise NotImplementedError(f"HDF5 {link[0]} link {part!r}")
            obj = self.file._open(link[1], obj.name.rstrip("/") + "/" + part)
        return obj

    def __repr__(self):
        return f"<HDF5 group {self.name!r}>"


# ---------------------------------------------------------------- attributes

def _parse_attribute(f: File, data: bytes) -> Tuple[str, _Type, Optional[tuple], bytes]:
    r = _Reader(data, f.so, f.sl)
    version = r.u8()
    r.u8()
    nlen, tlen, slen = r.u16(), r.u16(), r.u16()
    if version == 3:
        r.u8()
    pad = (lambda n: n + (-n) % 8) if version == 1 else (lambda n: n)
    if version not in (1, 2, 3):
        raise NotImplementedError(f"HDF5 attribute message version {version}")
    name = r.take(pad(nlen))[:nlen].split(b"\0", 1)[0].decode("utf-8")
    t = _parse_type(_Reader(r.take(pad(tlen)), f.so, f.sl))
    shape = _parse_space(_Reader(r.take(pad(slen)), f.so, f.sl))
    return name, t, shape, data[r.pos:]


class AttributeManager:
    """The attributes of an object, read when first asked for and decoded
    one at a time (``attrs[name]``, ``get``, ``keys``, ``items``)."""

    def __init__(self, f: File, hdr: _Header):
        self._f, self._hdr = f, hdr
        self._raw: Optional[Dict[str, Tuple[_Type, Optional[tuple], bytes]]] = None

    def _table(self) -> Dict[str, Tuple[_Type, Optional[tuple], bytes]]:
        if self._raw is not None:
            return self._raw
        f, hdr = self._f, self._hdr
        found: List[Tuple[str, Optional[int], tuple]] = []
        for mtype, _, data, crt in hdr.msgs:
            if mtype == _ATTRIBUTE:
                name, t, shape, raw = _parse_attribute(f, data)
                found.append((name, crt, (t, shape, raw)))
            elif mtype == _ATTRIBUTE_INFO:
                r = _Reader(data, f.so, f.sl)
                r.u8()
                if r.u8() & 1:
                    r.u16()
                heap_addr, name_tree = r.addr(), r.addr()
                if heap_addr is None or name_tree is None:
                    continue
                heap = _FractalHeap(f, heap_addr)
                btype, recs = _btree2_records(f, name_tree)
                if btype != 8:
                    raise NotImplementedError(f"HDF5 attribute name index of type {btype}")
                for rec in recs:
                    name, t, shape, raw = _parse_attribute(f, heap.get(rec[:8]))
                    found.append((name, int.from_bytes(rec[9:13], "little"), (t, shape, raw)))
        if hdr.attr_order and all(e[1] is not None for e in found):
            found.sort(key=lambda e: e[1])
        else:
            found.sort(key=lambda e: e[0].encode("utf-8"))
        self._raw = {e[0]: e[2] for e in found}
        return self._raw

    def keys(self) -> List[str]:
        return list(self._table())

    def __contains__(self, name: str) -> bool:
        return name in self._table()

    def __getitem__(self, name: str):
        t, shape, raw = self._table()[name]
        if shape is None:
            raise NotImplementedError(f"HDF5 attribute {name!r} with a null dataspace")
        value = self._f.decode(t, raw, shape)
        return value[()] if shape == () else value

    def get(self, name: str, default: Any = None):
        return self[name] if name in self._table() else default

    def items(self) -> List[Tuple[str, Any]]:
        return [(k, self[k]) for k in self._table()]


# ------------------------------------------------------------------ datasets

class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``ds[()]`` reads it
    whole, ``ds[a:b]`` a range of the leading axis."""

    def __init__(self, f: File, addr: int, name: str, hdr: Optional[_Header] = None):
        self.file, self.addr, self.name = f, addr, name
        hdr = hdr if hdr is not None else _Header(f, addr)
        self.attrs = AttributeManager(f, hdr)
        space = hdr.first(_DATASPACE)
        shape = _parse_space(_Reader(space, f.so, f.sl)) if space is not None else None
        self.shape: Tuple[int, ...] = shape if shape is not None else ()
        self._null = shape is None
        self._type = _parse_type(_Reader(hdr.first(_DATATYPE), f.so, f.sl))
        self.dtype = self._type.numpy_dtype
        self._fill = self._fill_value(hdr)
        self._filters = self._parse_filters(hdr.first(_FILTERS))
        self._layout = self._parse_layout(hdr.first(_LAYOUT))
        self._chunks: Optional[List[Tuple[Tuple[int, ...], int, int, int]]] = None

    def __repr__(self):
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"

    def _fill_value(self, hdr: _Header) -> Optional[bytes]:
        data = hdr.first(_FILL)
        if data is not None:
            version = data[0]
            if version in (1, 2):
                defined = data[3]
                if version == 1 or defined:
                    n = int.from_bytes(data[4:8], "little")
                    return data[8:8 + n] if n else None
                return None
            if version == 3:
                if data[1] & 0x20:
                    n = int.from_bytes(data[2:6], "little")
                    return data[6:6 + n] if n else None
                return None
            raise NotImplementedError(f"HDF5 fill value message version {version}")
        data = hdr.first(_FILL_OLD)
        if data is not None:
            n = int.from_bytes(data[:4], "little")
            return data[4:4 + n] if n else None
        return None

    @staticmethod
    def _parse_filters(data: Optional[bytes]) -> List[Tuple[int, Tuple[int, ...]]]:
        if data is None:
            return []
        version, n = data[0], data[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = int.from_bytes(data[pos:pos + 2], "little")
            if version == 1 or fid >= 256:
                nlen = int.from_bytes(data[pos + 2:pos + 4], "little")
                pos += 4
            else:
                nlen = 0
                pos += 2
            _, nvals = struct.unpack_from("<HH", data, pos)
            pos += 4
            pos += (nlen + (-nlen) % 8) if version == 1 else nlen
            vals = struct.unpack_from(f"<{nvals}I", data, pos)
            pos += 4 * nvals
            if version == 1 and nvals % 2:
                pos += 4
            out.append((fid, vals))
        return out

    def _parse_layout(self, data: Optional[bytes]) -> tuple:
        f = self.file
        if data is None:
            raise ValueError(f"{self.name}: a dataset without a layout message")
        r = _Reader(data, f.so, f.sl)
        version = r.u8()
        if version in (1, 2):
            rank, cls = r.u8(), r.u8()
            r.take(5)
            addr = r.addr() if cls != 0 else None
            dims = tuple(r.u32() for _ in range(rank))
            if cls == 0:
                return ("compact", r.take(r.u32()))
            if cls == 1:
                return ("contiguous", addr)
            r.u32()
            return ("chunked", addr, dims[:-1])
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 layout message version {version}")
        cls = r.u8()
        if cls == 0:
            return ("compact", r.take(r.u16()))
        if cls == 1:
            return ("contiguous", r.addr())
        if cls == 2 and version == 3:
            rank = r.u8()
            addr = r.addr()
            dims = tuple(r.u32() for _ in range(rank))
            return ("chunked", addr, dims[:-1])
        if cls == 2:
            r.u8()
            rank, width = r.u8(), r.u8()
            dims = tuple(r.uint(width) for _ in range(rank))
            index = r.u8()
            return ("unsupported", f"layout-v4 chunk index: {_CHUNK_INDEXES.get(index, index)}",
                    dims)
        if cls == 3:
            return ("unsupported", "virtual dataset layout")
        raise NotImplementedError(f"HDF5 layout class {cls}")

    # -- reading
    def __getitem__(self, key) -> Any:
        """``[()]`` (or ``[...]``): the whole dataset (a numpy scalar for a
        scalar one); ``[a:b]`` or ``[a:b:k]``: rows of the leading axis;
        ``[a:b, c:d]``: a range of each of the first two axes. Only the
        chunks, or the byte ranges, that the slice touches are read."""
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            out = self._read([(0, self.shape[0])] if self.shape else [])
            return out[()] if self.shape == () else out
        keys = key if isinstance(key, tuple) else (key,)
        if (not self.shape or len(keys) > min(2, len(self.shape))
                or not all(isinstance(k, slice) for k in keys)):
            raise NotImplementedError(f"{self.name}[{key!r}]: this reader reads [()], a slice "
                                      "of the leading axis or slices of the first two axes")
        ranges, steps = [], []
        for k, n in zip(keys, self.shape):
            if k.step is not None and k.step < 1:
                raise ValueError(f"Step must be >= 1 (got {k.step})")
            start, stop, step = k.indices(n)
            ranges.append((start, max(start, stop)))
            steps.append(step)
        out = self._read(ranges)
        if any(s != 1 for s in steps):
            out = np.ascontiguousarray(out[tuple(slice(None, None, s) for s in steps)])
        return out

    def _read(self, ranges: List[Tuple[int, int]]) -> np.ndarray:
        """The ranges ``[start, stop)`` of the leading axes (none: the whole
        of a scalar), as a writable array."""
        if self._null:
            raise NotImplementedError(f"{self.name}: a dataset with a null dataspace")
        t = self._type
        if t.kind != "fixed":
            if t.kind == "unsupported":
                raise NotImplementedError(f"{self.name}: HDF5 {t.what}")
            raise NotImplementedError(f"{self.name}: a dataset of variable-length values or "
                                      "references")
        shape = tuple(b - a for a, b in ranges) + self.shape[len(ranges):]
        kind = self._layout[0]
        if kind == "unsupported":
            raise NotImplementedError(f"{self.name}: HDF5 {self._layout[1]}")
        if kind == "chunked":
            return self._read_chunked(ranges, shape)
        if kind == "compact":
            whole = np.frombuffer(bytes(self._layout[1]), t.dtype,
                                  math.prod(self.shape)).reshape(self.shape)
            return whole[tuple(slice(a, b) for a, b in ranges)].copy()
        if not self.shape:  # a scalar: its one element
            ranges = [(0, 1)]
        addr = self._layout[1]
        out = np.empty(shape, t.dtype)
        if addr is None:  # never written: the fill value
            self._fill_into(out)
            return out
        if not out.nbytes:
            return out
        row = math.prod(self.shape[1:]) * t.size
        (a0, b0), rest = ranges[0], ranges[1:]
        if not rest or rest[0] == (0, self.shape[1]):
            self.file.read_into(memoryview(out.reshape(-1).view(np.uint8)), addr + a0 * row)
            return out
        (a1, _), inner = rest[0], math.prod(self.shape[2:]) * t.size
        for i in range(b0 - a0):  # one read of the second axis's range a row
            self.file.read_into(memoryview(out[i].reshape(-1).view(np.uint8)),
                                addr + (a0 + i) * row + a1 * inner)
        return out

    def _fill_into(self, out: np.ndarray) -> None:
        if self._fill is None:
            out[...] = 0
        else:
            out[...] = np.frombuffer(bytes(self._fill), self._type.dtype, 1)[0]

    def _chunk_index(self) -> List[Tuple[Tuple[int, ...], int, int, int]]:
        """(offsets, address, stored bytes, filter mask) of every chunk."""
        if self._chunks is None:
            rank = len(self._layout[2])
            out = []
            addr = self._layout[1]
            if addr is not None:
                for key, child in _btree1(self.file, addr, 8 + 8 * (rank + 1)):
                    size, mask = struct.unpack_from("<II", key)
                    offs = struct.unpack_from(f"<{rank}Q", key, 8)
                    out.append((offs, child, size, mask))
            self._chunks = out
        return self._chunks

    def _read_chunked(self, ranges: List[Tuple[int, int]], shape: tuple) -> np.ndarray:
        t = self._type
        chunk = self._layout[2]
        out = np.empty(shape, t.dtype)
        need = math.prod(shape)
        covered = 0
        for fid, _ in self._filters:
            if fid not in (1, 2):
                raise NotImplementedError(
                    f"{self.name}: HDF5 {_FILTER_NAMES.get(fid, f'filter {fid}')} filter")

        def overlap(offs):
            """(source, destination) slices of a chunk at ``offs``, or None
            where it misses the ranges."""
            src, dst = [], []
            for d, (o, c) in enumerate(zip(offs, chunk)):
                start, stop = ranges[d] if d < len(ranges) else (0, self.shape[d])
                a, b = max(o, start), min(o + c, stop)
                if a >= b:
                    return None
                src.append(slice(a - o, b - o))
                dst.append(slice(a - start, b - start))
            return tuple(src), tuple(dst)

        for offs, addr, size, mask in self._chunk_index():
            where = overlap(offs)
            if where is None:
                continue
            n = math.prod(chunk) * t.size
            dst = out[where[1]]
            stored = all(mask & (1 << i) for i in range(len(self._filters)))
            if stored and size >= n and dst.shape == chunk and dst.flags.c_contiguous:
                # a whole chunk stored as is: read straight into the output
                self.file.read_into(memoryview(dst.reshape(-1).view(np.uint8)), addr)
                covered += dst.size
                continue
            raw = bytes(self.file.pread(addr, size))
            for i in reversed(range(len(self._filters))):
                if mask & (1 << i):
                    continue
                fid, vals = self._filters[i]
                raw = zlib.decompress(raw) if fid == 1 else _unshuffle(raw, t.size)
            if len(raw) < n:
                raise ValueError(f"{self.name}: a chunk decodes to {len(raw)} of {n} bytes")
            block = np.frombuffer(raw[:n], t.dtype).reshape(chunk)[where[0]]
            out[where[1]] = block
            covered += block.size
        if covered < need:  # chunks never written hold the fill value
            mask_out = np.ones(shape, bool)
            for offs, _, _, _ in self._chunk_index():
                where = overlap(offs)
                if where is not None:
                    mask_out[where[1]] = False
            fill = np.empty((), t.dtype)
            self._fill_into(fill)
            out[mask_out] = fill
        return out


def _unshuffle(raw: bytes, size: int) -> bytes:
    if size <= 1:
        return raw
    n = len(raw) // size
    body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
    return body + raw[n * size:]


# ------------------------------------------------------------------- writing

_UNDEF8 = b"\xff" * 8
_UNLIMITED = 0xFFFFFFFFFFFFFFFF  # H5S_UNLIMITED
# a version-0 superblock does not state the chunk index's B-tree K, so HDF5
# takes its default, 32: a node holds at most 2K = 64 chunks
_CHUNK_K = 32
# the K of the groups' B-tree nodes, which the superblock states
_GROUP_NODE_K = 16
_SUPERBLOCK_SIZE = 96


def _type_message(value: np.ndarray) -> bytes:
    """The datatype message of a numpy array's dtype (integers, IEEE
    floats, fixed-length strings)."""
    dt = value.dtype
    order = 1 if dt.byteorder == ">" or (dt.byteorder == "=" and
                                         np.little_endian is False) else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        ebits, mbits, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[dt.itemsize]
        bits = order | 0x20  # mantissa normalization: implied msb
        sign = 8 * dt.itemsize - 1
        return (bytes([0x11, bits, sign, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, mbits, ebits, 0, mbits, bias))
    if dt.kind == "S":
        return bytes([0x13, 0x00, 0, 0]) + struct.pack("<I", max(dt.itemsize, 1))
    raise TypeError(f"HDF5 writer: no HDF5 type for dtype {dt}")


def _vlen_str_type() -> bytes:
    base = bytes([0x10, 0, 0, 0]) + struct.pack("<I", 1) + struct.pack("<HH", 0, 8)
    return bytes([0x19, 0x01, 0x01, 0]) + struct.pack("<I", 16) + base


def _space_message(shape: Tuple[int, ...],
                   maxshape: Optional[Tuple[Optional[int], ...]] = None) -> bytes:
    """A version-1 dataspace; ``maxshape`` (None on an unlimited axis) is
    written where given, as h5py writes a resizable dataset's."""
    out = (bytes([1, len(shape), 0 if maxshape is None else 1, 0]) + b"\0" * 4
           + b"".join(struct.pack("<Q", n) for n in shape))
    if maxshape is not None:
        out += b"".join(struct.pack("<Q", _UNLIMITED if n is None else n) for n in maxshape)
    return out


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * ((-len(data)) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * ((-len(b)) % 8)


def _object_header(messages: bytes) -> bytes:
    """A version-1 object header around encoded messages."""
    count = 0
    pos = 0
    while pos < len(messages):
        count += 1
        pos += 8 + struct.unpack_from("<H", messages, pos + 2)[0]
    return struct.pack("<BBHII4x", 1, 0, count, 1, len(messages)) + messages


class _Stored:
    """A dataset awaiting its object header: its shape, dtype, attributes,
    and a contiguous address or a growing dataset's chunk blocks."""

    def __init__(self, shape, dtype, attrs, addr=None, growing=None):
        self.shape, self.dtype, self.attrs = tuple(shape), np.dtype(dtype), attrs
        self.addr, self.growing = addr, growing


class GrowingDataset:
    """A chunked dataset with one unlimited axis, written by ``append``.

    A chunk holds one index of every axis up to and including the growing
    one and the whole of every later axis: ``(1, 1, H, W)`` for an ``(E,
    T, H, W)`` dataset growing along T. ``append`` writes its chunks at the
    end of the file at once and keeps only their addresses; the chunk index
    is written by the file's ``close``."""

    def __init__(self, writer: "Writer", name: str, shape, dtype, axis: int):
        self._writer, self.name, self.axis = writer, name, axis
        self.dtype = np.dtype(dtype)
        self.shape = list(shape)
        self.shape[axis] = 0
        self.chunk = (1,) * (axis + 1) + tuple(self.shape[axis + 1:])
        self.chunk_bytes = math.prod(self.chunk) * self.dtype.itemsize
        if self.chunk_bytes >= 2 ** 32:
            raise ValueError(f"HDF5 writer: {name}: a chunk of {self.chunk_bytes} bytes")
        # (leading index, first index along the axis, count, address): the
        # chunks of one append for one leading index, consecutive in the file
        self._blocks: List[Tuple[Tuple[int, ...], int, int, int]] = []

    def append(self, values) -> None:
        """Appends ``values`` along the growing axis: their other axes are
        the dataset's; they are cast to its dtype as h5py casts them."""
        v = np.asarray(values)
        want = self.shape[:self.axis] + self.shape[self.axis + 1:]
        got = list(v.shape[:self.axis]) + list(v.shape[self.axis + 1:])
        if v.ndim != len(self.shape) or got != want:
            raise ValueError(f"HDF5 writer: {self.name}: cannot append an array of shape "
                             f"{v.shape} to one of shape {tuple(self.shape)} along axis "
                             f"{self.axis}")
        k = v.shape[self.axis]
        if not k:
            return
        v = np.ascontiguousarray(v, dtype=self.dtype)
        for idx in np.ndindex(*v.shape[:self.axis]):
            addr = self._writer._put(v[idx])
            self._blocks.append((idx, self.shape[self.axis], k, addr))
        self.shape[self.axis] += k

    def _index(self) -> Tuple[np.ndarray, np.ndarray]:
        """(offsets of every chunk, rank + 1 columns with the element
        axis's 0; their addresses), in the index's order."""
        rank, ax = len(self.shape), self.axis
        n = sum(b[2] for b in self._blocks)
        offs = np.zeros((n, rank + 1), np.uint64)
        addrs = np.empty(n, np.uint64)
        p = 0
        for idx, start, k, addr in self._blocks:
            offs[p:p + k, :ax] = idx
            offs[p:p + k, ax] = np.arange(start, start + k, dtype=np.uint64)
            addrs[p:p + k] = addr + self.chunk_bytes * np.arange(k, dtype=np.uint64)
            p += k
        order = np.lexsort(offs[:, :ax + 1].T[::-1])  # the first axis most significant
        return offs[order], addrs[order]


class Writer:
    """An HDF5 file written as its data arrives, readable by h5py and by
    this module's ``File``.

    ``write`` stores a whole array as a contiguous dataset; ``create_growing``
    gives a ``GrowingDataset`` whose time axis is unlimited and whose chunks
    go to the end of the file as they are appended, so no variable's series
    is held in memory. A name with ``/`` makes the groups above it.
    ``attrs(name)`` holds the attributes of a dataset or a group ("/" for
    the file): a ``str`` is stored as a variable-length UTF-8 string, as
    h5py stores one, ``bytes`` as a fixed-length string, numbers and arrays
    as numeric attributes.

    The file is written under a temporary name; ``close`` writes the
    metadata (the global heap of the string attributes, each chunked
    dataset's index as version-1 B-tree nodes of type 1, the object
    headers, the groups as symbol tables bottom-up, last the version-0
    superblock at offset 0) and only then renames it to ``path``: a writer
    that is never closed leaves no file that looks whole. The chunk index
    uses HDF5's default K of 32, which a version-0 superblock implies: nodes
    of 64 entries at their full size, as many levels as the chunks need (two
    past 64 chunks, three past 4,096), each key bounding the chunks below
    it, so that h5py can also append to the file in mode "a". Leaving the
    ``with`` block on an exception removes the temporary file."""

    def __init__(self, path: str):
        self.path = str(path)
        self._tmp = f"{self.path}.tmp{os.getpid()}"
        self._fh = open(self._tmp, "wb")
        self._fh.write(bytes(_SUPERBLOCK_SIZE))
        self._end = _SUPERBLOCK_SIZE
        self._datasets: Dict[str, _Stored] = {}
        self._groups: Dict[str, Dict[str, Any]] = {"": {}}  # path -> attributes

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()

    def _put(self, data) -> int:
        """Writes bytes or an array's buffer at the end of the file, 8-byte
        aligned; their address."""
        pad = (-self._end) % 8
        if pad:
            self._fh.write(bytes(pad))
            self._end += pad
        addr = self._end
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        self._fh.write(data)
        self._end += len(data)
        return addr

    def _claim(self, name: str) -> str:
        path = name.strip("/")
        parts = path.split("/")
        if not path or any(not p or "\0" in p for p in parts):
            raise ValueError(f"HDF5 writer: invalid name {name!r}")
        for i in range(1, len(parts)):
            group = "/".join(parts[:i])
            if group in self._datasets:
                raise ValueError(f"HDF5 writer: {group!r} is a dataset, not a group")
            self._groups.setdefault(group, {})
        if path in self._datasets or path in self._groups:
            raise ValueError(f"HDF5 writer: {path!r} exists")
        return path

    def write(self, name: str, data, attrs: Optional[Mapping[str, Any]] = None) -> None:
        """A contiguous dataset holding ``data`` (integers, IEEE floats or
        fixed-length strings, in the array's byte order)."""
        arr = np.asarray(data)
        if arr.dtype.kind == "U":
            raise TypeError(f"HDF5 writer: variable {name!r}: store strings as bytes")
        _type_message(arr)
        path = self._claim(name)
        addr = self._put(arr) if arr.nbytes else None
        self._datasets[path] = _Stored(arr.shape, arr.dtype, dict(attrs or {}), addr=addr)

    def create_growing(self, name: str, shape, dtype, axis: int,
                       attrs: Optional[Mapping[str, Any]] = None) -> GrowingDataset:
        """A dataset of ``shape`` whose ``axis`` starts empty and grows by
        ``append`` (``maxshape`` None there)."""
        if not 0 <= axis < len(shape):
            raise ValueError(f"HDF5 writer: axis {axis} of a rank-{len(shape)} dataset")
        _type_message(np.empty(0, dtype))
        path = self._claim(name)
        ds = GrowingDataset(self, path, shape, dtype, axis)
        self._datasets[path] = _Stored(shape, dtype, dict(attrs or {}), growing=ds)
        return ds

    def attrs(self, name: str) -> Dict[str, Any]:
        """The attribute dict of a dataset or a group ("/": the file's)."""
        path = name.strip("/")
        if path in self._groups:
            return self._groups[path]
        if path in self._datasets:
            return self._datasets[path].attrs
        raise KeyError(f"HDF5 writer: no member {name!r}")

    def abort(self) -> None:
        """Closes and removes the temporary file."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            os.unlink(self._tmp)

    def close(self) -> None:
        if self._fh is None:
            return
        try:
            root, root_scratch, leaf_k = self._metadata()
            sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                  + struct.pack("<HHI", leaf_k, _GROUP_NODE_K, 0) + struct.pack("<Q", 0)
                  + _UNDEF8 + struct.pack("<Q", self._end) + _UNDEF8
                  + struct.pack("<QQII", 0, root, 1, 0) + root_scratch)
            self._fh.seek(0)
            self._fh.write(sb)
            self._fh.flush()
            os.replace(self._tmp, self.path)
        except BaseException:
            self.abort()
            raise
        self._fh.close()
        self._fh = None

    # -- the metadata, written by close
    def _metadata(self) -> Tuple[int, bytes, int]:
        """Writes everything but the superblock: (the root group's header,
        its symbol-table scratch pad, the groups' leaf K)."""
        # variable-length strings go to one global heap collection
        vlen: List[bytes] = []
        group_order = sorted(self._groups, key=lambda g: -g.count("/") - (1 if g else 0))
        owners = [d.attrs for d in self._datasets.values()] + [self._groups[g] for g in
                                                               group_order]
        for amap in owners:
            for av in amap.values():
                if isinstance(av, str):
                    vlen.append(av.encode("utf-8"))
        heap_addr = None
        if vlen:
            objs = b""
            for i, s in enumerate(vlen, 1):
                objs += struct.pack("<HH4xQ", i, 1, len(s)) + _pad8(s)
            size = max(4096, 16 + len(objs) + 16)
            free = size - 16 - len(objs)
            coll = b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + objs
            coll += struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16)
            heap_addr = self._put(coll)
        counter = iter(range(1, len(vlen) + 1))  # heap indices, in the order encoded

        def encode_attrs(amap: Mapping[str, Any]) -> bytes:
            out = b""
            for an, av in amap.items():
                name = an.encode("utf-8") + b"\0"
                if isinstance(av, str):
                    i = next(counter)
                    tmsg, space = _vlen_str_type(), _space_message(())
                    data = struct.pack("<IQI", len(vlen[i - 1]), heap_addr, i)
                else:
                    arr = np.asarray(av)
                    if arr.dtype.kind == "U":
                        raise TypeError(f"HDF5 writer: attribute {an!r}: give one str, or bytes")
                    tmsg, space, data = _type_message(arr), _space_message(arr.shape), \
                        arr.tobytes()
                body = (struct.pack("<BBHHH", 1, 0, len(name), len(tmsg), len(space))
                        + _pad8(name) + _pad8(tmsg) + _pad8(space) + data)
                out += _message(_ATTRIBUTE, body)
            return out

        headers: Dict[str, int] = {}
        for path, d in self._datasets.items():
            typ = _message(_DATATYPE, _type_message(np.empty(0, d.dtype)), flags=1)
            if d.growing is None:
                nbytes = math.prod(d.shape) * d.dtype.itemsize
                fill = bytes([2, 2, 0, 1]) + struct.pack("<I", d.dtype.itemsize) + bytes(
                    d.dtype.itemsize)
                layout = bytes([3, 1]) + (struct.pack("<Q", d.addr) if d.addr is not None
                                          else _UNDEF8) + struct.pack("<Q", nbytes)
                msgs = _message(_DATASPACE, _space_message(d.shape))
            else:
                g = d.growing
                tree = self._chunk_btree(g) if g._blocks else None
                maxshape = tuple(None if i == g.axis else n for i, n in enumerate(g.shape))
                fill = bytes([2, 3, 2, 1]) + struct.pack("<I", 0)  # h5py's, for a chunked one
                layout = (bytes([3, 2, len(g.shape) + 1])
                          + (struct.pack("<Q", tree) if tree is not None else _UNDEF8)
                          + struct.pack(f"<{len(g.chunk) + 1}I", *g.chunk, d.dtype.itemsize))
                msgs = _message(_DATASPACE, _space_message(tuple(g.shape), maxshape), flags=0)
            msgs += (typ + _message(_FILL, fill, flags=1) + _message(_LAYOUT, layout)
                     + encode_attrs(d.attrs))
            headers[path] = self._put(_object_header(msgs))

        # the groups, deepest first, each a symbol table (local heap of
        # names, SNODs of at most 2 * leaf_k entries under one B-tree node of
        # at most 2 * _GROUP_NODE_K children)
        members: Dict[str, List[str]] = {g: [] for g in self._groups}
        for path in list(self._datasets) + [g for g in self._groups if g]:
            members[path.rpartition("/")[0]].append(path)
        most = max(len(m) for m in members.values())
        leaf_k = max(4, math.ceil(most / (4 * _GROUP_NODE_K)))
        scratch = {}
        for group in group_order:
            entries = {m.rpartition("/")[2]: headers[m] for m in members[group]}
            tree, heap = self._symbol_table(entries, leaf_k)
            msgs = _message(_SYMBOL_TABLE, struct.pack("<QQ", tree, heap)) \
                + encode_attrs(self._groups[group])
            headers[group] = self._put(_object_header(msgs))
            scratch[group] = struct.pack("<QQ", tree, heap)
        return headers[""], scratch[""], leaf_k

    def _symbol_table(self, entries: Mapping[str, int], leaf_k: int) -> Tuple[int, int]:
        """Writes a group's local heap, SNODs and B-tree node; (the node's
        address, the heap's)."""
        names = sorted(entries, key=lambda n: n.encode("utf-8"))
        heap = bytearray(8)  # offset 0: the empty string
        offsets = {}
        for n in names:
            offsets[n] = len(heap)
            heap += _pad8(n.encode("utf-8") + b"\0")
        heap += struct.pack("<QQ", 1, 16)  # one free block at the end (HDF5 needs room)
        heap_data = self._put(bytes(heap))
        local_heap = self._put(b"HEAP" + bytes([0, 0, 0, 0])
                               + struct.pack("<QQQ", len(heap), len(heap) - 16, heap_data))
        groups = [names[i:i + 2 * leaf_k] for i in range(0, len(names), 2 * leaf_k)]
        node = b"TREE" + bytes([0, 0]) + struct.pack("<H", len(groups)) + _UNDEF8 + _UNDEF8
        node += struct.pack("<Q", 0)
        for chunk in groups:
            ent = b"".join(struct.pack("<QQII16x", offsets[n], entries[n], 0, 0) for n in chunk)
            ent += b"\0" * (40 * (2 * leaf_k - len(chunk)))
            snod = self._put(b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(chunk)) + ent)
            node += struct.pack("<QQ", snod, offsets[chunk[-1]])
        node += b"\0" * (16 * (2 * _GROUP_NODE_K - len(groups)))
        return self._put(node), local_heap

    def _chunk_btree(self, g: GrowingDataset) -> int:
        """Writes the chunk index of a growing dataset, level by level;
        the root's address. Each node is written at its full size; a node's
        last key is its right neighbour's first, and the last node's is the
        bound past the last chunk (each chunked axis's offset + 1), as HDF5
        writes it."""
        offs, addrs = g._index()
        rank = len(g.shape)
        key_t = np.dtype([("size", "<u4"), ("mask", "<u4"), ("offs", "<u8", (rank + 1,))])
        ks = key_t.itemsize
        keys = np.zeros(len(offs), key_t)
        keys["size"] = g.chunk_bytes
        keys["offs"] = offs
        right = np.zeros(1, key_t)
        right["offs"] = np.asarray([int(o) + c for o, c in zip(offs[-1][:rank], g.chunk)]
                                   + [g.dtype.itemsize], np.uint64)
        keys, right = keys.view(np.uint8).reshape(-1, ks), right.view(np.uint8).reshape(ks)
        cap, level = 2 * _CHUNK_K, 0
        node_size = 24 + cap * 8 + (cap + 1) * ks
        children = addrs
        while True:
            n = len(children)
            n_nodes = -(-n // cap)
            pad = (-self._end) % 8
            base = self._end + pad
            body = np.zeros((n_nodes, node_size), np.uint8)
            pairs = np.zeros((n_nodes * cap, ks + 8), np.uint8)
            pairs[:n, :ks] = keys
            pairs[:n, ks:] = children.astype("<u8").view(np.uint8).reshape(n, 8)
            body[:, 24:24 + cap * (ks + 8)] = pairs.reshape(n_nodes, -1)
            body[:-1, 24 + cap * (ks + 8):] = keys[cap::cap]
            used = n - cap * (n_nodes - 1)
            body[-1, 24 + used * (ks + 8):24 + used * (ks + 8) + ks] = right
            node_addrs = base + node_size * np.arange(n_nodes, dtype=np.uint64)
            head = np.zeros(n_nodes, np.dtype([("sig", "S4"), ("type", "u1"), ("level", "u1"),
                                               ("used", "<u2"), ("left", "<u8"),
                                               ("right", "<u8")]))
            head["sig"], head["type"], head["level"], head["used"] = b"TREE", 1, level, cap
            head["used"][-1] = used
            head["left"] = _UNLIMITED
            head["left"][1:] = node_addrs[:-1]
            head["right"] = _UNLIMITED
            head["right"][:-1] = node_addrs[1:]
            body[:, :24] = head.view(np.uint8).reshape(n_nodes, 24)
            if self._put(body) != base:
                raise AssertionError("HDF5 writer: B-tree nodes misplaced")
            if n_nodes == 1:
                return base
            keys, children, level = keys[::cap], node_addrs, level + 1


def write_hdf5(path: str, variables: Mapping[str, np.ndarray],
               attrs: Optional[Mapping[str, Mapping[str, Any]]] = None) -> None:
    """Write ``variables`` (name -> array: integers, IEEE floats or fixed
    strings, stored contiguous, in the array's byte order) to a new HDF5
    file at ``path``, readable by h5py, through ``Writer``. ``attrs`` maps a
    variable name, or "/" for the file itself, to its attributes: ``str``
    values become variable-length UTF-8 strings (h5py reads them as
    ``str``), ``bytes`` fixed-length strings, numbers and arrays numeric
    attributes (a Python float a float64, an int an int64, as numpy converts
    them). Members are listed by name (a symbol-table root group,
    superblock v0)."""
    attrs = dict(attrs or {})
    unknown = set(attrs) - set(variables) - {"/"}
    if unknown:
        raise KeyError(f"write_hdf5: attributes of unknown variables {sorted(unknown)}")
    for n in variables:
        if not n or "/" in n or "\0" in n:
            raise ValueError(f"write_hdf5: invalid variable name {n!r}")
    with Writer(path) as w:
        for n in sorted(variables, key=lambda n: n.encode("utf-8")):
            w.write(n, variables[n], attrs.get(n))
        w.attrs("/").update(attrs.get("/", {}))
