"""The port's HDF5 reader and writer (``spherical_dyffusion_tpu_torch/data/
hdf5.py``) against h5py, on files the tests write with h5py.

Three modes, as h5py writes them: the default (superblock v0, symbol-table
groups, B-tree v1 chunk indexes), ``track_order=True`` (object header v2;
more than 8 links and attributes go dense: fractal heap and v2 B-trees,
here 60 variables, so the name index has an internal node and the heap an
indirect block) and ``libver="latest"`` (superblock v3, layout-v4 chunk
indexes, which the reader refuses by name). Values are held to h5py's bit
for bit (``tobytes``), with the same dtype; attribute types, member order
and dimension names as h5py gives them.
"""

import threading

import h5py
import numpy as np
import pytest

from spherical_dyffusion_tpu.data.netcdf import NetCDFFile as JNetCDFFile
from spherical_dyffusion_tpu_torch.data import hdf5
from spherical_dyffusion_tpu_torch.data.netcdf import NetCDFFile

T, H, W = 10, 6, 8
MODES = {"default": {}, "track_order": {"track_order": True}, "latest": {"libver": "latest"}}


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def _write(path, mode):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", **MODES[mode]) as f:
        f.attrs["title"] = "a variable-length string"
        f.attrs["Conventions"] = np.bytes_("CF-1.8")
        f.attrs["version"] = np.int32(3)
        f.create_dataset("gzip_shuffle", data=rng.standard_normal((T, H, W)).astype(np.float32),
                         chunks=(2, H, W), compression="gzip", shuffle=True)
        f.create_dataset("gzip", data=rng.standard_normal((T, H, W)), chunks=(3, 4, 5),
                         compression="gzip")
        # its 16 attributes go dense where it tracks their creation order
        f.create_dataset("contiguous", data=rng.standard_normal((T, H, W)).astype(np.float32),
                         track_order=mode == "track_order")
        f.create_dataset("big_endian", data=rng.standard_normal((T, H, W)).astype(">f4"),
                         chunks=(1, H, W), compression="gzip", shuffle=True)
        f.create_dataset("big_endian_contiguous", data=rng.standard_normal((T, H)).astype(">f8"))
        packed = f.create_dataset("packed", data=rng.integers(-300, 300, (T, H, W),
                                                              dtype=np.int16))
        packed.attrs["scale_factor"] = np.float32([0.25])
        packed.attrs["add_offset"] = np.float32([100.0])
        f.create_dataset("int_be", data=rng.integers(0, 1000, (T, H)).astype(">i2"))
        f.create_dataset("compact", data=np.arange(12, dtype=np.float32).reshape(3, 4),
                         dcpl=_compact_dcpl())
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("compact_scalar", data=np.float32(4.5), dcpl=_compact_dcpl())
        partial = f.create_dataset("partial", shape=(T, H), dtype="f4", chunks=(2, H),
                                   fillvalue=-7.0)
        partial[2:5] = 1.5
        lat = f.create_dataset("lat", data=np.linspace(-80, 80, H))
        lon = f.create_dataset("lon", data=np.linspace(0, 315, W))
        lat.make_scale("lat")
        lon.make_scale()
        for name in ("contiguous", "gzip_shuffle"):
            f[name].dims[1].attach_scale(lat)
            f[name].dims[2].attach_scale(lon)
        f["contiguous"].dims[0].label = "time"
        attrs = f["contiguous"].attrs
        attrs["units"] = "K"
        attrs["long_name"] = np.bytes_("air temperature")
        attrs["_FillValue"] = np.float32([9.96921e36])
        attrs["valid_range"] = np.asarray([0.0, 400.0])
        attrs["flag"] = np.int8(1)
        attrs["be"] = np.asarray([1.5, 2.5], ">f4")
        for i in range(10):
            attrs[f"extra_{i:02d}"] = np.float32(i)
        if mode == "track_order":
            for i in range(46):
                f.create_dataset(f"many_{i:02d}", data=np.full((2, 3), i, np.float32))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hdf5")
    out = {}
    for mode in MODES:
        out[mode] = str(d / f"{mode}.h5")
        _write(out[mode], mode)
    return out


def _same(got, want, where):
    """Same type, dtype, shape and bytes (object arrays element by element)."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray) and want.dtype == object:
        assert got.dtype == object and got.shape == want.shape, where
        for g, w in zip(got.ravel(), want.ravel()):
            if isinstance(w, h5py.Reference):
                assert isinstance(g, hdf5.Reference), where
            elif isinstance(w, np.ndarray):
                assert isinstance(g, np.ndarray) and g.shape == w.shape, where
            else:
                _same(g, w, where)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want), where
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), where
    else:
        assert got == want, where


def _readable(f, name):
    return not (f.filename.endswith("latest.h5")
                and name in ("gzip_shuffle", "gzip", "big_endian", "partial"))


@pytest.mark.parametrize("mode", list(MODES))
def test_reader_matches_h5py(files, mode):
    """Member order, every attribute (value, type, dtype; a compound one,
    ``REFERENCE_LIST``, raises naming its class), shapes and dtypes, whole
    reads and slices of the leading axis, bit for bit; writable arrays."""
    with h5py.File(files[mode], "r") as want, hdf5.File(files[mode]) as got:
        assert got.keys() == list(want.keys())
        if mode == "track_order":
            assert got.keys()[:3] == ["gzip_shuffle", "gzip", "contiguous"]
            assert len(got.keys()) > 50
        for obj_name in ["/"] + list(want.keys()):
            g, w = got[obj_name], want[obj_name]
            assert g.attrs.keys() == list(w.attrs.keys()), obj_name
            for k in w.attrs:
                if k == "REFERENCE_LIST":
                    with pytest.raises(NotImplementedError, match="compound datatype"):
                        g.attrs[k]
                    continue
                _same(g.attrs[k], w.attrs[k], f"{obj_name}@{k}")
            if obj_name == "/":
                continue
            assert g.shape == w.shape and g.dtype == w.dtype, obj_name
            if not _readable(got, obj_name):
                with pytest.raises(NotImplementedError, match="layout-v4 chunk index"):
                    g[()]
                continue
            full = g[()]
            _same(full, w[()], obj_name)
            if g.shape:
                assert full.flags.writeable
                full[...] = 0
                n = g.shape[0]
                for sl in (slice(0, 1), slice(1, 4), slice(3, n), slice(-3, None),
                           slice(5, 2), slice(0, n, 3), slice(1, None, 2)):
                    _same(g[sl], w[sl], f"{obj_name}[{sl}]")
                with pytest.raises(ValueError, match="Step"):
                    g[::-1]
                with pytest.raises(NotImplementedError, match="slice of the leading axis"):
                    g[n - 1]


def test_dense_storage_is_what_the_track_order_file_holds(files):
    """The track-order file's root links and the many-attribute dataset's
    attributes are dense (link and attribute info messages, no link or
    attribute message in the header), its links in a heap of several
    direct blocks under an indirect one, indexed by a two-level v2 B-tree;
    the default file's groups are symbol tables."""
    with hdf5.File(files["track_order"]) as f:
        types = {m[0] for m in f.root._hdr.msgs}
        assert hdf5._LINK_INFO in types and hdf5._LINK not in types
        # 60 links: the heap has a root indirect block, the name index a
        # second level
        r = hdf5._Reader(f.root._hdr.first(hdf5._LINK_INFO), f.so, f.sl, 2)
        r.uint(8)
        heap_addr, tree = r.addr(), r.addr()
        heap = hdf5._FractalHeap(f, heap_addr)
        assert heap.root_rows >= 1 and len(heap._direct_blocks()) > 1
        assert int.from_bytes(f.pread(tree + 12, 2), "little") == 1  # depth
        types = {m[0] for m in f["contiguous"].attrs._hdr.msgs}
        assert hdf5._ATTRIBUTE_INFO in types and hdf5._ATTRIBUTE not in types
    with hdf5.File(files["default"]) as f:
        assert f.root._hdr.first(hdf5._SYMBOL_TABLE) is not None


@pytest.mark.parametrize("mode", ["default", "track_order"])
def test_netcdf_file_matches_the_jax_module(files, mode):
    """``NetCDFFile`` over the reader against the JAX module over h5py:
    variables, ``dims_of`` (a label, attached scales, none), shapes, reads
    with the CF attributes applied (the int16 ``packed`` promoted as JAX
    promotes it), bit for bit."""
    with NetCDFFile(files[mode]) as got, JNetCDFFile(files[mode]) as want:
        assert got.variables == want.variables
        for name in want.variables:
            assert got.dims_of(name) == want.dims_of(name), name
            assert got.shape(name) == want.shape(name)
            a, b = got.read(name), want.read(name)
            _same(np.asarray(a), np.asarray(b), name)
            if got.shape(name):
                _same(got.read(name, slice(1, 3)), want.read(name, slice(1, 3)), name)
        assert got.dims_of("contiguous") == ("time", "lat", "lon")
        assert got.dims_of("gzip") == ("dim_0", "dim_1", "dim_2")
        assert got.read("packed").dtype == np.float32
        _same(got.attr("contiguous", "units"), want.attr("contiguous", "units"), "units")
        assert got.attr("contiguous", "missing", 3) == 3


@pytest.mark.parametrize("what,kwargs", [
    ("fletcher32", dict(fletcher32=True, chunks=(2, H))),
    ("scale-offset", dict(scaleoffset=2, chunks=(2, H))),
])
def test_unsupported_filters_raise_naming_them(tmp_path, what, kwargs):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.ones((T, H), np.float32), **kwargs)
    with hdf5.File(path) as f:
        assert f["x"].shape == (T, H)
        with pytest.raises(NotImplementedError, match=what):
            f["x"][()]


def test_nbit_filter_raises_naming_it(tmp_path):
    path = str(tmp_path / "n.h5")
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((2, H))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.ones((T, H), np.int32), dcpl=dcpl)
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match="nbit"):
            f["x"][1:3]


@pytest.mark.parametrize("index,kwargs", [
    ("fixed array", dict(chunks=(2, H))),
    ("extensible array", dict(chunks=(2, H), maxshape=(None, H))),
    ("v2 B-tree", dict(chunks=(2, H), maxshape=(None, None))),
    ("single chunk", dict(chunks=(T, H))),
])
def test_layout_v4_chunk_indexes_raise_naming_them(tmp_path, index, kwargs):
    path = str(tmp_path / "v4.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones((T, H), np.float32), **kwargs)
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match=f"layout-v4 chunk index: {index}"):
            f["x"][()]


def test_a_committed_datatype_raises_naming_it(tmp_path):
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w") as f:
        f["kind"] = np.dtype("f4")
        f.create_dataset("x", data=np.ones(3))
    with hdf5.File(path) as f:
        assert f.keys() == ["kind", "x"]
        with pytest.raises(NotImplementedError, match="committed datatype"):
            f["kind"]


def test_a_slice_reads_only_what_it_needs(files, monkeypatch):
    """Rows 3:5 of a dataset chunked by 2 rows decode the two chunks they
    touch (of 5); of a contiguous one, one read of their bytes."""
    inflated = []
    real = hdf5.zlib.decompress
    monkeypatch.setattr(hdf5.zlib, "decompress", lambda b: inflated.append(1) or real(b))
    reads = []
    real_read = hdf5.File.read_into
    monkeypatch.setattr(hdf5.File, "read_into",
                        lambda self, buf, addr: reads.append(len(buf)) or
                        real_read(self, buf, addr))
    with hdf5.File(files["default"]) as f:
        ds, cont = f["gzip_shuffle"], f["contiguous"]
        ds._chunk_index()
        inflated.clear()
        ds[3:5]
        assert len(inflated) == 2
        reads.clear()
        cont[3:5]
        assert reads == [2 * H * W * 4]


def test_checksums_are_verified(files, tmp_path):
    """A flipped byte inside a v2 object header fails its lookup3
    checksum."""
    data = bytearray(open(files["latest"], "rb").read())
    with hdf5.File(files["latest"]) as f:
        addr = f["contiguous"].addr
    data[addr + 8] ^= 0xFF
    bad = tmp_path / "bad.h5"
    bad.write_bytes(bytes(data))
    with hdf5.File(str(bad)) as f:
        with pytest.raises(ValueError, match="checksum"):
            f["contiguous"]


def test_threads_share_one_file(files):
    """Eight threads read slices of one open file at once (``os.pread``:
    no shared position): every slice equals h5py's."""
    with h5py.File(files["default"], "r") as w:
        want = {k: w[k][()] for k in ("gzip_shuffle", "contiguous", "big_endian")}
    errors = []
    with hdf5.File(files["default"]) as f:
        def work(seed):
            r = np.random.default_rng(seed)
            try:
                for _ in range(40):
                    k = list(want)[r.integers(len(want))]
                    a = int(r.integers(0, T - 1))
                    b = int(r.integers(a + 1, T + 1))
                    assert np.array_equal(f[k][a:b], want[k][a:b])
            except BaseException as e:  # noqa: BLE001 — collected, asserted below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


def test_write_hdf5_reads_the_same_through_h5py_and_jax(tmp_path):
    """``write_hdf5``'s file: every variable and attribute the same through
    h5py, the JAX ``NetCDFFile`` and the port's reader (bit for bit, h5py's
    types: a ``str`` attribute is a variable-length string)."""
    rng = np.random.default_rng(1)
    variables = {f"v{i:02d}": rng.standard_normal((4, H, W)).astype(np.float32)
                 for i in range(12)}
    variables.update(lat=np.linspace(-80, 80, H), big=np.arange(6, dtype=">i4").reshape(2, 3),
                     scalar=np.float32(1.25), empty=np.zeros((0, H), np.float32))
    attrs = {"/": {"title": "written", "history": b"fixed", "n": np.int32(3)},
             "v03": {"units": "K", "long_name": "temperature", "scale_factor": np.float32([2]),
                     "add_offset": np.float64(1.0), "valid": np.asarray([1, 2], np.int16)}}
    path = str(tmp_path / "w.nc")
    hdf5.write_hdf5(path, variables, attrs)
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert list(want.keys()) == got.keys() == sorted(variables)
        for name in ["/"] + sorted(variables):
            assert list(want[name].attrs.keys()) == got[name].attrs.keys()
            for k in want[name].attrs:
                _same(got[name].attrs[k], want[name].attrs[k], f"{name}@{k}")
            if name != "/":
                _same(got[name][()], want[name][()], name)
                assert np.asarray(want[name][()]).tobytes() == np.asarray(
                    variables[name]).tobytes()
        assert isinstance(want["v03"].attrs["units"], str)
    with NetCDFFile(path) as got, JNetCDFFile(path) as jf:
        assert got.variables == jf.variables
        for name in jf.variables:
            _same(np.asarray(got.read(name)), np.asarray(jf.read(name)), name)
    with pytest.raises(KeyError):
        hdf5.write_hdf5(path, variables, {"missing": {"a": 1}})
