"""The appendable HDF5 writer of ``data/hdf5.py`` (``Writer``,
``GrowingDataset``) against h5py, and the reader's slices of the first two
axes.

Seeded arrays are appended in uneven pieces; h5py reads the file back
(shapes, dtypes, ``maxshape`` None on the growing axis, ``chunks``,
attributes, values bit for bit), appends to it in mode "a", and the port's
reader reads both. The chunk index has one level at 64 chunks, two past 64
and three past 4,096 (HDF5's default K of 32: 64 entries a node).
"""

import h5py
import numpy as np
import pytest

from spherical_dyffusion_tpu_torch.data import hdf5

H, W = 2, 3


def _pieces(total, seed):
    """Uneven lengths summing to ``total``."""
    r = np.random.default_rng(seed)
    out = []
    while sum(out) < total:
        out.append(min(int(r.integers(1, max(2, total // 3))), total - sum(out)))
    return out


def _levels(f: h5py.File, name: str) -> int:
    """The chunk B-tree's depth: its root node's level + 1."""
    with hdf5.File(f.filename) as pf:
        ds = pf[name]
        raw = pf.pread(ds._layout[1], 8)
    assert raw[:4] == b"TREE"
    return raw[5] + 1


@pytest.mark.parametrize("E,T,levels", [(2, 32, 1), (2, 40, 2), (1, 4100, 3)])
def test_growing_datasets_read_back_through_h5py_and_the_port(tmp_path, E, T, levels):
    """(E, T, H, W) float32 and (T, H, W) int64 and float64 series appended
    in uneven pieces, beside a contiguous ``lat`` and a nested group with a
    string attribute: h5py and the port's reader give the same arrays,
    h5py reports ``maxshape`` None on the time axis and chunks (1, 1, H, W),
    and the index has ``levels`` levels."""
    rng = np.random.default_rng(E * T)
    x = rng.standard_normal((E, T, H, W)).astype(np.float32)
    n = rng.integers(-2 ** 40, 2 ** 40, (T, H, W))
    d = rng.standard_normal((T, H, W))
    path = str(tmp_path / "g.nc")
    with hdf5.Writer(path) as w:
        w.write("lat", np.linspace(-1.0, 1.0, H))
        gx = w.create_growing("x", (E, 0, H, W), np.float32, 1,
                              {"long_name": "air temperature", "units": "K"})
        gn = w.create_growing("grp/sub/counts", (0, H, W), np.int64, 0)
        gd = w.create_growing("grp/edges", (0, H, W), np.float64, 0, {"n": np.int32(3)})
        t = 0
        for k in _pieces(T, 1):
            gx.append(x[:, t:t + k])
            gn.append(n[t:t + k])
            gd.append(d[t:t + k])
            t += k
        w.attrs("grp")["title"] = "nested"
        w.attrs("/")["history"] = "written by the port"
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["grp", "lat", "x"]
        ds = f["x"]
        assert (ds.shape, ds.dtype, ds.maxshape, ds.chunks) == (
            (E, T, H, W), np.float32, (E, None, H, W), (1, 1, H, W))
        assert dict(ds.attrs) == {"long_name": "air temperature", "units": "K"}
        assert isinstance(ds.attrs["units"], str)
        assert ds[()].tobytes() == x.tobytes()
        sub = f["grp/sub/counts"]
        assert (sub.dtype, sub.maxshape, sub.chunks) == (np.int64, (None, H, W), (1, H, W))
        assert np.array_equal(sub[()], n) and np.array_equal(f["grp/edges"][()], d)
        assert f["grp"].attrs["title"] == "nested" and f["grp/edges"].attrs["n"] == 3
        assert f.attrs["history"] == "written by the port"
        assert np.array_equal(f["lat"][()], np.linspace(-1.0, 1.0, H))
        assert _levels(f, "x") == levels
    with hdf5.File(path) as f:
        assert f["x"][()].tobytes() == x.tobytes()
        assert np.array_equal(f["x"][:, 3:9], x[:, 3:9])
        assert np.array_equal(f["grp/sub/counts"][()], n)
        assert f["grp"].attrs["title"] == "nested"


@pytest.mark.parametrize("E,T", [(2, 40), (1, 4100)])
def test_h5py_appends_to_a_port_file(tmp_path, E, T):
    """h5py opens the port's file in mode "a", resizes the time axis and
    writes new steps into the port's index (two and three levels); both
    readers then read the old steps and the new ones."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((E, T, H, W)).astype(np.float32)
    more = rng.standard_normal((E, 70, H, W)).astype(np.float32)
    path = str(tmp_path / "a.nc")
    with hdf5.Writer(path) as w:
        g = w.create_growing("x", (E, 0, H, W), np.float32, 1)
        g.append(x[:, :T // 2])
        g.append(x[:, T // 2:])
    with h5py.File(path, "a") as f:
        f["x"].resize(T + 70, axis=1)
        f["x"][:, T:] = more
    want = np.concatenate([x, more], 1)
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["x"][()], want)
    with hdf5.File(path) as f:
        assert np.array_equal(f["x"][()], want)


def test_writer_refusals_and_an_aborted_file(tmp_path):
    """A name taken twice, a dataset used as a group and an append of the
    wrong shape raise; an exception inside the ``with`` block leaves no
    file (nor its temporary); an empty growing dataset reads as (1, 0, H,
    W)."""
    path = tmp_path / "r.nc"
    with pytest.raises(RuntimeError, match="stop"):
        with hdf5.Writer(str(path)) as w:
            g = w.create_growing("x", (1, 0, H, W), np.float32, 1)
            g.append(np.zeros((1, 2, H, W), np.float32))
            with pytest.raises(ValueError, match="exists"):
                w.write("x", np.zeros(2))
            with pytest.raises(ValueError, match="not a group"):
                w.write("x/y", np.zeros(2))
            with pytest.raises(ValueError, match="cannot append"):
                g.append(np.zeros((1, 2, H, W + 1), np.float32))
            raise RuntimeError("stop")
    assert list(tmp_path.iterdir()) == []
    with hdf5.Writer(str(path)) as w:
        w.create_growing("x", (1, 0, H, W), np.float32, 1)
    with h5py.File(str(path), "r") as f:
        assert f["x"].shape == (1, 0, H, W) and f["x"].maxshape == (1, None, H, W)
    with hdf5.File(str(path)) as f:
        assert f["x"][()].shape == (1, 0, H, W)


def test_two_axis_slices_decode_only_their_chunks(tmp_path):
    """``ds[:, :n]`` of an (E, T, H, W) file chunked (1, 1, H, W) reads the
    E x n chunks it touches, not E x T, each straight into an array (stored
    unfiltered); a slice of two axes of a contiguous dataset reads one byte
    range a row; both equal numpy's slices, steps too."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 50, H, W)).astype(np.float32)
    path = str(tmp_path / "s.nc")
    with hdf5.Writer(path) as w:
        w.create_growing("x", (3, 0, H, W), np.float32, 1).append(x)
        w.write("c", x)
    with hdf5.File(path) as f:
        ds, c = f["x"], f["c"]
        ds._chunk_index()
        sizes = []
        real_into = f.read_into
        f.read_into = lambda buf, addr: sizes.append(len(buf)) or real_into(buf, addr)
        assert np.array_equal(ds[:, :4], x[:, :4])
        assert sizes == [H * W * 4] * (3 * 4)
        sizes.clear()
        assert np.array_equal(ds[1:3, 10:12], x[1:3, 10:12])
        assert len(sizes) == 2 * 2
        for key in ((slice(0, 3, 2), slice(5, 40, 7)), (slice(None), slice(48, None)),
                    (slice(2, 1), slice(None))):
            assert np.array_equal(ds[key], x[key]) and np.array_equal(c[key], x[key])
        sizes.clear()
        assert np.array_equal(c[:, 2:5], x[:, 2:5])
        assert sizes == [3 * H * W * 4] * 3
        with pytest.raises(NotImplementedError, match="first two axes"):
            ds[:, :, :1]
