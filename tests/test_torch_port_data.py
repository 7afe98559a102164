"""The port's netCDF data layer against the JAX package's, on the CPU, on
files the tests write with h5py (the JAX package reads them through h5py,
the port through ``data/hdf5.py``).

An FV3GFS-like tree at 8 x 16: two training members ``ic_0001`` and
``ic_0002`` and the validation member ``validation/ic_0011``, each two
files (windows cross them), the state, a forcing, ``ocean_fraction``, a
time-independent field, ``lat``/``lon`` and ``ak_*``/``bk_*``, a variable
packed as int16 with ``scale_factor``, ``add_offset`` and ``_FillValue``,
and ``centering.nc``/``scaling.nc``. Tolerances: arrays from the files and
the synthetic systems bit for bit; normalized batches bit for bit against
the JAX package's native packer (both packages' multiply by ``1 / std`` in
float32); ``run_dataset_inference``'s
logs 1e-5 of each value (or of 1 where smaller; a percent difference of
100).
"""

import os

import h5py
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data import datamodule as jdatamodule
from spherical_dyffusion_tpu.data import datasets as jdatasets
from spherical_dyffusion_tpu.data import get_normalizer as jget_normalizer
from spherical_dyffusion_tpu.data import netcdf as jnetcdf
from spherical_dyffusion_tpu.data.coords import VariableMetadata as JVariableMetadata
from spherical_dyffusion_tpu.inference.loop import run_dataset_inference as jrun_dataset_inference
from spherical_dyffusion_tpu_torch.data import coords, datamodule, datasets, netcdf
from spherical_dyffusion_tpu_torch.data.normalization import get_normalizer
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.inference.loop import exp_forcing_normalizer, \
    run_dataset_inference

STATE = ["PRESsfc", "surface_temperature", "air_temperature_0", "specific_total_water_0"]
FORCING = ["DSWRFtoa"]
H, W = 8, 16
LOG_TOL = 1e-5


def _write_member(d, n_time, seed, sigma="levels"):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for fi, n in enumerate([n_time // 2, n_time - n_time // 2]):
        with h5py.File(os.path.join(d, f"data_{fi}.nc"), "w") as f:
            for v in STATE + FORCING:
                f.create_dataset(v, data=1.0 + rng.standard_normal((n, H, W)).astype(np.float32))
            f.create_dataset("ocean_fraction",
                             data=(rng.standard_normal((n, H, W)) > 0).astype(np.float32))
            f.create_dataset("HGTsfc", data=rng.standard_normal((H, W)).astype(np.float32))
            packed = f.create_dataset("packed", data=rng.integers(-100, 100, (n, H, W),
                                                                  dtype=np.int16))
            packed.attrs["scale_factor"] = np.float32([0.5])
            packed.attrs["add_offset"] = np.float32([3.0])
            filled = rng.standard_normal((n, H, W)).astype(np.float32)
            filled[:, 0, 0] = -999.0
            ds = f.create_dataset("filled", data=filled, chunks=(1, H, W), compression="gzip")
            ds.attrs["_FillValue"] = np.float32([-999.0])
            f.create_dataset("lat", data=np.linspace(-80, 80, H))
            f.create_dataset("lon", data=np.linspace(0, 337.5, W))
            if sigma == "levels":
                for k, (a, b) in enumerate(zip(np.linspace(0, 50, 3), np.linspace(0, 1, 3))):
                    f.create_dataset(f"ak_{k}", data=np.float64(a))
                    f.create_dataset(f"bk_{k}", data=np.float64(b))
            else:
                f.create_dataset("ak", data=np.linspace(0, 100, 3))
                f.create_dataset("bk", data=np.linspace(0, 1, 3))
            phony = f.create_dataset("phony_dim", data=np.zeros(4, np.float32))
            phony.attrs["NAME"] = np.bytes_(
                "This is a netCDF dimension but not a netCDF variable         4")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("fv3gfs")
    _write_member(str(r / "ic_0001"), 10, seed=0)
    _write_member(str(r / "ic_0002"), 12, seed=1, sigma="flat")
    _write_member(str(r / "validation" / "ic_0011"), 9, seed=2)
    for fname, val in (("centering.nc", 1.0), ("scaling.nc", 0.7)):
        with h5py.File(r / fname, "w") as f:
            for i, v in enumerate(STATE + FORCING):
                f.create_dataset(v, data=np.float32(val + 0.1 * i))
            f.create_dataset("profile", data=np.ones(3, np.float32))  # not a scalar: skipped
    return str(r)


def _same(got, want, where=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    assert got.tobytes() == want.tobytes(), where


def test_netcdf_file_and_scalar_datasets_match_jax(root):
    """Variables (the phony dimension left out), shapes, dims, reads with
    ``_FillValue`` (NaN) and packed int16 promoted, slices, attributes;
    ``read_scalar_dataset`` and ``get_normalizer`` (and its KeyError)."""
    path = os.path.join(root, "ic_0001", "data_0.nc")
    with netcdf.NetCDFFile(path) as got, jnetcdf.NetCDFFile(path) as want:
        assert got.variables == want.variables and "phony_dim" not in got.variables
        for v in want.variables:
            assert got.shape(v) == want.shape(v) and got.dims_of(v) == want.dims_of(v)
            _same(got.read(v), want.read(v), v)
            if len(got.shape(v)) == 3:
                _same(got.read(v, slice(1, 4)), want.read(v, slice(1, 4)), v)
        assert np.isnan(got.read("filled")[:, 0, 0]).all()
        assert got.read("packed").dtype == np.float32
        _same(got.attr("packed", "scale_factor"), want.attr("packed", "scale_factor"))
    stats = os.path.join(root, "centering.nc")
    assert netcdf.read_scalar_dataset(stats) == jnetcdf.read_scalar_dataset(stats)
    names = STATE + FORCING
    args = (stats, os.path.join(root, "scaling.nc"), names)
    norm, jnorm = get_normalizer(*args), jget_normalizer(*args)
    assert norm.names == jnorm.names
    _same(norm.means.numpy(), np.asarray(jnorm.means))
    _same(norm.stds.numpy(), np.asarray(jnorm.stds))
    for fn in (get_normalizer, jget_normalizer):
        with pytest.raises(KeyError, match="missing_var"):
            fn(args[0], args[1], names + ["missing_var"])
    assert coords.VariableMetadata("K", "temp") == coords.VariableMetadata(
        **vars(JVariableMetadata("K", "temp")))


def test_netcdf_timeseries_matches_jax(root):
    """Steps, spatial shape, windows across the file boundary (with the
    time-independent ``HGTsfc`` broadcast), ``horizontal`` and ``sigma``
    from ``ak_*``/``bk_*`` and from ``ak``/``bk``."""
    names = STATE + FORCING + ["HGTsfc", "packed", "filled", "ocean_fraction"]
    for member in ("ic_0001", "ic_0002"):
        d = os.path.join(root, member)
        src, jsrc = datasets.NetCDFTimeSeries(d), jdatasets.NetCDFTimeSeries(d)
        assert src.n_timesteps == jsrc.n_timesteps and src.spatial_shape == jsrc.spatial_shape
        for start, length in ((0, 3), (3, 5), (src.n_timesteps - 2, 2)):
            got, want = src.read_window(start, length, names), jsrc.read_window(start, length,
                                                                              names)
            for n in names:
                _same(got[n], want[n], (member, start, n))
        _same(src.horizontal.lat, jsrc.horizontal.lat)
        _same(src.horizontal.lon, jsrc.horizontal.lon)
        _same(src.sigma.ak, jsrc.sigma.ak)
        _same(src.sigma.bk, jsrc.sigma.bk)
        src.close()
    single = os.path.join(root, "ic_0001", "data_1.nc")
    assert datasets.NetCDFTimeSeries(single).n_timesteps == 5
    with pytest.raises(FileNotFoundError):
        datasets.NetCDFTimeSeries(os.path.join(root, "validation"))


def test_concat_source_matches_jax(root):
    """Two members: the windowed samples of the concatenation (none crosses
    a member), and the refusal of a window across the boundary."""
    srcs = [datasets.NetCDFTimeSeries(os.path.join(root, m)) for m in ("ic_0001", "ic_0002")]
    jsrcs = [jdatasets.NetCDFTimeSeries(os.path.join(root, m)) for m in ("ic_0001", "ic_0002")]
    src, jsrc = datasets.ConcatSource(srcs), jdatasets.ConcatSource(jsrcs)
    assert src.member_bounds() == jsrc.member_bounds() == [(0, 10), (10, 22)]
    ds = datasets.WindowedDataset(src, in_names=STATE, horizon=3, forcing_names=FORCING)
    jds = jdatasets.WindowedDataset(jsrc, in_names=STATE, horizon=3, forcing_names=FORCING)
    assert len(ds) == len(jds) == (10 - 4 + 1) + (12 - 4 + 1)
    for i in (0, 6, 7, len(ds) - 1):
        got, want = ds[i], jds[i]
        for k in want:
            _same(got[k], want[k], (i, k))
    for s in (src, jsrc):
        with pytest.raises(IndexError, match="crosses"):
            s.read_window(8, 4, STATE)
        with pytest.raises(IndexError):
            s.read_window(22, 1, STATE)


def test_chaotic_modal_timeseries_matches_jax():
    kw = dict(n_timesteps=12, spatial_shape=(8, 16), seed=3, n_modes=5)
    src = datasets.ChaoticModalTimeSeries(["a", "b"], **kw)
    jsrc = jdatasets.ChaoticModalTimeSeries(["a", "b"], **kw)
    got, want = src.read_window(2, 6, ["b", "a"]), jsrc.read_window(2, 6, ["b", "a"])
    for n in want:
        _same(got[n], want[n], n)
    assert src.empirical_growth_factor(3, n_probe=4) == jsrc.empirical_growth_factor(3,
                                                                                      n_probe=4)
    for cls in (datasets.ChaoticModalTimeSeries, jdatasets.ChaoticModalTimeSeries):
        with pytest.raises(ValueError, match="4 modes"):
            cls(["a"], n_modes=3)


def _batches_equal(got_iter, want_iter):
    n = 0
    for got, want in zip(got_iter, want_iter):
        assert set(got) == set(want)
        for k in want:
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
            _same(g, want[k], k)
        n += 1
    return n


def _dm_cfg(root, **kw):
    return dict(in_names=STATE, out_names=STATE, forcing_names=FORCING, data_dir=root,
                data_dir_stats=root, horizon=3, prediction_horizon=4,
                prediction_horizon_long=4, batch_size=2, eval_batch_size=2, **kw)


@pytest.mark.parametrize("kw", [{}, {"debug_mode": True}, {"training_sub_paths": ["ic_0002"]}])
def test_fv3gfs_datamodule_matches_jax(root, kw):
    """Normalizers from the stats files, the train batches (both members,
    shuffled) and the val batches (``validation/ic_0011``), the grid."""
    dm = datamodule.FV3GFSDataModule(datamodule.DataModuleConfig(**_dm_cfg(root, **kw)))
    jdm = jdatamodule.FV3GFSDataModule(jdatamodule.DataModuleConfig(**_dm_cfg(root, **kw)))
    for a, b in ((dm.normalizer, jdm.normalizer),
                 (dm.forcing_normalizer, jdm.forcing_normalizer)):
        assert a.names == b.names
        _same(a.means.numpy(), np.asarray(b.means))
        _same(a.stds.numpy(), np.asarray(b.stds))
    assert len(dm.dataset("train")) == len(jdm.dataset("train"))
    assert _batches_equal(dm.train_batches(seed=4), jdm.train_batches(seed=4)) > 0
    assert _batches_equal(dm.val_batches(), jdm.val_batches()) > 0
    _same(dm.grid.horizontal.lat, jdm.grid.horizontal.lat)
    _same(dm.grid.sigma.bk, jdm.grid.sigma.bk)
    sub = datamodule.normalizer_for(STATE[1:3], dm.normalizer)
    jsub = jdatamodule.normalizer_for(STATE[1:3], jdm.normalizer)
    assert sub.names == jsub.names
    _same(sub.means.numpy(), np.asarray(jsub.means))


def test_fv3gfs_datamodule_falls_back_as_jax(root, tmp_path):
    """A data directory without ``ic_*`` members and without
    ``validation/ic_0011`` is read itself for both splits; without a
    stats directory both packages raise the same error."""
    cfg = dict(_dm_cfg(os.path.join(root, "ic_0001")), data_dir_stats=root)
    dm = datamodule.FV3GFSDataModule(datamodule.DataModuleConfig(**cfg))
    jdm = jdatamodule.FV3GFSDataModule(jdatamodule.DataModuleConfig(**cfg))
    assert isinstance(dm._source("train"), datasets.NetCDFTimeSeries)
    assert dm._source("val").files == jdm._source("val").files
    assert _batches_equal(dm.val_batches(), jdm.val_batches()) > 0
    no_stats = dict(_dm_cfg(str(tmp_path)), data_dir_stats=None, data_dir=None)
    errs = []
    for mod in (datamodule, jdatamodule):
        with pytest.raises(TypeError) as e:
            mod.FV3GFSDataModule(mod.DataModuleConfig(**no_stats))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("system", ["ou", "chaotic"])
def test_stochastic_datamodule_matches_jax(system):
    kw = dict(channels=2, height=8, width=16, horizon=3, n_timesteps=24, n_val_timesteps=12,
              batch_size=2, n_modes=4, system=system, prefetch_depth=0)
    dm, jdm = datamodule.StochasticDataModule(**kw), jdatamodule.StochasticDataModule(**kw)
    _same(dm.normalizer.means.numpy(), np.asarray(jdm.normalizer.means))
    _same(dm.normalizer.stds.numpy(), np.asarray(jdm.normalizer.stds))
    assert _batches_equal(dm.train_batches(seed=1), jdm.train_batches(seed=1)) == 10
    assert _batches_equal(dm.val_batches(), jdm.val_batches()) > 0
    with pytest.raises(ValueError, match="Unknown system"):
        datamodule.StochasticDataModule(**dict(kw, system="lorenz63"))


def test_run_dataset_inference_matches_jax(root, tmp_path):
    """A predictions file in ``PredictionWriter``'s layout, (E, T, H, W)
    chunked (1, 1, H, W) with an unlimited time axis (written by h5py as
    the JAX writer writes it), re-scored against the validation member:
    the logs of both packages (``LOG_TOL``), capped at 5 steps and not."""
    src = datasets.NetCDFTimeSeries(os.path.join(root, "validation", "ic_0011"))
    jsrc = jdatasets.NetCDFTimeSeries(os.path.join(root, "validation", "ic_0011"))
    path = str(tmp_path / "autoregressive_predictions.nc")
    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        for n in STATE[:2]:
            d = f.create_dataset(n, shape=(2, 0, H, W), maxshape=(2, None, H, W), dtype="f4",
                                 chunks=(1, 1, H, W))
            d.resize(7, axis=1)
            d[:, :] = 1.0 + rng.standard_normal((2, 7, H, W)).astype(np.float32)
    w = src.horizontal.area_weights()
    for n_steps in (None, 5):
        got = run_dataset_inference(path, src, STATE[:2], w, n_forward_steps=n_steps,
                                    device="cpu")
        want = jrun_dataset_inference(path, jsrc, STATE[:2], np.asarray(w),
                                      n_forward_steps=n_steps)
        assert set(got) == set(want) and len(want) > 10
        for k, v in want.items():
            scale = max(abs(float(v)), 100.0 if "percent_diff" in k else 1.0)
            assert abs(float(got[k]) - float(v)) <= LOG_TOL * scale, (k, got[k], v)
    agg = InferenceAggregator(STATE[:2], w)
    run_dataset_inference(path, src, STATE[:2], w, aggregator=agg, device="cpu")
    assert agg.reduced.series()["rmse"].shape == (7, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_dataset_inference(path, src, STATE[:2], w)


def test_exp_forcing_normalizer():
    class Exp:
        forcing_normalizer = "norm"

    assert exp_forcing_normalizer(Exp()) == "norm"
    with pytest.raises(ValueError, match="no forcing normalizer"):
        exp_forcing_normalizer(object())
