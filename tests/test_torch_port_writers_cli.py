"""The inference command lines' output files against the JAX package's, on
the CPU at debug size, for the DYffusion and the ACE paths.

The checkpoints are other test files' module fixtures, built again here
without training: ``test_torch_port_data_cli.py``'s JAX checkpoints of an
interpolator and a forecaster over its FV3GFS-like netCDF tree (the
port's seeded weights, dropout off), and ``test_torch_port_ace_cli.py``'s
native ACE checkpoint. Both packages run ``main_from_config`` with the
same ``data_writer`` options and ``log_video``; the files are read through
h5py and each array held to JAX's within ``LOG_TOL`` (the data command
line's, 1e-5) of the variable's largest absolute value, on the ACE path
within ``ACE_TOL`` (1e-4, ``_assert_metrics``'s: the dry-air corrector's
float32 global means round differently in the two packages, 1.1e-5 of
PRESsfc's largest value here); ``metrics.json`` equals the port's own
writer-off run's, and JAX's within each path's tolerance.
"""

import json
import os

import h5py
import numpy as np
import pytest

from spherical_dyffusion_tpu.data import NetCDFTimeSeries as JNetCDFTimeSeries
from spherical_dyffusion_tpu.inference.loop import run_dataset_inference as jrun_dataset_inference
from spherical_dyffusion_tpu.inference.writers import DynamicHistogram as JDynamicHistogram
from spherical_dyffusion_tpu.run_inference import main_from_config as jmain_from_config
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datasets import NetCDFTimeSeries
from spherical_dyffusion_tpu_torch.inference.ace_stepper import SingleStepStepper
from spherical_dyffusion_tpu_torch.inference.loop import run_dataset_inference
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.run_inference import main_from_config
from test_torch_port_ace_cli import _assert_metrics, native  # noqa: F401 — a fixture
from test_torch_port_data_cli import LOG_TOL, STATE, _close, checkpoints, root  # noqa: F401

ACE_TOL = 1e-4
WRITERS = {"save_prediction_files": True, "save_histogram_files": True,
           "log_extended_video_netcdfs": True}


def _arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, (v[()], v.maxshape, v.chunks))
                     if isinstance(v, h5py.Dataset) else None)
    return out


def _close_files(got_path, want_path, tol=LOG_TOL):
    """The same datasets, shapes, ``maxshape`` and ``chunks``; values
    within ``tol`` of each dataset's largest absolute value."""
    got, want = _arrays(got_path), _arrays(want_path)
    assert sorted(got) == sorted(want)
    for k, (w, wmax, wchunks) in want.items():
        g, gmax, gchunks = got[k]
        assert (g.shape, g.dtype, gmax, gchunks) == (w.shape, w.dtype, wmax, wchunks), k
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.astype(np.float64) - w).max()) <= tol * scale, k


def _run(fn, cfg, d, **extra):
    fn(dict(cfg, experiment_dir=str(d), **extra))
    return json.loads((d / "metrics.json").read_text())


def _inference_logs(m):
    return {k: v for k, v in m.items() if k.startswith("inference/")}


def test_dyffusion_command_line_writes_the_files_jax_writes(root, checkpoints, tmp_path):
    """DYffusion over the validation member, 6 steps in windows of 3, the
    predictions of three of the four variables, videos, histograms and
    ``log_video``: ``autoregressive_predictions.nc``,
    ``reduced_autoregressive_predictions.nc`` and ``videos.nc`` as JAX's;
    ``histograms.nc`` (which JAX's ``close`` does not write) as JAX's
    ``DynamicHistogram`` over the written windows, every value counted;
    ``run_dataset_inference`` on the port's file as JAX's on its own."""
    data = os.path.join(root, "validation", "ic_0011")
    run = {"checkpoint_path": checkpoints["fc"], "n_forward_steps": 6,
           "forward_steps_in_memory": 3, "log_zonal_mean_images": False, "verbose": False,
           "validation_loader": {"dataset": {"data_path": data}}}
    on = dict(run, log_video=True,
              data_writer=dict(WRITERS, save_raw_prediction_names=STATE[:3]))
    want = _run(jmain_from_config, on, tmp_path / "jax")
    got = _run(main_from_config, on, tmp_path / "port", platform="cpu")
    off = _run(main_from_config, run, tmp_path / "off", platform="cpu")
    assert _inference_logs(got) == _inference_logs(off)
    _close({k: got[k] for k in _inference_logs(want)}, _inference_logs(want))
    for name in ("autoregressive_predictions.nc", "reduced_autoregressive_predictions.nc",
                 "videos.nc"):
        _close_files(tmp_path / "port" / name, tmp_path / "jax" / name)
    assert not (tmp_path / "off" / "autoregressive_predictions.nc").exists()
    with h5py.File(tmp_path / "port" / "autoregressive_predictions.nc", "r") as f, \
            h5py.File(tmp_path / "port" / "histograms.nc", "r") as h:
        for n in STATE[:3]:
            hist = JDynamicHistogram(300)
            for w in range(2):
                hist.add(f[n][:, 3 * w:3 * w + 3])
            assert h[f"{n}_counts"][()].tobytes() == hist.counts.tobytes()
            assert h[f"{n}_edges"][()].tobytes() == hist.bin_edges.tobytes()
            assert h[f"{n}_counts"][()].sum() == f[n].size
    with h5py.File(tmp_path / "port" / "videos.nc", "r") as v:
        assert sorted(v.keys()) == ["error_mean", "gen_mean", "gen_variance", "target_mean"]
        assert sorted(v["gen_mean"].keys()) == sorted(STATE)
    jsrc, src = JNetCDFTimeSeries(data), NetCDFTimeSeries(data)
    jlogs = jrun_dataset_inference(str(tmp_path / "jax" / "autoregressive_predictions.nc"),
                                   jsrc, STATE[:3], jsrc.horizontal.area_weights())
    logs = run_dataset_inference(str(tmp_path / "port" / "autoregressive_predictions.nc"),
                                 src, STATE[:3], src.horizontal.area_weights(), device="cpu")
    _close({k: float(v) for k, v in logs.items()}, {k: float(v) for k, v in jlogs.items()})


def test_ace_command_line_writes_the_files_jax_writes(native, tmp_path):
    """ACE from the native checkpoint, 6 steps in windows of 3, the
    diagnostics scored, every writer with ``time_coarsen_factor`` 2 (a group
    crosses the windows' boundary): the prognostic fields' prediction and
    video files as JAX's; ``metrics.json`` as the writer-off run's. The
    port also writes ``videos.nc`` (JAX's ACE path drops ``log_video``):
    its ensemble mean, coarsened, is the prediction file, over the scored
    names, diagnostics included."""
    run = {"checkpoint_path": native["path"], "stepper_type": "ace", "n_forward_steps": 6,
           "forward_steps_in_memory": 3, "verbose": False, "log_zonal_mean_images": False,
           "derived": True,
           "sigma_coordinates": {"ak": [0.0] * 4, "bk": [0.0, 0.03, 0.06, 0.1]}}
    on = dict(run, log_video=True, data_writer=dict(WRITERS, time_coarsen_factor=2))
    want = _run(jmain_from_config, on, tmp_path / "jax")
    got = _run(main_from_config, on, tmp_path / "port", platform="cpu")
    off = _run(main_from_config, run, tmp_path / "off", platform="cpu")
    assert _inference_logs(got) == _inference_logs(off)
    _assert_metrics(got, want)
    for name in ("autoregressive_predictions.nc", "reduced_autoregressive_predictions.nc"):
        _close_files(tmp_path / "port" / name, tmp_path / "jax" / name, ACE_TOL)
    assert not (tmp_path / "jax" / "videos.nc").exists()
    with h5py.File(tmp_path / "port" / "autoregressive_predictions.nc", "r") as f, \
            h5py.File(tmp_path / "port" / "videos.nc", "r") as v:
        prognostic = sorted(k for k in f.keys() if k not in ("lat", "lon"))
        assert prognostic == ["PRESsfc", "specific_total_water_0"]
        assert "total_water_path" in v["gen_mean"] and f["PRESsfc"].shape == (1, 3, 8, 16)
        for n in prognostic:
            mean = v["gen_mean"][n][()]
            np.testing.assert_array_equal(mean.reshape((3, 2) + mean.shape[1:]).mean(axis=1),
                                          f[n][0])


class _Fails(RuntimeError):
    pass


def _fail_at(monkeypatch, cls, attr, n):
    """``cls.attr`` raises at its ``n``-th call."""
    real, calls = getattr(cls, attr), [0]

    def wrapped(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == n:
            raise _Fails(f"call {n} of {attr}")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(cls, attr, wrapped)


@pytest.mark.parametrize("path", ["dyffusion", "ace", "product"])
def test_a_failed_rollout_leaves_no_file(path, request, monkeypatch, tmp_path):
    """A rollout whose stepper raises in its third window of three, after
    the first window's predictions went to disk, on each route that
    builds a ``DataWriter``: the DYffusion and ACE command lines (every
    writer, coarsened by 2) and ``main_path.product_rollout``. The error
    reaches the caller and every writer is aborted: the output directory
    holds neither a temporary file nor an output file."""
    run = {"n_forward_steps": 9, "forward_steps_in_memory": 3, "verbose": False,
           "log_zonal_mean_images": False, "log_video": True, "platform": "cpu",
           "experiment_dir": str(tmp_path),
           "data_writer": dict(WRITERS, time_coarsen_factor=2)}
    with pytest.raises(_Fails):
        if path == "dyffusion":
            _fail_at(monkeypatch, DYffusionStepper, "run_window", 3)
            data = os.path.join(request.getfixturevalue("root"), "validation", "ic_0011")
            main_from_config(dict(run, checkpoint_path=request.getfixturevalue("checkpoints")["fc"],
                                  validation_loader={"dataset": {"data_path": data}}))
        elif path == "ace":
            _fail_at(monkeypatch, SingleStepStepper, "run_on_batch", 3)
            main_from_config(dict(run, checkpoint_path=request.getfixturevalue("native")["path"],
                                  stepper_type="ace"))
        else:
            st = main_path.build(embed=16, layers=2, img_shape=(16, 32), n_state=5, horizon=3,
                                 dtype="float32", device="cpu")
            _fail_at(monkeypatch, DYffusionStepper, "run_window", 4)  # after the warm-up's
            main_path.product_rollout(st, n_steps=9, window=3, writer_dir=str(tmp_path))
    assert sorted(f.name for f in tmp_path.iterdir()) == []
