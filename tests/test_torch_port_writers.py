"""The rollout's output files: ``utils/naming.py``, ``evaluation/video.py``
and ``inference/writers.py`` against the JAX package's, and the writer in
the port's rollout loop, on the CPU at debug size.

Each writer gets the same seeded numpy arrays as its JAX counterpart and the
files are compared through h5py: values exactly equal (both write the same
float32; the statistics are the same numpy in float64), ``DynamicHistogram``
counts and edges exactly equal, ``VideoAggregator.get_videos`` exactly
equal (the same numpy operations in the same order).
"""

import inspect
import types

import h5py
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data import SyntheticTimeSeries as JSyntheticTimeSeries
from spherical_dyffusion_tpu.evaluation import video as jvideo
from spherical_dyffusion_tpu.inference import loop as jloop
from spherical_dyffusion_tpu.inference import writers as jwriters
from spherical_dyffusion_tpu.utils import naming as jnaming
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
from spherical_dyffusion_tpu_torch.evaluation import video
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.inference import writers
from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
from spherical_dyffusion_tpu_torch.utils import naming

H, W = 4, 8
NAMES = ["PRESsfc", "air_temperature_3", "mystery_field", "eastward_wind_0"]


def _window(rng, E, T, C=len(NAMES)):
    return (rng.standard_normal((E, T, H, W, C)).astype(np.float32) * 3 + 1,
            rng.standard_normal((T, H, W, C)).astype(np.float32))


def _same_files(got_path, want_path):
    """Every dataset and group of two files: names, shapes, dtypes,
    ``maxshape``, ``chunks``, attributes and values, exactly."""
    with h5py.File(got_path, "r") as got, h5py.File(want_path, "r") as want:
        gk, wk = [], []
        got.visit(gk.append)
        want.visit(wk.append)
        assert sorted(gk) == sorted(wk)
        for k in wk:
            g, w = got[k], want[k]
            assert dict(g.attrs) == dict(w.attrs), k
            if isinstance(w, h5py.Dataset):
                assert (g.shape, g.dtype, g.maxshape, g.chunks) == (
                    w.shape, w.dtype, w.maxshape, w.chunks), k
                assert g[()].tobytes() == w[()].tobytes(), k


def test_naming_is_a_copy_of_the_jax_module():
    """Every base name, a level-suffixed name of each levelled base, an
    unknown name: ``variable_metadata``, ``long_name`` and ``units`` as
    JAX's; the table itself equal."""
    assert naming._BASE == jnaming._BASE
    assert naming._LEVEL_RE.pattern == jnaming._LEVEL_RE.pattern
    names = list(jnaming._BASE) + [f"{b}_{k}" for b in jnaming._BASE for k in (0, 7)] + [
        "not_a_field", "no_suffix_x", "PRESsfc_2"]
    for n in names:
        assert naming.variable_metadata(n) == jnaming.variable_metadata(n), n
        assert naming.long_name(n) == jnaming.long_name(n)
        assert naming.units(n) == jnaming.units(n)


def test_prediction_writer_matches_jax(tmp_path):
    """Two members over windows of 5, 1 and 6 steps, targets saved, a
    subset of the names kept: the same file through h5py (chunks (1, 1, H,
    W), unlimited time), bf16-like float64 input cast to float32 as h5py
    casts it."""
    rng = np.random.default_rng(0)
    lat, lon = np.linspace(-60, 60, H), np.linspace(0, 315, W)
    kw = dict(n_ensemble=2, save_targets=True, save_names=NAMES[:3])
    got = writers.PredictionWriter(str(tmp_path / "p.nc"), NAMES, lat, lon, **kw)
    want = jwriters.PredictionWriter(str(tmp_path / "j.nc"), NAMES, lat, lon, **kw)
    for T in (5, 1, 6):
        p, t = _window(rng, 2, T)
        if T == 1:
            p = p.astype(np.float64)
        got.append(p, t)
        want.append(p, t)
    got.close()
    want.close()
    _same_files(str(tmp_path / "p.nc"), str(tmp_path / "j.nc"))
    with h5py.File(str(tmp_path / "p.nc"), "r") as f:
        assert f["PRESsfc"].shape == (2, 12, H, W) and f["PRESsfc"].maxshape == (2, None, H, W)
        assert "eastward_wind_0" not in f and f["target_PRESsfc"].shape == (12, H, W)


def test_dynamic_histogram_matches_jax():
    """Values that double the bins to the left, then to the right, then both,
    and a constant window (``EPSILON``): counts (int64) and edges exactly
    JAX's; every value counted; an odd ``n_bins`` raises JAX's error."""
    rng = np.random.default_rng(1)
    got, want = writers.DynamicHistogram(10), jwriters.DynamicHistogram(10)
    seen = 0
    for v in (rng.random(100), rng.random(50) - 3.5, 2 + 5 * rng.random(30),
              np.full(7, 0.25), 40 * rng.standard_normal(60)):
        got.add(v)
        want.add(v)
        seen += v.size
        assert got.counts.tobytes() == want.counts.tobytes()
        assert got.bin_edges.tobytes() == want.bin_edges.tobytes()
    assert got.counts.dtype == np.int64 and got.counts.sum() == seen
    assert got.EPSILON == want.EPSILON
    errors = []
    for cls in (writers.DynamicHistogram, jwriters.DynamicHistogram):
        with pytest.raises(ValueError) as e:
            cls(7)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_histogram_and_video_writers_match_jax(tmp_path):
    """``HistogramWriter.save`` and ``VideoWriter`` (``{key}-{name}`` with
    ``long_name``, ``units`` and ``dims``) over three windows of an
    ensemble of 3: the same files; ``VideoAggregator`` with and without
    targets: ``get_videos`` exactly JAX's, and ``save``'s ``{key}/{name}``
    groups the same file."""
    rng = np.random.default_rng(2)
    lat, lon = np.linspace(-60, 60, H), np.linspace(0, 315, W)
    hist, jhist = writers.HistogramWriter(NAMES, n_bins=8), jwriters.HistogramWriter(NAMES, 8)
    vid = writers.VideoWriter(str(tmp_path / "v.nc"), NAMES, lat, lon)
    jvid = jwriters.VideoWriter(str(tmp_path / "jv.nc"), NAMES, lat, lon)
    agg, jagg = video.VideoAggregator(NAMES), jvideo.VideoAggregator(NAMES)
    gen_only, jgen_only = video.VideoAggregator(NAMES), jvideo.VideoAggregator(NAMES)
    start = 0
    for T in (4, 3, 5):
        p, t = _window(rng, 3, T)
        for w in (hist, jhist, vid, jvid):
            w.append(p, t)
        agg.record_batch(p, t, start_step=start)
        jagg.record_batch(p, t, start_step=start)
        gen_only.record_batch(p[0], None, start_step=start)
        jgen_only.record_batch(p[0], None, start_step=start)
        start += T
    hist.save(str(tmp_path / "h.nc"))
    jhist.save(str(tmp_path / "jh.nc"))
    _same_files(str(tmp_path / "h.nc"), str(tmp_path / "jh.nc"))
    vid.close()
    jvid.close()
    _same_files(str(tmp_path / "v.nc"), str(tmp_path / "jv.nc"))
    for a, b in ((agg, jagg), (gen_only, jgen_only)):
        got, want = a.get_videos(), b.get_videos()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32 and got[k].tobytes() == want[k].tobytes(), k
    agg.save(str(tmp_path / "a.nc"))
    jagg.save(str(tmp_path / "ja.nc"))
    _same_files(str(tmp_path / "a.nc"), str(tmp_path / "ja.nc"))
    with h5py.File(str(tmp_path / "a.nc"), "r") as f:
        assert sorted(f.keys()) == ["error_mean", "gen_mean", "gen_variance", "target_mean"]
        assert sorted(f["gen_mean"].keys()) == sorted(NAMES)


class _Capture:
    def __init__(self):
        self.preds, self.targets = [], []

    def append(self, p, t=None):
        self.preds.append(np.array(p))
        self.targets.append(None if t is None else np.array(t))

    def close(self):
        pass


def test_time_coarsen_matches_jax_across_windows():
    """Factor 3 over windows of 4, 3, 1 and 5 steps (each crossing a group
    boundary): the coarsened predictions and targets as JAX's, on the same
    boundaries (JAX's ``tests/test_inference.py:679``), four groups in
    three appends; the steps carried
    into the next window are copies, so overwriting an appended array
    changes nothing (the rollout reuses its host buffers)."""
    rng = np.random.default_rng(3)
    cap, jcap = _Capture(), _Capture()
    tc, jtc = writers.TimeCoarsen(cap, 3), jwriters.TimeCoarsen(jcap, 3)
    p_all, t_all = [], []
    for T in (4, 3, 1, 5):
        p, t = _window(rng, 2, T)
        p_all.append(p.copy())
        t_all.append(t.copy())
        tc.append(p, t)
        jtc.append(p.copy(), t.copy())
        p[...] = np.nan
        t[...] = np.nan
    assert len(cap.preds) == len(jcap.preds) == 3  # the window of 1 completes no group
    for a, b in zip(cap.preds + cap.targets, jcap.preds + jcap.targets):
        assert a.tobytes() == b.tobytes()
    preds, targets = np.concatenate(p_all, 1), np.concatenate(t_all, 0)
    got = np.concatenate(cap.preds, 1)
    assert got.shape[1] == 4
    np.testing.assert_array_equal(got[:, 1], preds[:, 3:6].mean(axis=1))
    np.testing.assert_array_equal(np.concatenate(cap.targets)[3], targets[9:12].mean(axis=0))


def test_data_writer_matches_jax_with_time_coarsening(tmp_path):
    """``DataWriter`` with every option and ``time_coarsen_factor`` 2 over
    windows of 3 and 5 steps: ``autoregressive_predictions.nc`` and
    ``reduced_autoregressive_predictions.nc`` as JAX's; the histograms go
    to ``histograms.nc`` at ``close`` (JAX's ``close`` writes none), as
    JAX's ``HistogramWriter.save`` over the same windows. JAX's config
    errors: names without prediction files, and unknown names."""
    rng = np.random.default_rng(4)
    lat, lon = np.linspace(-60, 60, H), np.linspace(0, 315, W)
    opts = dict(save_prediction_files=True, save_histogram_files=True,
                log_extended_video_netcdfs=True, save_raw_prediction_names=NAMES[1:],
                time_coarsen_factor=2)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = writers.DataWriter(writers.DataWriterConfig(**opts), str(tmp_path / "p"), NAMES,
                             lat, lon, 2)
    want = jwriters.DataWriter(jwriters.DataWriterConfig(**opts), str(tmp_path / "j"), NAMES,
                               lat, lon, 2)
    for T in (3, 5):
        p, t = _window(rng, 2, T)
        got.append(p, t)
        want.append(p, t)
    got.close()
    want.close()
    for name in ("autoregressive_predictions.nc", "reduced_autoregressive_predictions.nc"):
        _same_files(str(tmp_path / "p" / name), str(tmp_path / "j" / name))
    want.writers[-1].save(str(tmp_path / "jh.nc"))
    _same_files(str(tmp_path / "p" / "histograms.nc"), str(tmp_path / "jh.nc"))
    assert writers.DataWriterConfig.from_dict(opts) == writers.DataWriterConfig(**opts)
    for bad in ({"save_raw_prediction_names": ["PRESsfc"]},):
        errors = []
        for cfg in (writers.DataWriterConfig, jwriters.DataWriterConfig):
            with pytest.raises(ValueError) as e:
                cfg(**bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    errors = []
    for cls, d in ((writers.PredictionWriter, "p2"), (jwriters.PredictionWriter, "j2")):
        with pytest.raises(ValueError) as e:
            cls(str(tmp_path / d / "x.nc"), NAMES, lat, lon, save_names=["PRESsfc", "nope"])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_a_writer_with_several_initial_conditions_raises_as_jax():
    """``run_inference`` with a writer and two initial conditions: JAX's
    error, raised by both loops before any window runs."""
    names = ["a", "b"]
    packer = types.SimpleNamespace(names=names)
    jexp = types.SimpleNamespace(in_packer=packer, out_packer=packer, forcing_names=[])
    jstep = types.SimpleNamespace(exp=jexp, prescriber=None, preds_dtype=None, horizon=3)
    exp = types.SimpleNamespace(in_packer=packer, out_packer=packer, forcing_names=[],
                                model=torch.nn.Linear(1, 1))
    step = types.SimpleNamespace(exp=exp, prescriber=None, preds_dtype=None, horizon=3)
    cfg = dict(n_forward_steps=3, forward_steps_in_memory=3, n_initial_conditions=2)
    errors = []
    with pytest.raises(ValueError) as e:
        jloop.run_inference(jstep, JSyntheticTimeSeries(names, 8, (H, W)),
                            jloop.InferenceConfig(**cfg), writer=_Capture(), verbose=False)
    errors.append(str(e.value))
    with pytest.raises(ValueError) as e:
        run_inference(step, SyntheticTimeSeries(names, 8, (H, W)), InferenceConfig(**cfg),
                      writer=_Capture(), verbose=False)
    errors.append(str(e.value))
    assert errors[0] == errors[1] and "single initial condition" in errors[0]
    assert "data writers support a single initial condition" in inspect.getsource(
        jloop.run_inference)


def test_videos_nc_errors_raise(tmp_path, capsys):
    """A ``videos.nc`` that cannot be written (a directory holds its name):
    JAX's ``_save_media`` prints the error and goes on, so the file the
    user asked for is missing; the port's raises (a deliberate departure,
    ROADMAP Queue 3). The port's aggregator records the video from the
    window's host copies, which it needs, and saves it beside the
    directory as JAX's does."""
    from spherical_dyffusion_tpu.run_inference import _save_media as jsave_media
    from spherical_dyffusion_tpu_torch.run_inference import _save_media

    rng = np.random.default_rng(6)
    p, t = _window(rng, 2, 3)
    agg = InferenceAggregator(NAMES, torch.ones(H, W), log_zonal_mean_images=False,
                              log_video=True)
    with pytest.raises(ValueError, match="host copies"):
        agg.record_batch(torch.from_numpy(p), torch.from_numpy(t))
    agg.record_batch(torch.from_numpy(p), torch.from_numpy(t), host=(p, t))
    jagg = types.SimpleNamespace(snapshots=types.SimpleNamespace(snapshots={}), zonal=None,
                                 video=jvideo.VideoAggregator(NAMES))
    jagg.video.record_batch(p, t)
    (tmp_path / "videos.nc").mkdir()
    jsave_media(jagg, NAMES, str(tmp_path))
    assert "[media] skipped" in capsys.readouterr().out
    with pytest.raises(OSError):
        _save_media(agg, NAMES, str(tmp_path))
    assert [f.name for f in tmp_path.iterdir()] == ["videos.nc"]  # no temporary left
    (tmp_path / "videos.nc").rmdir()
    _save_media(agg, NAMES, str(tmp_path))
    jagg.video.save(str(tmp_path / "jvideos.nc"))
    _same_files(str(tmp_path / "videos.nc"), str(tmp_path / "jvideos.nc"))


@pytest.mark.parametrize("targets_dtype", ["float32", "bfloat16"])
def test_run_inference_hands_the_writer_each_window(targets_dtype):
    """The port's loop on the CPU (embed 16 x 2, 16 x 32, horizon 3, three
    windows of 3 steps over a source that repeats, so the upload cache hits):
    the writer gets every window's denormalized predictions and the float32
    target rows as read, the aggregator's video the targets in the targets
    dtype (bf16-rounded, as JAX gives the uploaded ones); with a writer the
    logs equal the writer-off run's bit for bit, and ``time/writer_and_
    aggregator`` is reported."""
    st = main_path.build(embed=16, layers=2, img_shape=(16, 32), n_state=5, horizon=3,
                         dtype="float32", device="cpu")
    names = list(st.exp.out_packer.names)
    src = SyntheticTimeSeries(names + list(main_path.FORCING_NAMES) + [main_path.MASK_NAME],
                              n_timesteps=3, spatial_shape=(16, 32))
    cfg = InferenceConfig(n_forward_steps=9, forward_steps_in_memory=3, n_repeats=5,
                          targets_dtype=targets_dtype)
    preds = []
    run = st.run_window

    def record(*args, **kwargs):
        x, p = run(*args, **kwargs)
        preds.append(p)
        return x, p

    def rollout(writer):
        agg = InferenceAggregator(names, src.horizontal.area_weights(), log_video=True,
                                  log_zonal_mean_images=False)
        summary = run_inference(st, src, cfg, aggregator=agg, writer=writer,
                                mask_name=main_path.MASK_NAME, verbose=False)
        return agg, summary

    off, _ = rollout(None)
    cap = _Capture()
    st.run_window = record
    try:
        agg, summary = rollout(cap)
    finally:
        st.run_window = run
    assert summary["time/writer_and_aggregator"] > 0 and len(cap.preds) == 3
    norm = st.exp.normalizer.subset(names)
    # the source's 3 frames repeat: steps 3w+1..3w+3 read frames 1, 2, 0
    rows = src.read_window(0, 3, names)
    frames = np.stack([rows[n] for n in names], -1)[[1, 2, 0]]
    for w, p in enumerate(preds):
        assert np.array_equal(cap.preds[w], (p * norm.stds + norm.means).numpy())
        assert np.array_equal(cap.targets[w], frames)
    assert agg.get_logs() == off.get_logs()
    want = cap.targets[0].astype(np.float32)
    if targets_dtype == "bfloat16":
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        assert not np.array_equal(want, cap.targets[0])
    np.testing.assert_array_equal(agg.video.get_videos()["target_mean"][:3], want)
    np.testing.assert_array_equal(agg.video.get_videos()["gen_mean"][3:6], cap.preds[1][0])
