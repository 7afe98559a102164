"""Parity of the port's inference product path with the JAX package, on the CPU.

Metrics, the aggregators, the window reader, the window cap, the copied
sources and ``prefetched``, and ``run_inference`` end to end. Both packages
get the same numpy inputs and, for the rollouts, the same weights (the JAX
initializers' trees carried over by ``utils/convert.py``) at debug size: 16
x 32, embed 16, 2 layers, 4 channels, horizon 3, float32, interpolator
dropout off. Tolerances, float32 on both sides, summed in different orders:

* metrics 1e-6 relative to the value, or to 1 where the value is smaller
  (the inputs are of order 1, and a signed mean near 0 is a sum that
  cancels);
* aggregator logs and ``run_inference`` 1e-5: logs relative to each value
  (or to 1 where smaller), final states relative to their largest value, as
  for one window (``tests/test_torch_port_rollout.py``).

With dropout on the two packages' random streams differ by construction, so
those cases are checked on the port alone, as seeded statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data import StochasticModalTimeSeries as JStochastic
from spherical_dyffusion_tpu.data import SyntheticTimeSeries as JSynthetic
from spherical_dyffusion_tpu.data.datamodule import prefetched as jprefetched
from spherical_dyffusion_tpu.data.normalization import StandardNormalizer as JNormalizer
from spherical_dyffusion_tpu.data.packer import Packer as JPacker
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.evaluation import metrics as JM
from spherical_dyffusion_tpu.evaluation.aggregators import InferenceAggregator as JAggregator
from spherical_dyffusion_tpu.inference.loop import InferenceConfig as JInferenceConfig
from spherical_dyffusion_tpu.inference.loop import InferenceWindows as JInferenceWindows
from spherical_dyffusion_tpu.inference.loop import capped_window as jcapped_window
from spherical_dyffusion_tpu.inference.loop import run_inference as jrun_inference
from spherical_dyffusion_tpu.inference.prescriber import PrescriberConfig as JPrescriberConfig
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecasting,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import (
    InterpolationExperiment as JInterpolation,
)
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datamodule import prefetched
from spherical_dyffusion_tpu_torch.data.datasets import (
    StochasticModalTimeSeries,
    SyntheticTimeSeries,
)
from spherical_dyffusion_tpu_torch.data.normalization import StandardNormalizer
from spherical_dyffusion_tpu_torch.evaluation import metrics as M
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.data.packer import Packer
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import Intermediates
from spherical_dyffusion_tpu_torch.inference.loop import (
    InferenceConfig,
    InferenceWindows,
    capped_window,
    run_inference,
)
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.training.experiments import ExperimentConfig

torch.set_num_threads(2)

GRID = (16, 32)
N_STATE = 4
HORIZON = 3
MASK = main_path.MASK_NAME
NAMES = main_path.state_names(N_STATE)
FORCING = list(main_path.FORCING_NAMES)
MEANS = {n: 0.1 * i for i, n in enumerate(NAMES)}
STDS = {n: 1.0 + 0.25 * i for i, n in enumerate(NAMES)}
F_MEANS, F_STDS = {n: 0.2 for n in FORCING}, {n: 1.5 for n in FORCING}
METRIC_REL = 1e-6
ROLLOUT_REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scale(name: str, value) -> float:
    """What a tolerance is relative to: the value, or 1 where it is smaller;
    for a percent difference 100 (p / t - 1), 100, so that the ratio p / t
    is held to the tolerance."""
    return max(float(np.abs(value).max()), 100.0 if "percent_diff" in name else 1.0)


def _assert_logs_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - float(w)) <= rel * _scale(k, w), (k, got[k], w)


def _assert_area_weights_close(got, want):
    """Each side divides by its own float32 sum of the H x W weights, which
    rounds differently in another summation order; divided again by their
    sums in float64, the weights agree to 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert _rel(got / got.sum(), want / want.sum()) <= METRIC_REL


# ------------------------------------------------------------------ metrics

_r = np.random.default_rng(0)
TRUTH = _r.standard_normal((5, 8, 12, 3)).astype(np.float32)  # (T, H, W, C)
ENS = (TRUTH[None] + 0.5 * _r.standard_normal((4, 5, 8, 12, 3))).astype(np.float32)
PRED = ENS[0]
WEIGHTS = np.asarray(JM.spherical_area_weights(np.linspace(80, -80, 8), 12))[..., None]
SPATIAL = (-3, -2)

METRIC_CASES = {
    "weighted_mean": lambda m, t, w: m.weighted_mean(t(PRED), w, dim=SPATIAL),
    "weighted_mean_all_axes": lambda m, t, w: m.weighted_mean(t(PRED), w),
    "mean_unweighted": lambda m, t, w: m.weighted_mean(t(PRED), None, dim=(0, 1)),
    "weighted_std": lambda m, t, w: m.weighted_std(t(PRED), w, dim=SPATIAL),
    "weighted_mean_bias": lambda m, t, w: m.weighted_mean_bias(t(TRUTH), t(PRED), w, SPATIAL),
    "mean_squared_error": lambda m, t, w: m.mean_squared_error(t(TRUTH), t(PRED), w, SPATIAL),
    "root_mean_squared_error":
        lambda m, t, w: m.root_mean_squared_error(t(TRUTH), t(PRED), w, SPATIAL),
    "ensemble_spread": lambda m, t, w: m.ensemble_spread(t(ENS), w, SPATIAL),
    "spread_skill_ratio": lambda m, t, w: m.spread_skill_ratio(t(TRUTH), t(ENS), w, SPATIAL),
    "crps_ensemble": lambda m, t, w: m.crps_ensemble(t(TRUTH), t(ENS), w, SPATIAL),
    "crps_ensemble_pairs_of_two": lambda m, t, w: m.crps_ensemble(t(TRUTH), t(ENS[:2]), w,
                                                                  SPATIAL),
    "crps_ensemble_none": lambda m, t, w: m.crps_ensemble(t(TRUTH), t(ENS), reduction="none"),
    "gradient_lat": lambda m, t, w: m._gradient(t(PRED), 1),
    "gradient_two_rows": lambda m, t, w: m._gradient(t(PRED[:, :2]), 1),
    "gradient_magnitude": lambda m, t, w: m.gradient_magnitude(t(PRED), SPATIAL),
    "weighted_mean_gradient_magnitude":
        lambda m, t, w: m.weighted_mean_gradient_magnitude(t(PRED), w, SPATIAL),
    "gradient_magnitude_percent_diff":
        lambda m, t, w: m.gradient_magnitude_percent_diff(t(TRUTH), t(PRED), w, SPATIAL),
    "gradient_magnitude_percent_diff_ensemble":
        lambda m, t, w: m.gradient_magnitude_percent_diff(t(TRUTH), t(ENS), w, SPATIAL,
                                                          is_ensemble_prediction=True),
    "rmse_of_time_mean": lambda m, t, w: m.rmse_of_time_mean(t(TRUTH[..., 0]), t(PRED[..., 0]),
                                                             w[..., 0]),
    "time_and_global_mean_bias":
        lambda m, t, w: m.time_and_global_mean_bias(t(TRUTH[..., 0]), t(PRED[..., 0]), w[..., 0]),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metric_matches_jax(case):
    fn = METRIC_CASES[case]
    want = np.asarray(fn(JM, jnp.asarray, jnp.asarray(WEIGHTS)))
    got = fn(M, torch.from_numpy, torch.from_numpy(WEIGHTS)).numpy()
    assert got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want).max() <= METRIC_REL * _scale(case, want)


@pytest.mark.parametrize("shape", [(18, 36), (12, 24)])
def test_area_weights_match_jax(shape):
    lat = np.linspace(89.5, -89.5, shape[0])
    _assert_area_weights_close(M.spherical_area_weights(lat, shape[1]).numpy(),
                               JM.spherical_area_weights(lat, shape[1]))


# --------------------------------------------------------------- aggregator

@pytest.mark.parametrize("n_ensemble", [1, 3])
def test_aggregator_logs_match_jax(n_ensemble):
    """Two windows (4 and 3 steps) of random predictions and targets, with
    the normalizer's ``_normed`` tables, snapshots and zonal means: every log
    of ``get_logs`` and ``get_inference_logs`` (the same keys), the maps and
    the snapshots."""
    r = np.random.default_rng(n_ensemble)
    lat = np.linspace(80, -80, 8)
    snap = [2, 5]
    jagg = JAggregator(NAMES, JM.spherical_area_weights(lat, 12), snapshot_steps=snap,
                       normalizer=JNormalizer.from_dicts(MEANS, STDS, NAMES))
    tagg = InferenceAggregator(NAMES, M.spherical_area_weights(lat, 12), snapshot_steps=snap,
                               normalizer=StandardNormalizer.from_dicts(MEANS, STDS, NAMES))
    start = 0
    for T in (4, 3):
        tgt = r.standard_normal((T, 8, 12, N_STATE)).astype(np.float32) * 2 + 1
        preds = (tgt[None] + r.standard_normal((n_ensemble, T, 8, 12, N_STATE))).astype(
            np.float32)
        jagg.record_batch(jnp.asarray(preds), jnp.asarray(tgt), start_step=start)
        tagg.record_batch(torch.from_numpy(preds), torch.from_numpy(tgt), start_step=start)
        start += T
    _assert_logs_close(tagg.get_logs(), jagg.get_logs(), ROLLOUT_REL)
    got, want = tagg.get_inference_logs(), jagg.get_inference_logs()
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        _assert_logs_close(g, w, ROLLOUT_REL)
    for g, w in zip(tagg.zonal.get_maps(), jagg.zonal.get_maps()):
        assert _rel(g, w) <= ROLLOUT_REL
    for g, w in zip(tagg.time_mean.maps, jagg.time_mean.maps):
        assert _rel(g.numpy(), np.asarray(w)) <= ROLLOUT_REL
    assert set(tagg.snapshots.snapshots) == set(jagg.snapshots.snapshots) == set(snap)
    for s in snap:
        for k in ("preds", "targets"):
            np.testing.assert_array_equal(tagg.snapshots.snapshots[s][k],
                                          jagg.snapshots.snapshots[s][k])


def test_aggregator_reduces_bf16_preds_in_float32():
    """bf16 predictions are upcast before any reduction: the logs equal
    those of the same values handed over in float32."""
    r = np.random.default_rng(5)
    w = M.spherical_area_weights(np.linspace(80, -80, 8), 12)
    preds = torch.from_numpy(r.standard_normal((2, 3, 8, 12, N_STATE)).astype(np.float32))
    preds = preds.bfloat16()
    tgt = torch.from_numpy(r.standard_normal((3, 8, 12, N_STATE)).astype(np.float32))
    a, b = InferenceAggregator(NAMES, w), InferenceAggregator(NAMES, w)
    a.record_batch(preds, tgt)
    b.record_batch(preds.float(), tgt)
    assert a.get_logs() == b.get_logs()


# ----------------------------------------------------------- window reader

@pytest.mark.parametrize("case", ["repeats", "multi_ic"])
def test_inference_windows_match_jax(case):
    """The cases of tests/test_inference.py: wrap-around over three repeats
    of a 20-frame source (windows 16, 16, 13), and three initial conditions
    4 frames apart. Every window's start and arrays equal JAX's."""
    if case == "repeats":
        names, shape = ["x"], (4, 8)
        kw = dict(n_forward_steps=45, forward_steps_in_memory=16, n_repeats=3)
        n_t = 20
    else:
        names, shape = ["a", "b"], (8, 16)
        kw = dict(n_forward_steps=8, forward_steps_in_memory=8, n_ensemble=2,
                  n_initial_conditions=3, ic_interval=4)
        n_t = 40
    jwin = JInferenceWindows(JSynthetic(names, n_timesteps=n_t, spatial_shape=shape), names,
                             JInferenceConfig(**kw))
    twin = InferenceWindows(SyntheticTimeSeries(names, n_timesteps=n_t, spatial_shape=shape),
                            names, InferenceConfig(**kw))
    jw, tw = list(jwin), list(twin)
    assert [s for s, _ in tw] == [s for s, _ in jw]
    for (_, td), (_, jd) in zip(tw, jw):
        assert set(td) == set(jd)
        for n in names:
            np.testing.assert_array_equal(td[n], jd[n])
    assert list(twin.iter_ranges()) == list(jwin.iter_ranges())
    if case == "repeats":
        assert [s for s, _ in tw] == [0, 16, 32]
        np.testing.assert_array_equal(tw[0][1]["x"][-1], tw[1][1]["x"][0])
    else:
        assert tw[0][1]["a"].shape == (3, 9) + shape
    assert twin.start_indices == list(jwin.start_indices)


# ---------------------------------------------------------------- window cap

PAPER = (180, 360)
CAP_CASES = [
    # (forward_steps_in_memory, rows, preds itemsize, spatial, n_out, horizon, extra config)
    (96, 1, 4, PAPER, 35, 6, {}),
    (96, 4, 4, PAPER, 35, 6, {}),
    (96, 4, 2, PAPER, 35, 6, {}),
    (96, 64, 4, PAPER, 35, 6, {}),
    (96, 64, 4, PAPER, 35, 6, {"auto_window_cap": False}),
    (96, 8, 4, (8, 16), 2, 4, {}),
    (100, 2, 4, PAPER, 35, 6, {}),
]


@pytest.mark.parametrize("targets", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CAP_CASES)))
def test_capped_window_agrees_with_jax_where_targets_do_not_bind(case, targets):
    """The cases of tests/test_inference.py. Without an aggregator the port
    picks JAX's window. With one (one initial condition, no repeats: two
    target windows resident) it picks JAX's window wherever that window's
    targets fit beside its predictions, and else the largest horizon
    multiple below it that fits."""
    T, rows, itemsize, spatial, n_out, horizon, extra = CAP_CASES[case]
    kw = dict(n_forward_steps=14600, forward_steps_in_memory=T, **extra)
    want = jcapped_window(JInferenceConfig(**kw), rows, spatial, n_out, itemsize, horizon)
    if targets is None:
        got = capped_window(InferenceConfig(**kw), rows, spatial, n_out, itemsize, horizon)
        assert got == want
        return
    cfg = InferenceConfig(targets_dtype=targets, **kw)
    got = capped_window(cfg, rows, spatial, n_out, itemsize, horizon, target_rows=1,
                        n_timesteps=14600)
    tgt_itemsize = 4 if targets == "float32" else 2

    def resident(t):
        return t * spatial[0] * spatial[1] * n_out * (2.5 * rows * itemsize + 2 * tgt_itemsize)

    if not cfg.auto_window_cap or resident(want) <= cfg.hbm_budget_gb * 1e9 or want <= horizon:
        assert got == want
    else:
        assert horizon <= got < want and got % horizon == 0
        assert resident(got) <= cfg.hbm_budget_gb * 1e9 < resident(got + horizon)


def test_capped_window_counts_resident_targets():
    """Four initial conditions with bf16 predictions: JAX keeps window 96,
    whose float32 targets (two windows in flight, 7.0 GB beside 4.4 GB of
    predictions) overrun the budget; the port caps it to 36, or to 54 with
    bf16 targets. With an aligned, repeating source one cached target
    window fits at 96."""
    cfg = InferenceConfig(n_forward_steps=14600, forward_steps_in_memory=96)
    args = (4, PAPER, 35, 2, 6)
    assert jcapped_window(JInferenceConfig(n_forward_steps=14600, forward_steps_in_memory=96),
                          *args) == 96
    assert capped_window(cfg, *args, target_rows=4, n_timesteps=14600) == 36
    bf16 = dataclasses.replace(cfg, targets_dtype="bfloat16")
    assert capped_window(bf16, *args, target_rows=4, n_timesteps=14600) == 54
    aligned = dataclasses.replace(cfg, n_forward_steps=288, n_repeats=5)
    assert capped_window(aligned, 1, PAPER, 35, 2, 6, target_rows=1, n_timesteps=96) == 96


def test_capped_window_counts_the_host_copy():
    """With a writer or the video on (``to_host``) the estimate holds one
    more window of predictions, the channel-first copy made on the card for
    the host: four rows of bf16 predictions keep window 96 without it
    (2.5 windows: 4.35 GB of 4.5) and are capped to 66 with it (3.5 windows:
    4.19 GB; 72 would take 4.57). The product rollout with its writer (one
    row of float32 predictions, one cached target window) keeps 96."""
    cfg = InferenceConfig(n_forward_steps=14600, forward_steps_in_memory=96)
    args = (4, PAPER, 35, 2, 6)
    assert capped_window(cfg, *args) == 96
    assert capped_window(cfg, *args, to_host=True) == 66
    aligned = dataclasses.replace(cfg, n_forward_steps=288, n_repeats=5)
    assert capped_window(aligned, 1, PAPER, 35, 4, 6, target_rows=1, n_timesteps=96,
                         to_host=True) == 96


def test_targets_dtype_is_checked_when_the_config_is_made():
    with pytest.raises(ValueError, match="targets_dtype"):
        InferenceConfig(targets_dtype="float16")
    assert InferenceConfig(targets_dtype="bfloat16").targets_dtype == "bfloat16"


# ------------------------------------------------------- copies of JAX code

@pytest.mark.parametrize("source", ["synthetic", "stochastic"])
def test_source_copies_are_pinned_to_the_originals(source):
    if source == "synthetic":
        kw = dict(n_timesteps=30, spatial_shape=(12, 24), seed=3)
        want, got = JSynthetic(["a", "b", "c"], **kw), SyntheticTimeSeries(["a", "b", "c"], **kw)
        np.testing.assert_array_equal(got.sigma.ak, want.sigma.ak)
        np.testing.assert_array_equal(got.sigma.bk, want.sigma.bk)
    else:
        kw = dict(n_timesteps=40, spatial_shape=(16, 32), seed=1, noise_seed=7, n_modes=5)
        want = JStochastic(["a", "b", "c"], **kw)
        got = StochasticModalTimeSeries(["a", "b", "c"], **kw)
    for start, length, names in ((0, 5, ["a"]), (7, 11, ["c", "a"]), (25, 5, ["b"])):
        g, w = got.read_window(start, length, names), want.read_window(start, length, names)
        assert list(g) == list(w)
        for n in names:
            assert g[n].dtype == w[n].dtype == np.float32
            np.testing.assert_array_equal(g[n], w[n])
    assert got.n_timesteps == want.n_timesteps and got.spatial_shape == want.spatial_shape
    np.testing.assert_array_equal(got.horizontal.lat, want.horizontal.lat)
    np.testing.assert_array_equal(got.horizontal.lon, want.horizontal.lon)
    assert got.horizontal.shape == want.horizontal.shape
    _assert_area_weights_close(got.horizontal.area_weights().numpy(),
                               want.horizontal.area_weights())


def test_prefetched_copy_is_pinned_to_the_original():
    for depth in (0, 1, 2):
        assert list(prefetched(iter(range(7)), depth)) == list(jprefetched(iter(range(7)), depth))

    def failing():
        yield 1
        raise KeyError("source")

    for fn in (prefetched, jprefetched):
        it = fn(failing(), 2)
        assert next(it) == 1
        with pytest.raises(KeyError, match="source"):
            next(it)


def test_normalizer_subset_matches_jax():
    sel = [NAMES[2], NAMES[0]]
    got = StandardNormalizer.from_dicts(MEANS, STDS, NAMES).subset(sel)
    want = JNormalizer.from_dicts(MEANS, STDS, NAMES).subset(sel)
    assert got.names == want.names
    np.testing.assert_array_equal(got.means.numpy(), np.asarray(want.means))
    np.testing.assert_array_equal(got.stds.numpy(), np.asarray(want.stds))


# ----------------------------------------------------------- the rollouts

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def models():
    """The JAX experiment at debug size, its weights and a second forecaster
    tree (the EMA weights)."""
    icfg, fcfg = main_path.sfno_configs(16, 2, "float32", GRID, HORIZON, N_STATE,
                                        use_pallas=False, fused_mlp=False)
    imodel, fmodel = JSFNO(JSFNOConfig(**_fields(icfg))), JSFNO(JSFNOConfig(**_fields(fcfg)))
    x = jnp.zeros((1,) + GRID + (N_STATE,))
    cond = jnp.zeros((1,) + GRID + (len(FORCING),))
    ip = jax.jit(lambda k: imodel.init(k, jnp.concatenate([x, x], -1), time=jnp.ones((1,)),
                                       static_condition=cond))(jax.random.PRNGKey(0))
    finit = jax.jit(lambda k: fmodel.init(k, x, time=jnp.zeros((1,)), static_condition=cond))
    fp, ema = finit(jax.random.PRNGKey(1)), finit(jax.random.PRNGKey(2))
    packer = JPacker(NAMES)
    norm = JNormalizer.from_dicts(MEANS, STDS, NAMES)
    interp = JInterpolation(imodel, JExperimentConfig(horizon=HORIZON,
                                                      enable_inference_dropout=True),
                            packer, packer, norm)
    dcfg = JDYffusionConfig(timesteps=HORIZON, forward_conditioning="none",
                            time_encoding="dynamics", enable_interpolator_dropout=False)
    exp = JForecasting(fmodel, interp, ip, dcfg, JExperimentConfig(horizon=HORIZON), packer,
                       packer, norm, forcing_names=FORCING,
                       forcing_normalizer=JNormalizer.from_dicts(F_MEANS, F_STDS, FORCING))
    return dict(exp=exp, interpolator=ip, forecaster=fp, ema=ema, steppers={})


def _jax_stepper(models, **opts):
    """One JAX stepper per option set, kept across tests (each compiles its
    window programs)."""
    key = tuple(sorted(opts.items()))
    if key not in models["steppers"]:
        kw = dict(opts)
        if kw.pop("ema", False):
            kw.update(use_ema_params=True, ema_params=models["ema"])
        prescriber = JPrescriberConfig("surface_temperature", MASK, 1).build(NAMES)
        models["steppers"][key] = JStepper(models["exp"], models["forecaster"],
                                           prescriber=prescriber, **kw)
    return models["steppers"][key]


def _port_stepper(models, dropout=False, ema=False, **opts):
    st = main_path.build(embed=16, layers=2, dtype="float32", img_shape=GRID, n_state=N_STATE,
                         horizon=HORIZON, device="cpu",
                         flax_params={"interpolator": models["interpolator"],
                                      "forecaster": models["forecaster"]},
                         enable_interpolator_dropout=dropout,
                         ema_params=models["ema"] if ema else None, **opts)
    st.exp.normalizer = StandardNormalizer.from_dicts(MEANS, STDS, NAMES)
    st.exp.forcing_normalizer = StandardNormalizer.from_dicts(F_MEANS, F_STDS, FORCING)
    return st


def _recorded(stepper):
    """Record the states that ``run_window`` hands back, in call order."""
    states = []
    run = stepper.run_window

    def record(*args, **kwargs):
        out = run(*args, **kwargs)
        states.append(np.asarray(out[0]))
        return out

    stepper.run_window = record
    return states


def _source(n_timesteps, cls=SyntheticTimeSeries):
    return cls(NAMES + FORCING + [MASK], n_timesteps=n_timesteps, spatial_shape=GRID)


def _rollout(stepper, cfg, n_timesteps, jax_side, **agg_kw):
    """(summary, logs, final state) of one run_inference of ``stepper``."""
    states = _recorded(stepper)
    if jax_side:
        src = _source(n_timesteps, JSynthetic)
        agg = JAggregator(NAMES, src.horizontal.area_weights(), **agg_kw)
        summary = jrun_inference(stepper, src, JInferenceConfig(**cfg), aggregator=agg,
                                 mask_name=MASK, verbose=False)
    else:
        src = _source(n_timesteps)
        agg = InferenceAggregator(NAMES, src.horizontal.area_weights(), **agg_kw)
        summary = run_inference(stepper, src, InferenceConfig(**cfg), aggregator=agg,
                                mask_name=MASK, verbose=False)
    rows = cfg.get("n_initial_conditions", 1) * cfg.get("n_ensemble", 1)
    n_chunks = -(-rows // (cfg.get("ensemble_in_memory") or rows))
    return summary, agg.get_logs(), np.concatenate(states[-n_chunks:])


ROLLOUTS = {
    # two full windows and a partial one, the source looped (9 frames of 6)
    "windows": (dict(n_forward_steps=8, forward_steps_in_memory=3, n_repeats=2), 6),
    # an aligned source looped 4 times: every window after the first from
    # the read and upload caches
    "repeats": (dict(n_forward_steps=9, forward_steps_in_memory=3, n_repeats=4), 3),
    # ensemble 2 in chunks of one member, two initial conditions 2 apart
    "ensemble": (dict(n_forward_steps=6, forward_steps_in_memory=3, n_ensemble=2,
                      ensemble_in_memory=1, n_initial_conditions=2, ic_interval=2), 12),
}


def _compare(models, cfg, n_timesteps, opts=None, normed=False):
    """run_inference on both sides with the same options; returns the
    port's logs."""
    opts = opts or {}
    jkw, tkw = {}, {}
    if normed:
        jkw["normalizer"] = JNormalizer.from_dicts(MEANS, STDS, NAMES)
        tkw["normalizer"] = StandardNormalizer.from_dicts(MEANS, STDS, NAMES)
    jsum, jlogs, jx = _rollout(_jax_stepper(models, **opts), cfg, n_timesteps, True, **jkw)
    tsum, tlogs, tx = _rollout(_port_stepper(models, **opts), cfg, n_timesteps, False, **tkw)
    assert set(tsum) == set(jsum)
    assert tsum["n_forward_steps"] == jsum["n_forward_steps"] == cfg["n_forward_steps"]
    assert tsum["upload_cache_skips"] == jsum["upload_cache_skips"] == 0
    assert tx.shape == jx.shape
    assert _rel(tx, jx) <= ROLLOUT_REL
    _assert_logs_close(tlogs, jlogs, ROLLOUT_REL)
    return tlogs


@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_run_inference_matches_jax(models, case):
    """The prescriber on (SST from the source where its mask rounds to 1),
    forcings through the forcing normalizer, a normalizer that is not the
    identity; the aggregator with ``_normed`` tables and zonal means."""
    cfg, n_t = ROLLOUTS[case]
    logs = _compare(models, cfg, n_t, normed=True)
    assert any(k.endswith("_normed/v0") for k in logs)
    if cfg.get("n_ensemble", 1) > 1:
        assert "inference/avg/crps" in logs and "inference/avg/ssr" in logs


def test_use_ema_params_matches_jax(models):
    """The forecaster's EMA tree, as JAX selects it; without one the port
    raises, as JAX does."""
    _compare(models, *ROLLOUTS["windows"], opts=dict(ema=True))
    with pytest.raises(ValueError, match="ema_params"):
        DYffusionStepper(_port_stepper(models).exp, use_ema_params=True)


def test_targets_dtype_bf16_matches_jax(models):
    """bf16 target windows: rounded on the host by torch where JAX rounds
    with ml_dtypes (both to nearest even), reduced in float32."""
    cfg, n_t = ROLLOUTS["windows"]
    tlogs = _compare(models, dict(cfg, targets_dtype="bfloat16"), n_t)
    _, f32_logs, _ = _rollout(_port_stepper(models), cfg, n_t, False)
    assert tlogs != f32_logs
    assert tlogs["inference/avg/rmse"] == pytest.approx(f32_logs["inference/avg/rmse"], rel=0.02)


def test_params_and_preds_dtype_bf16_match_jax(models):
    """``params_dtype="bfloat16"``: every floating weight and transform
    matrix of both networks holds a bf16 value (in float32); the rollout
    agrees with JAX's bf16 weights. ``preds_dtype="bfloat16"``: the emitted
    copy only, the hand-off state unchanged."""
    cfg, n_t = ROLLOUTS["windows"]
    opts = dict(params_dtype="bfloat16", preds_dtype="bfloat16")
    _compare(models, cfg, n_t, opts=opts)
    st = _port_stepper(models, params_dtype="bfloat16")
    for net in (st.exp.model, st.exp.interpolator.model):
        for t in (*net.parameters(), *net.buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32
                torch.testing.assert_close(t, t.bfloat16().float(), rtol=0, atol=0)
    inp = main_path.window_inputs(4, GRID, N_STATE, seed=3, device="cpu")
    args = (inp["x0"], inp["forcing"], inp["sst"], inp["mask"])
    x32, p32 = _port_stepper(models).run_window(*args, torch.Generator().manual_seed(0), 4)
    x16, p16 = _port_stepper(models, preds_dtype="bfloat16").run_window(
        *args, torch.Generator().manual_seed(0), 4)
    assert p16.dtype == torch.bfloat16 and x16.dtype == torch.float32
    torch.testing.assert_close(x16, x32, rtol=0, atol=0)
    torch.testing.assert_close(p16, p32.bfloat16(), rtol=0, atol=0)


def test_run_inference_is_seeded_and_members_diverge(models):
    """Interpolator dropout live, ensemble 2: the same seed repeats the
    rollout bit for bit, another seed changes it, and the members spread
    (SSR above 0)."""
    cfg = dict(ROLLOUTS["windows"][0], n_ensemble=2)
    st = _port_stepper(models, dropout=True)
    a = _rollout(st, dict(cfg, seed=0), 6, False)
    b = _rollout(st, dict(cfg, seed=0), 6, False)
    c = _rollout(st, dict(cfg, seed=1), 6, False)
    np.testing.assert_array_equal(a[2], b[2])
    assert a[1] == b[1]
    assert not np.array_equal(a[2], c[2])
    assert not np.array_equal(a[2][0], a[2][1])
    assert all(a[1][f"inference/ssr/{n}"] > 0 for n in NAMES if n != "surface_temperature")


class _LinearWorld:
    """x(t + 1) = x(t) + v exactly, the linear world of the JAX package's
    tests, as a port experiment: a perturbation of the initial state reaches
    the final state unchanged."""

    def __init__(self, v: torch.Tensor, inputs_noise: float):
        self.cfg = ExperimentConfig(horizon=HORIZON, prediction_inputs_noise=inputs_noise)
        self.in_packer = self.out_packer = Packer(NAMES)
        self.normalizer = StandardNormalizer.from_dicts(MEANS, STDS, NAMES)
        self.forcing_names, self.forcing_normalizer = (), None
        self.model = torch.nn.Linear(1, 1)  # where run_inference finds the device
        self.v = v

    def predict(self, x, generator=None, static_condition=None):
        preds = {h: x + h * self.v for h in range(1, HORIZON + 1)}
        return Intermediates(preds=preds, x_last=preds[HORIZON])


@pytest.mark.parametrize("n_forward_steps", [3, 9])
def test_inputs_noise_perturbs_the_first_window_only(n_forward_steps):
    """Inputs noise 0.3 in the linear world: the final state less the
    noiseless line is one draw of the noise, whatever the number of windows
    (std 0.3 within 10% over 2,048 values; a second draw would give 0.42),
    seeded by ``cfg.seed``."""
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(GRID + (N_STATE,)) * 0.01)
    st = DYffusionStepper(_LinearWorld(v.float(), 0.3))

    def final(seed, noise=True):
        st.inputs_noise = 0.3 if noise else 0.0
        states = _recorded(st)
        run_inference(st, _source(12), InferenceConfig(n_forward_steps=n_forward_steps,
                                                       forward_steps_in_memory=3, seed=seed),
                      verbose=False)
        return states[-1]

    clean = final(0, noise=False)
    noise = final(0) - clean
    assert abs(noise.std() - 0.3) <= 0.03
    assert abs(noise.mean()) <= 0.03
    np.testing.assert_array_equal(final(0), final(0))
    assert not np.array_equal(final(0), final(1))
