"""The port's rollout with trained weights, against the JAX package, on the CPU.

``results/skill_final`` holds the interpolator and forecaster that
``scripts/skill_proof.py`` trained on ``StochasticModalTimeSeries`` (64 x
128, 2 channels, embed 64 x 4 layers, horizon 6, float32, dense dhconv,
``forward_conditioning="data"``, interpolator MLP dropout 0.35; the config
of ``scripts/skill_proof.py:175-185`` and ``:264-272`` with its saved
dropout). Both packages load them (the port through ``utils/convert.py``)
and run ``run_inference`` (12 steps with dropout off; one 6-step window at
ensemble 4 with the dropout live) over the validation split of
``StochasticDataModule``, with the normalizer that datamodule builds (made by
the JAX package, handed to the port as numpy), and the ``InferenceAggregator``
on. The weight files are kept out of copies of the tree filtered by
``.gitignore``; without them the tests skip.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

from spherical_dyffusion_tpu.data import StochasticDataModule
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.evaluation.aggregators import InferenceAggregator as JAggregator
from spherical_dyffusion_tpu.inference.loop import InferenceConfig as JInferenceConfig
from spherical_dyffusion_tpu.inference.loop import run_inference as jrun_inference
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
from spherical_dyffusion_tpu_torch.data.datasets import StochasticModalTimeSeries
from spherical_dyffusion_tpu_torch.data.normalization import StandardNormalizer
from spherical_dyffusion_tpu_torch.data.packer import Packer
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SKILL_FINAL = REPO / "results" / "skill_final"
HORIZON, C, SHAPE = 6, 2, (64, 128)
# float32 on both sides over 24 SFNO forwards of trained 64 x 4 networks
LOG_REL = 1e-4


def _sfno_kwargs(interpolator: bool):
    return dict(img_shape=SHAPE, in_chans=2 * C, out_chans=C, embed_dim=64, num_layers=4,
                with_time_emb=True, min_time=1 if interpolator else 0, max_time=HORIZON - 1,
                **({"dropout_mlp": 0.35} if interpolator else {}))


@pytest.fixture(scope="module")
def trained():
    files = {k: SKILL_FINAL / f"{k}.msgpack" for k in ("interpolator", "forecaster")}
    missing = [str(p.relative_to(REPO)) for p in files.values() if not p.exists()]
    if missing:
        pytest.skip(f"{', '.join(missing)} not in this checkout (kept out of copies filtered "
                    "by .gitignore)")
    params = {k: serialization.msgpack_restore(p.read_bytes()) for k, p in files.items()}
    dm = StochasticDataModule(channels=C, height=SHAPE[0], width=SHAPE[1], horizon=HORIZON,
                              n_timesteps=8192, n_val_timesteps=512)
    return dict(params=params, dm=dm, steppers={})


def _jax_stepper(trained, dropout: bool):
    if dropout not in trained["steppers"]:
        dm, p = trained["dm"], trained["params"]
        interp = JInterpolation(JSFNO(JSFNOConfig(**_sfno_kwargs(True))),
                                JExperimentConfig(horizon=HORIZON, enable_inference_dropout=True),
                                dm.in_packer, dm.out_packer, dm.normalizer)
        dcfg = JDYffusionConfig(timesteps=HORIZON, forward_conditioning="data",
                                enable_interpolator_dropout=dropout)
        exp = JForecasting(JSFNO(JSFNOConfig(**_sfno_kwargs(False))), interp, p["interpolator"],
                           dcfg, JExperimentConfig(horizon=HORIZON), dm.in_packer,
                           dm.out_packer, dm.normalizer)
        trained["steppers"][dropout] = JStepper(exp, p["forecaster"])
    return trained["steppers"][dropout]


def _port_stepper(trained, dropout: bool):
    dm, p = trained["dm"], trained["params"]
    names = list(dm.cfg.in_names)
    packer = Packer(names)
    norm = StandardNormalizer(means=torch.tensor(np.asarray(dm.normalizer.means)),
                              stds=torch.tensor(np.asarray(dm.normalizer.stds)),
                              names=tuple(names))
    imodel, fmodel = SFNO(SFNOConfig(**_sfno_kwargs(True))), SFNO(SFNOConfig(**_sfno_kwargs(False)))
    imodel.load_state_dict(flax_to_state_dict(p["interpolator"]))
    fmodel.load_state_dict(flax_to_state_dict(p["forecaster"]))
    imodel.eval()
    fmodel.eval()
    interp = InterpolationExperiment(imodel, ExperimentConfig(horizon=HORIZON,
                                                              enable_inference_dropout=True),
                                     packer, packer, norm)
    dcfg = DYffusionConfig(timesteps=HORIZON, forward_conditioning="data",
                           enable_interpolator_dropout=dropout)
    exp = DYffusionForecastingExperiment(fmodel, interp, dcfg, ExperimentConfig(horizon=HORIZON),
                                         packer, packer, norm)
    return DYffusionStepper(exp)


def _logs(trained, jax_side: bool, n_ensemble: int, seed: int, stepper, n_steps: int = 12):
    """The aggregator's logs of an ``n_steps`` run_inference in one window
    on the validation source (seeded as the datamodule seeds it)."""
    dm = trained["dm"]
    names = list(dm.cfg.in_names)
    cfg = dict(n_forward_steps=n_steps, forward_steps_in_memory=n_steps, n_ensemble=n_ensemble,
               seed=seed)
    if jax_side:
        src = dm._val_src
        agg = JAggregator(names, src.horizontal.area_weights())
        jrun_inference(stepper, src, JInferenceConfig(**cfg), aggregator=agg, verbose=False)
    else:
        src = StochasticModalTimeSeries(names, n_timesteps=512, spatial_shape=SHAPE,
                                        noise_seed=2)
        agg = InferenceAggregator(names, src.horizontal.area_weights())
        run_inference(stepper, src, InferenceConfig(**cfg), aggregator=agg, verbose=False)
    return agg.get_logs()


def test_trained_rollout_matches_jax_with_dropout_off(trained):
    """Every log of the aggregator within 1e-4 (relative to the value, or to
    1 where smaller; a percent difference to 100)."""
    want = _logs(trained, True, 1, 0, _jax_stepper(trained, dropout=False))
    got = _logs(trained, False, 1, 0, _port_stepper(trained, dropout=False))
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(abs(float(w)), 100.0 if "percent_diff" in k else 1.0)
        assert abs(got[k] - float(w)) <= LOG_REL * scale, (k, got[k], w)


# The interpolator's dropout live at ensemble 4, over one 6-step segment:
# the two packages draw their masks from different generators, so the
# ensembles differ member by member and only their statistics compare. Over
# seeds 0-5 of this rollout the JAX package's seed-to-seed standard
# deviations were 0.0010 (RMSE of the ensemble mean, mean 0.6841), 0.00085
# (CRPS, 0.5391) and 0.00047 (SSR, 0.0486); the port's seeds 0-3 spread
# alike (0.00092, 0.00085, 0.00035). The mean of two seeds a side differs
# from the other side's by chance with a standard deviation about that
# large; each tolerance is four of them. With dropout off the SSR would be 0.
ENSEMBLE_STEPS = 6
ENSEMBLE_TOL = {"inference/avg/rmse": 0.0040, "inference/avg/crps": 0.0034,
                "inference/avg/ssr": 0.0019}


def test_trained_ensemble_statistics_match_jax(trained):
    js, ps = _jax_stepper(trained, dropout=True), _port_stepper(trained, dropout=True)
    seeds = (0, 1)
    want = [_logs(trained, True, 4, s, js, ENSEMBLE_STEPS) for s in seeds]
    got = [_logs(trained, False, 4, s, ps, ENSEMBLE_STEPS) for s in seeds]
    for k, tol in ENSEMBLE_TOL.items():
        w, g = np.mean([x[k] for x in want]), np.mean([x[k] for x in got])
        assert abs(g - w) <= tol, (k, g, w)
    assert all(x["inference/avg/ssr"] > 0.02 for x in got)
