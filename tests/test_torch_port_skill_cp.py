"""The trained CP weights through the port, against the JAX package, on the CPU.

``results/skill_cp`` (CP, no truncation) and ``results/skill_fast`` (CP,
truncation 0.9) hold the interpolator and forecaster that
``scripts/skill_proof.py`` trained on ``StochasticModalTimeSeries`` (64 x
128, 2 channels, embed 64 x 4 layers, horizon 6, float32,
``forward_conditioning="data"``). Both hold CP factors of rank 16 of 64
(``rank=0.25``, on the rank pipeline; the ``skill_cp`` README names rank
1.0, but its weights are rank 16). The port reads the files with its flax
msgpack reader (``utils/flax_msgpack.py``, the reader of
``interface.load_experiment_checkpoint``), the JAX package with flax; both
run ``run_inference`` for 12 steps with the interpolator's dropout off over
the validation split of ``StochasticDataModule``, with the normalizer that
datamodule builds, and the ``InferenceAggregator`` on. Every log agrees
within 1e-4, as ``tests/test_torch_port_skill.py`` holds ``skill_final``.
The weight files are kept out of copies of the tree filtered by
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
from spherical_dyffusion_tpu_torch.utils import flax_msgpack
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
HORIZON, C, SHAPE = 6, 2, (64, 128)
LOG_REL = 1e-4
STUDIES = {"skill_cp": dict(factorization="cp", rank=0.25),
           "skill_fast": dict(factorization="cp", rank=0.25, hard_thresholding_fraction=0.9)}


def _sfno_kwargs(study: str, interpolator: bool):
    return dict(img_shape=SHAPE, in_chans=2 * C, out_chans=C, embed_dim=64, num_layers=4,
                with_time_emb=True, min_time=1 if interpolator else 0, max_time=HORIZON - 1,
                **STUDIES[study], **({"dropout_mlp": 0.15} if interpolator else {}))


@pytest.fixture(scope="module")
def dm():
    return StochasticDataModule(channels=C, height=SHAPE[0], width=SHAPE[1], horizon=HORIZON,
                                n_timesteps=8192, n_val_timesteps=512)


def _files(study):
    files = {k: REPO / "results" / study / f"{k}.msgpack"
             for k in ("interpolator", "forecaster")}
    missing = [str(p.relative_to(REPO)) for p in files.values() if not p.exists()]
    if missing:
        pytest.skip(f"{', '.join(missing)} not in this checkout (kept out of copies filtered "
                    "by .gitignore)")
    return files


def _jax_logs(study, dm, files):
    p = {k: serialization.msgpack_restore(f.read_bytes()) for k, f in files.items()}
    interp = JInterpolation(JSFNO(JSFNOConfig(**_sfno_kwargs(study, True))),
                            JExperimentConfig(horizon=HORIZON, enable_inference_dropout=True),
                            dm.in_packer, dm.out_packer, dm.normalizer)
    exp = JForecasting(JSFNO(JSFNOConfig(**_sfno_kwargs(study, False))), interp,
                       p["interpolator"], JDYffusionConfig(
                           timesteps=HORIZON, forward_conditioning="data",
                           enable_interpolator_dropout=False),
                       JExperimentConfig(horizon=HORIZON), dm.in_packer, dm.out_packer,
                       dm.normalizer)
    src = dm._val_src
    agg = JAggregator(list(dm.cfg.in_names), src.horizontal.area_weights())
    jrun_inference(JStepper(exp, p["forecaster"]), src,
                   JInferenceConfig(n_forward_steps=12, forward_steps_in_memory=12),
                   aggregator=agg, verbose=False)
    return agg.get_logs()


def _port_logs(study, dm, files):
    names = list(dm.cfg.in_names)
    packer = Packer(names)
    norm = StandardNormalizer(means=torch.tensor(np.asarray(dm.normalizer.means)),
                              stds=torch.tensor(np.asarray(dm.normalizer.stds)),
                              names=tuple(names))
    nets = {}
    for k, interpolator in (("interpolator", True), ("forecaster", False)):
        nets[k] = SFNO(SFNOConfig(**_sfno_kwargs(study, interpolator)))
        nets[k].load_state_dict(flax_to_state_dict(flax_msgpack.read(str(files[k]))),
                                strict=True)
    interp = InterpolationExperiment(nets["interpolator"], ExperimentConfig(
        horizon=HORIZON, enable_inference_dropout=True), packer, packer, norm)
    exp = DYffusionForecastingExperiment(
        nets["forecaster"], interp, DYffusionConfig(timesteps=HORIZON,
                                                    forward_conditioning="data",
                                                    enable_interpolator_dropout=False),
        ExperimentConfig(horizon=HORIZON), packer, packer, norm)
    src = StochasticModalTimeSeries(names, n_timesteps=512, spatial_shape=SHAPE, noise_seed=2)
    agg = InferenceAggregator(names, src.horizontal.area_weights())
    run_inference(DYffusionStepper(exp), src,
                  InferenceConfig(n_forward_steps=12, forward_steps_in_memory=12),
                  aggregator=agg, verbose=False)
    return agg.get_logs()


@pytest.mark.parametrize("study", sorted(STUDIES))
def test_trained_cp_rollout_matches_jax_with_dropout_off(study, dm):
    """Every log within 1e-4 (of the value, or of 1 where smaller; a
    percent difference, of 100)."""
    files = _files(study)
    want = _jax_logs(study, dm, files)
    got = _port_logs(study, dm, files)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(abs(float(w)), 100.0 if "percent_diff" in k else 1.0)
        assert abs(got[k] - float(w)) <= LOG_REL * scale, (k, got[k], w)
