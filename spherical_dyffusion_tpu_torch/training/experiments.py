"""Experiment types, inference half, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/training/experiments.py`` for what
the rollout needs: ``ExperimentConfig``, ``InterpolationExperiment.predict``
and ``make_interpolate_fn``, and ``DYffusionForecastingExperiment`` with its
interpolate/forecast callables and ``predict``. The JAX package's
experiments are stateless over explicit parameter trees; here the networks
are ``nn.Module``s that carry their weights, so the parameter arguments
disappear. Training losses come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..data.normalization import StandardNormalizer
from ..data.packer import Packer
from ..diffusion.dyffusion import DYffusionConfig, build_schedule, select_sampler

__all__ = ["ExperimentConfig", "InterpolationExperiment",
           "DYffusionForecastingExperiment"]


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Shared experiment hyperparameters (the JAX package's names)."""

    horizon: int
    window: int = 1
    loss_function: str = "l1"
    num_predictions: int = 10
    enable_inference_dropout: bool = False
    stack_window_to_channel_dim: bool = True
    prediction_inputs_noise: float = 0.0


class InterpolationExperiment:
    """Stochastic time interpolation; dropout stays live at inference when
    ``enable_inference_dropout`` (the DYffusion spread source)."""

    def __init__(self, model, cfg: ExperimentConfig, in_packer: Packer,
                 out_packer: Packer, normalizer: StandardNormalizer):
        if cfg.horizon < 2:
            raise ValueError("horizon must be >= 2 for interpolation")
        self.model = model
        self.cfg = cfg
        self.in_packer = in_packer
        self.out_packer = out_packer
        self.normalizer = normalizer

    def predict(self, inputs: torch.Tensor, time: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                condition: Optional[torch.Tensor] = None,
                static_condition: Optional[torch.Tensor] = None,
                use_inference_dropout: Optional[bool] = None) -> torch.Tensor:
        use_do = (self.cfg.enable_inference_dropout if use_inference_dropout is None
                  else use_inference_dropout)
        if use_do and generator is None:
            raise ValueError("inference dropout requires a generator")
        return self.model(inputs, time=time, condition=condition,
                          static_condition=static_condition,
                          deterministic=not use_do, generator=generator)

    def make_interpolate_fn(self, hack_for_imprecise_interpolation: bool = False,
                            use_inference_dropout: bool = True):
        """The ``interpolate_fn`` of the DYffusion sampler: takes x_last in
        forecaster channels and returns state channels."""

        def interpolate_fn(x_end, x_last, t, generator, dynamical_condition=None,
                           static_condition=None, **_):
            if hack_for_imprecise_interpolation:
                x_last = torch.cat([x_end[..., :1], x_last], dim=-1)
            inputs = torch.cat([x_end, x_last], dim=-1)
            cond = None
            if dynamical_condition is not None:
                idx = torch.floor(t).long()
                cond = dynamical_condition[torch.arange(t.shape[0], device=t.device), idx]
            out = self.predict(inputs, time=t, generator=generator, condition=cond,
                               static_condition=static_condition,
                               use_inference_dropout=use_inference_dropout)
            if hack_for_imprecise_interpolation:
                out = torch.cat([x_end[..., :1], out], dim=-1)
            return out

        return interpolate_fn


class DYffusionForecastingExperiment:
    """Two-stage DYffusion forecasting: a frozen stochastic interpolator and
    a forecaster, sampled with the cold sampler."""

    def __init__(self, forecaster_model, interpolator: InterpolationExperiment,
                 diffusion_cfg: DYffusionConfig, cfg: ExperimentConfig,
                 in_packer: Packer, out_packer: Packer,
                 normalizer: StandardNormalizer, forcing_names: Sequence[str] = (),
                 forcing_normalizer: Optional[StandardNormalizer] = None):
        if diffusion_cfg.timesteps != cfg.horizon:
            raise ValueError("diffusion timesteps must equal horizon "
                             f"({diffusion_cfg.timesteps} != {cfg.horizon})")
        if diffusion_cfg.interpolator_use_ema:
            raise NotImplementedError("interpolator EMA weights are not ported")
        self.model = forecaster_model
        self.interpolator = interpolator
        self.diffusion_cfg = diffusion_cfg
        self.sched = build_schedule(diffusion_cfg)
        self.cfg = cfg
        self.in_packer = in_packer
        self.out_packer = out_packer
        self.normalizer = normalizer
        self.forcing_names = tuple(forcing_names)
        self.forcing_normalizer = forcing_normalizer

    def _interp_fn(self):
        return self.interpolator.make_interpolate_fn(
            hack_for_imprecise_interpolation=self.diffusion_cfg.hack_for_imprecise_interpolation,
            use_inference_dropout=bool(self.diffusion_cfg.enable_interpolator_dropout))

    def _forecast_fn(self):
        def forecast_fn(x_t, time, condition, static_condition=None):
            return self.model(x_t, time=time.float(), condition=condition,
                              static_condition=static_condition, deterministic=True)

        return forecast_fn

    def predict(self, initial_condition: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamical_condition: Optional[torch.Tensor] = None,
                static_condition: Optional[torch.Tensor] = None):
        """One cold-sampling pass; returns ``Intermediates``. Runs the
        double-batch scan sampler when the config is ``scan_compatible``
        (peeled with ``peel_sampler``), else ``sample_loop``, as the JAX
        package does."""
        cond_kwargs = {}
        if dynamical_condition is not None:
            cond_kwargs["dynamical_condition"] = dynamical_condition
        if static_condition is not None:
            cond_kwargs["static_condition"] = static_condition
        sampler = select_sampler(self.diffusion_cfg, self.sched)
        return sampler(self._interp_fn(), self._forecast_fn(), self.diffusion_cfg,
                       self.sched, initial_condition, generator, **cond_kwargs)
