"""Experiment types, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/training/experiments.py``:
``ExperimentConfig``, ``InterpolationExperiment`` (``train_loss``,
``predict``, ``make_interpolate_fn``) and ``DYffusionForecastingExperiment``
(``train_loss`` through ``p_losses``, its interpolate/forecast callables and
``predict``). The JAX package's experiments are stateless over explicit
parameter trees; here the networks are ``nn.Module``s that carry their
weights, so the parameter arguments disappear: the frozen interpolator of
the forecaster's loss runs under ``torch.no_grad()``, which is the same math
as JAX passing its tree as ``aux_params``. Randomness (timesteps, dropout)
comes from one host ``torch.Generator``; the timesteps are drawn on the
batch's device (``models/modules.py:device_generator``).
``SimultaneousForecastingExperiment`` is the ACE-style baseline: ``horizon_at_once``
steps in one forward, trained autoregressively with its predictions fed back
detached; each autoregressive step's dropout draws come from a host
generator seeded by mixing one draw from the step's generator with the step
index (``fold_in``), the counterpart of JAX's ``fold_in(rng, step)``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.normalization import StandardNormalizer
from ..data.packer import Packer
from ..diffusion.dyffusion import DYffusionConfig, build_schedule, p_losses, select_sampler
from ..models.modules import device_generator, draw_seed
from ..utils.device import to_device
from .losses import get_loss_fn

__all__ = ["ExperimentConfig", "InterpolationExperiment",
           "DYffusionForecastingExperiment", "SimultaneousForecastingExperiment",
           "stack_window", "fold_in"]


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


def stack_window(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T*C)."""
    B, T, H, W, C = x.shape
    return torch.movedim(x, 1, -2).reshape(B, H, W, T * C)


def fold_in(seed: int, step: int) -> torch.Generator:
    """A host generator for ``step``, seeded by mixing ``seed`` and ``step``
    through numpy's ``SeedSequence``."""
    word = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(word >> 1)


def _out_indices(in_packer: Packer, out_packer: Packer):
    """The output names' channels among the inputs: a slice where they are
    consecutive (a view: a list index would copy itself from the host at
    every use), else the list."""
    idx = in_packer.index
    out = [idx[n] for n in out_packer.names]
    if out == list(range(out[0], out[0] + len(out))):
        return slice(out[0], out[0] + len(out))
    return out


class InterpolationExperiment:
    """Stochastic time interpolation: inputs are the first ``window`` frames
    and the last frame stacked into channels, a per-sample time t in
    [1, horizon - 1], and the target the frame at ``window + t - 1``;
    dropout stays live at inference when ``enable_inference_dropout`` (the
    DYffusion spread source)."""

    def __init__(self, model, cfg: ExperimentConfig, in_packer: Packer,
                 out_packer: Packer, normalizer: StandardNormalizer):
        if cfg.horizon < 2:
            raise ValueError("horizon must be >= 2 for interpolation")
        self.model = model
        self.cfg = cfg
        self.in_packer = in_packer
        self.out_packer = out_packer
        self.normalizer = normalizer
        self.criterion = get_loss_fn(cfg.loss_function)
        self._out_idx = _out_indices(in_packer, out_packer)

    @property
    def horizon_range(self) -> list:
        return list(range(1, self.cfg.horizon))

    def get_inputs_from_dynamics(self, dynamics: torch.Tensor) -> torch.Tensor:
        return torch.cat([stack_window(dynamics[:, :self.cfg.window]), dynamics[:, -1]], dim=-1)

    def slice_condition(self, dynamical_condition: Optional[torch.Tensor], target_time):
        """The condition at ``target_time``: an int, or one index per sample."""
        if dynamical_condition is None:
            return None
        if isinstance(target_time, int):
            return dynamical_condition[:, target_time]
        B = dynamical_condition.shape[0]
        return dynamical_condition[torch.arange(B, device=target_time.device), target_time]

    def train_loss(self, dynamics: torch.Tensor, generator: torch.Generator,
                   dynamical_condition: Optional[torch.Tensor] = None,
                   static_condition: Optional[torch.Tensor] = None,
                   random_timestep: Optional[torch.Tensor] = None):
        """``(loss, {"loss": loss})`` on normalized ``dynamics``
        (B, window + horizon, H, W, C), t drawn from ``generator``; or, from a
        sparse "interpolation"-strategy loader, dynamics (B, window + 2, ...)
        holding [window frames, frame at t, last frame] with its draw
        ``random_timestep`` (B,)."""
        B = dynamics.shape[0]
        w = self.cfg.window
        if random_timestep is not None:
            if dynamics.shape[1] != w + 2:
                raise ValueError(f"random_timestep given but dynamics has {dynamics.shape[1]} "
                                 f"frames; the sparse 'interpolation' strategy emits "
                                 f"window+2={w + 2}")
            t = to_device(torch.as_tensor(random_timestep), dynamics.device).long()
            targets = dynamics[:, w][..., self._out_idx]
            cond = dynamical_condition[:, w] if dynamical_condition is not None else None
        else:
            if dynamics.shape[1] != w + self.cfg.horizon:
                raise ValueError(f"sequential interpolation training needs window+horizon="
                                 f"{w + self.cfg.horizon} frames, got {dynamics.shape[1]}")
            t = torch.randint(1, self.cfg.horizon, (B,), device=dynamics.device,
                              generator=device_generator(generator, dynamics.device))
            target_time = w + t - 1
            targets = dynamics[torch.arange(B, device=t.device), target_time][..., self._out_idx]
            cond = self.slice_condition(dynamical_condition, target_time)
        preds = self.model(self.get_inputs_from_dynamics(dynamics), time=t.float(),
                           condition=cond, static_condition=static_condition,
                           deterministic=False, generator=generator)
        loss = self.criterion(preds, targets)
        return loss, {"loss": loss}

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
    a forecaster, sampled with the cold sampler.

    ``interpolator_ema_params`` are the interpolator checkpoint's EMA
    weights (a ``state_dict``, or None). With
    ``diffusion_cfg.interpolator_use_ema`` they are loaded into the
    interpolator's network, which every interpolation then runs, as the JAX
    package runs its ``active_interpolator_params``; the flag without EMA
    weights raises."""

    def __init__(self, forecaster_model, interpolator: InterpolationExperiment,
                 diffusion_cfg: DYffusionConfig, cfg: ExperimentConfig,
                 in_packer: Packer, out_packer: Packer,
                 normalizer: StandardNormalizer, forcing_names: Sequence[str] = (),
                 forcing_normalizer: Optional[StandardNormalizer] = None,
                 interpolator_ema_params: Optional[Mapping[str, torch.Tensor]] = None):
        if diffusion_cfg.timesteps != cfg.horizon:
            raise ValueError("diffusion timesteps must equal horizon "
                             f"({diffusion_cfg.timesteps} != {cfg.horizon})")
        if diffusion_cfg.interpolator_use_ema and interpolator_ema_params is None:
            raise ValueError("diffusion.interpolator_use_ema=True but no interpolator EMA "
                             "params were provided (the interpolator checkpoint has no "
                             "ema_params)")
        self.model = forecaster_model
        self.interpolator = interpolator
        if diffusion_cfg.interpolator_use_ema:
            interpolator.model.load_state_dict(interpolator_ema_params)
        self.diffusion_cfg = diffusion_cfg
        self.sched = build_schedule(diffusion_cfg)
        self.cfg = cfg
        self.in_packer = in_packer
        self.out_packer = out_packer
        self.normalizer = normalizer
        self.forcing_names = tuple(forcing_names)
        self.forcing_normalizer = forcing_normalizer
        self.criterion = get_loss_fn(cfg.loss_function)
        self._out_idx = _out_indices(in_packer, out_packer)

    def _interp_fn(self, training: bool = False):
        """The frozen interpolator; its dropout is always on in training.
        In training it runs under ``torch.no_grad()`` unless x_last carries
        the forecaster's gradient (the ``lambda_reconstruction2`` term
        without ``reconstruction2_detach_x_last``), which then flows
        through it as in JAX; the trainer differentiates the forecaster's
        parameters only."""
        fn = self.interpolator.make_interpolate_fn(
            hack_for_imprecise_interpolation=self.diffusion_cfg.hack_for_imprecise_interpolation,
            use_inference_dropout=training or bool(self.diffusion_cfg.enable_interpolator_dropout))
        if not training:
            return fn

        def frozen(x_end, x_last, t, generator, **kw):
            if torch.is_grad_enabled() and (x_end.requires_grad or x_last.requires_grad):
                return fn(x_end, x_last, t, generator, **kw)
            with torch.no_grad():
                return fn(x_end, x_last, t, generator, **kw)

        return frozen

    def _forecast_fn(self, generator: Optional[torch.Generator] = None):
        """The forecaster; dropout live when a ``generator`` is given. Its
        ``mesh`` is the forecaster's (``SFNO.set_mesh``), so that the noised
        conditionings draw the whole grid's noise on a split grid."""

        def forecast_fn(x_t, time, condition, static_condition=None):
            return self.model(x_t, time=time.float(), condition=condition,
                              static_condition=static_condition,
                              deterministic=generator is None, generator=generator)

        forecast_fn.mesh = getattr(self.model, "_mesh", None)
        return forecast_fn

    def train_loss(self, dynamics: torch.Tensor, generator: torch.Generator,
                   dynamical_condition: Optional[torch.Tensor] = None,
                   static_condition: Optional[torch.Tensor] = None,
                   random_timestep: Optional[torch.Tensor] = None):
        """``(loss, {"loss", "loss_forward", "loss_forward2"})`` of
        ``p_losses`` on normalized ``dynamics`` (B, window + horizon, H, W,
        C); the diffusion step and all dropout come from ``generator``."""
        if random_timestep is not None:
            raise ValueError("DYffusion forecasting draws its own diffusion timestep; sparse "
                             "'random'/'interpolation' loader strategies are not supported")
        cond_kwargs = {}
        if dynamical_condition is not None:
            cond_kwargs["dynamical_condition"] = dynamical_condition
        if static_condition is not None:
            cond_kwargs["static_condition"] = static_condition
        losses = p_losses(self._interp_fn(training=True), self._forecast_fn(generator),
                          self.diffusion_cfg, self.sched,
                          stack_window(dynamics[:, :self.cfg.window]),
                          dynamics[:, -1][..., self._out_idx], generator,
                          criterion=self.criterion, **cond_kwargs)
        return losses["loss"], losses

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


class SimultaneousForecastingExperiment:
    """ACE-style baseline: ``horizon_at_once`` (hao) steps predicted in one
    forward by stacking time into channels, trained autoregressively over
    ``horizon / hao`` steps with per-step loss weights (``1 / steps`` each
    unless ``autoregressive_loss_weights``). The network takes ``window``
    frames of the state, the forcings (as ``condition``) and no time."""

    def __init__(self, model, cfg: ExperimentConfig, in_packer: Packer, out_packer: Packer,
                 normalizer: StandardNormalizer, horizon_at_once: Optional[int] = None,
                 autoregressive_loss_weights: Optional[Sequence[float]] = None,
                 forcing_names: Optional[Sequence[str]] = None,
                 forcing_normalizer: Optional[StandardNormalizer] = None):
        self.model = model
        self.cfg = cfg
        self.in_packer = in_packer
        self.out_packer = out_packer
        self.normalizer = normalizer
        # the forcings' names and statistics, which the ACE rollout of a
        # simultaneous checkpoint reads
        self.forcing_names = list(forcing_names or [])
        self.forcing_normalizer = forcing_normalizer
        self.horizon_at_once = horizon_at_once or cfg.horizon
        if cfg.horizon % self.horizon_at_once != 0:
            raise ValueError("horizon must be divisible by horizon_at_once")
        self.num_ar_steps = cfg.horizon // self.horizon_at_once
        self.ar_weights = (list(autoregressive_loss_weights)
                           if autoregressive_loss_weights is not None
                           else [1.0 / self.num_ar_steps] * self.num_ar_steps)
        self.criterion = get_loss_fn(cfg.loss_function)
        self._out_idx = _out_indices(in_packer, out_packer)
        self._n_out = len(out_packer.names)

    def train_loss(self, dynamics: torch.Tensor, generator: torch.Generator,
                   dynamical_condition: Optional[torch.Tensor] = None,
                   static_condition: Optional[torch.Tensor] = None,
                   random_timestep: Optional[torch.Tensor] = None):
        """``(loss, {"loss", "loss_ar<i>"})`` on normalized ``dynamics``
        (B, window + horizon, H, W, C): each autoregressive step predicts the
        next hao frames from the last ``window`` frames predicted (detached),
        with the condition at the frame before them and dropout drawn from
        ``fold_in(seed, step)``, ``seed`` one draw from ``generator``."""
        if random_timestep is not None:
            raise ValueError("simultaneous multi-horizon training needs sequential frames; "
                             "sparse 'random'/'interpolation' loader strategies are not "
                             "supported")
        w = self.cfg.window
        hao = self.horizon_at_once
        inputs = stack_window(dynamics[:, :w])
        seed = draw_seed(generator)
        total = 0.0
        metrics = {}
        for step in range(self.num_ar_steps):
            lo = w + step * hao
            targets = stack_window(dynamics[:, lo:lo + hao][..., self._out_idx])
            cond = dynamical_condition[:, lo - 1] if dynamical_condition is not None else None
            preds = self.model(inputs, condition=cond, static_condition=static_condition,
                               deterministic=False, generator=fold_in(seed, step))
            step_loss = self.criterion(preds, targets)
            total = total + self.ar_weights[step] * step_loss
            metrics[f"loss_ar{step}"] = step_loss
            if step + 1 < self.num_ar_steps:
                # the last predicted frame(s) are the next window
                B, H, W_, _ = preds.shape
                last = preds.reshape(B, H, W_, hao, self._n_out)[..., -w:, :]
                inputs = last.reshape(B, H, W_, w * self._n_out).detach()
        metrics["loss"] = total
        return total, metrics

    def predict(self, inputs: torch.Tensor, generator: Optional[torch.Generator] = None,
                condition: Optional[torch.Tensor] = None,
                static_condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One deterministic forward: (B, H, W, window * C_in) -> (B, hao, H,
        W, C_out)."""
        preds = self.model(inputs, condition=condition, static_condition=static_condition,
                           deterministic=True)
        B, H, W_, _ = preds.shape
        return torch.movedim(preds.reshape(B, H, W_, self.horizon_at_once, self._n_out), -2, 1)
