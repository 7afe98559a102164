"""DYffusion schedule and cold sampling, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/diffusion/dyffusion.py``:
``DYffusionConfig``, ``DiffusionSchedule``/``build_schedule``, ``q_sample``,
``predict_x_last``, the forecaster's training loss ``p_losses``, the cold
samplers ``sample_loop``, ``scan_compatible``,
``sample_loop_scan`` and its peeled form. The JAX package's ``lax.scan``
samplers are Python loops here over the same math, and keep what makes them
differ from ``sample_loop`` on the device: the two interpolations of each
cold update run as ONE double-batch interpolator call (``[x_hat, x_hat]`` at
times ``[i(s+1), i(s)]``), with masked ends in the uniform form and
degenerate single-batch ends in the peeled form
(``DYffusionConfig.peel_sampler``). Everything works over two injected
callables:

    interpolate_fn(initial_condition, x_last, t, generator, **cond) -> x_t
    forecast_fn(x_t, time, condition, static_condition) -> x_hat_last

Randomness (the interpolator's dropout, the training timesteps, the noise
of the ``data+noise`` forward conditionings) flows through an explicit
host-side ``torch.Generator``. Tensors are channels-last (B, H, W, C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.modules import device_generator
from ..parallel.mesh import Mesh, spatial_block

__all__ = ["DYffusionConfig", "DiffusionSchedule", "build_schedule", "q_sample",
           "forward_noise", "predict_x_last", "p_losses", "sample_loop", "scan_compatible", "sample_loop_scan",
           "select_sampler", "Intermediates"]

InterpolateFn = Callable[..., torch.Tensor]
ForecastFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DYffusionConfig:
    """The JAX package's DYffusion hyperparameters, same names and defaults."""

    timesteps: int
    schedule: str = "before_t1_only"
    additional_interpolation_steps: int = 0
    additional_interpolation_steps_factor: int = 0
    interpolate_before_t1: bool = True
    forward_conditioning: str = "data"
    dynamic_cond_from_t: str = "h"
    time_encoding: str = "dynamics"
    sampling_type: str = "cold"
    sampling_schedule: Union[None, str, Sequence[float]] = None
    use_cold_sampling_for_intermediate_steps: bool = True
    use_cold_sampling_for_last_step: bool = True
    use_cold_sampling_for_init_of_ar_step: Optional[bool] = None
    refine_intermediate_predictions: bool = False
    peel_sampler: bool = False
    prediction_timesteps: Optional[Sequence[float]] = None
    enable_interpolator_dropout: Union[bool, str] = True
    interpolator_use_ema: bool = False
    hack_for_imprecise_interpolation: bool = False
    lambda_reconstruction: float = 1.0
    lambda_reconstruction2: float = 0.0
    reconstruction2_detach_x_last: bool = False

    @property
    def cold_ar_init(self) -> bool:
        if self.use_cold_sampling_for_init_of_ar_step is None:
            return self.use_cold_sampling_for_last_step
        return self.use_cold_sampling_for_init_of_ar_step


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Static diffusion-step bookkeeping."""

    cfg: DYffusionConfig
    num_timesteps: int
    additional_steps: int
    additional_steps_pre_t1: int
    factor: int
    di_to_ti_add: int
    sampling_steps: tuple

    def d_to_i(self, d):
        """Diffusion step -> interpolation step, for Python numbers and
        tensors alike."""
        sched = self.cfg.schedule
        if sched == "linear":
            return (d + self.di_to_ti_add) / (self.factor + 1)
        if sched == "before_t1_only":
            k = self.additional_steps
            if isinstance(d, (int, float)):
                return d - k if d >= k + 1 else d / (k + 1)
            return torch.where(d >= k + 1, (d - k).float(), d / (k + 1))
        if sched == "before_t1_then_linear":
            k = self.additional_steps_pre_t1
            lin = 1 + (d - k - 1) / (self.factor + 1)
            pre = d / (k + 1)
            if isinstance(d, (int, float)):
                return lin if d >= k + 1 else pre
            return torch.where(d >= k + 1, lin, pre)
        raise ValueError(f"Unknown schedule {sched!r}")

    @property
    def dynamical_steps(self) -> Dict[int, int]:
        out = {}
        for d in range(1, self.num_timesteps):
            i_n = self.d_to_i(d)
            if float(i_n).is_integer():
                out[d] = int(i_n)
        return out

    @property
    def artificial_steps(self) -> Dict[int, float]:
        return {d: float(self.d_to_i(d)) for d in range(1, self.num_timesteps)
                if not float(self.d_to_i(d)).is_integer()}

    def encode_time(self, t):
        enc = self.cfg.time_encoding
        if enc == "discrete":
            return t
        if enc == "continuous":
            return t / self.num_timesteps
        if enc == "dynamics":
            return self.d_to_i(t)
        raise ValueError(f"Unknown time_encoding {enc!r}")

    @property
    def forecaster_time_range(self) -> tuple:
        """(min, max) of the forecaster's encoded times."""
        times = [float(self.encode_time(d)) for d in range(self.num_timesteps)]
        return (min(times), max(times))


def build_schedule(cfg: DYffusionConfig) -> DiffusionSchedule:
    horizon = cfg.timesteps
    if horizon <= 1:
        raise ValueError(f"timesteps/horizon must be > 1, got {horizon}")
    if cfg.schedule == "linear":
        if cfg.additional_interpolation_steps != 0:
            raise ValueError("additional_interpolation_steps must be 0 for linear schedule")
        factor = cfg.additional_interpolation_steps_factor
        if cfg.interpolate_before_t1:
            interpolated_steps, di_to_ti_add = horizon - 1, 0
        else:
            interpolated_steps, di_to_ti_add = horizon - 2, factor
        additional = factor * interpolated_steps
        additional_pre_t1 = 0
    elif cfg.schedule == "before_t1_only":
        if cfg.additional_interpolation_steps_factor != 0:
            raise ValueError("additional_interpolation_steps_factor must be 0 for before_t1_only")
        if not cfg.interpolate_before_t1:
            raise ValueError("interpolate_before_t1 must be True for before_t1_only")
        factor, di_to_ti_add = 0, 0
        additional = additional_pre_t1 = cfg.additional_interpolation_steps
    elif cfg.schedule == "before_t1_then_linear":
        if not cfg.interpolate_before_t1:
            raise ValueError("interpolate_before_t1 must be True for before_t1_then_linear")
        factor = cfg.additional_interpolation_steps_factor
        additional_pre_t1 = cfg.additional_interpolation_steps
        additional = additional_pre_t1 + factor * (horizon - 2)
        di_to_ti_add = 0
    else:
        raise ValueError(f"Invalid schedule: {cfg.schedule}")
    sched = DiffusionSchedule(cfg=cfg, num_timesteps=horizon + additional,
                              additional_steps=additional,
                              additional_steps_pre_t1=additional_pre_t1,
                              factor=factor, di_to_ti_add=di_to_ti_add,
                              sampling_steps=())
    steps = _parse_sampling_schedule(cfg.sampling_schedule, sched)
    return dataclasses.replace(sched, sampling_steps=tuple(steps))


def _parse_sampling_schedule(schedule, sched: DiffusionSchedule) -> List[Union[int, float]]:
    """Sampling-schedule DSL: None -> all steps; 'only_dynamics[_plusN[_discrete]]',
    'everyN', 'firstN'/'firstFLOAT', or an explicit sequence."""
    N = sched.num_timesteps
    if schedule is None or schedule == "None":
        return list(range(N))
    if not isinstance(schedule, str):
        steps = list(schedule)
    else:
        base = [0] + list(sched.dynamical_steps.keys())
        artificial = list(sched.artificial_steps.keys())
        if "only_dynamics" in schedule:
            steps = []
            if "only_dynamics_plus" in schedule:
                plus_n = int(schedule.replace("only_dynamics_plus", "").replace("_discrete", ""))
                steps = list(np.linspace(0, base[1], plus_n + 1, endpoint=False))
                if "_discrete" in schedule:
                    steps = [int(np.floor(s)) for s in steps]
            elif schedule != "only_dynamics":
                raise ValueError(f"Invalid sampling schedule: {schedule}")
        elif schedule.startswith("every"):
            n = int(schedule.replace("every", "").rstrip("thndrdst"))
            if not 1 <= n <= N:
                raise ValueError(f"Invalid sampling schedule: {schedule}")
            steps = artificial[::n]
        elif schedule.startswith("first"):
            first_n = float(schedule.replace("first", "").replace("v2", ""))
            if first_n < 1:
                first_n = int(np.ceil(first_n * len(artificial)))
            else:
                if not float(first_n).is_integer():
                    raise ValueError(f"first_n >= 1 must be an integer: {first_n}")
                first_n = int(first_n)
            steps = artificial[:first_n]
        else:
            raise ValueError(f"Invalid sampling schedule: {schedule!r}")
        steps = steps + base
    steps = sorted(set(steps))
    if steps[0] != 0:
        steps = [0] + steps
    if not 1 <= steps[-1] <= N:
        raise ValueError(f"Invalid sampling schedule end: {steps}")
    if all(float(s).is_integer() for s in steps):
        steps = [int(s) for s in steps]
    return steps


def _hack_prepend(initial_condition: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([initial_condition[..., :1], x], dim=-1)


def q_sample(interpolate_fn: InterpolateFn, sched: DiffusionSchedule,
             x_end: torch.Tensor, x0: torch.Tensor,
             interpolation_time: Union[float, torch.Tensor],
             generator: Optional[torch.Generator], **kwargs: Any) -> torch.Tensor:
    """Run the stochastic interpolator at ``interpolation_time`` (a number,
    or one time per sample) for every sample (x_end = initial conditions, x0
    = last timestep). A time that is not positive (the masked t = 0 lane of
    ``p_losses``) becomes 1."""
    if isinstance(interpolation_time, torch.Tensor):
        i_t = interpolation_time.float()
    else:
        i_t = torch.full((x0.shape[0],), float(interpolation_time), dtype=torch.float32,
                         device=x0.device)
    i_t = torch.where(i_t > 0, i_t, torch.ones_like(i_t))
    return interpolate_fn(x_end, x0, i_t, generator, **kwargs)


def forward_noise(x: torch.Tensor, generator: Optional[torch.Generator],
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Standard normal noise of x's shape and dtype for the ``data+noise``
    conditionings, drawn on x's device from a generator there seeded from
    ``generator`` (a host generator): nothing of x's size comes from the
    host. With a ``mesh`` x ``(B, Hl, Wl, C)`` is this rank's block: the
    noise is drawn for the whole grid and the block's kept, as the one
    process draws it."""
    if generator is None:
        raise ValueError("data+noise conditioning requires a generator")
    device_gen = device_generator(generator, x.device)
    if mesh is None:
        return torch.randn(x.shape, generator=device_gen, device=x.device, dtype=x.dtype)
    blk = spatial_block(mesh, x.shape[-3:-1])
    return torch.randn(x.shape[:-3] + blk.shape + x.shape[-1:], generator=device_gen,
                       device=x.device, dtype=x.dtype)[..., blk.rows(), blk.cols(), :]


def predict_x_last(forecast_fn: ForecastFn, cfg: DYffusionConfig,
                   sched: DiffusionSchedule, initial_condition: torch.Tensor,
                   x_t: torch.Tensor, t: Union[float, torch.Tensor],
                   static_condition: Optional[torch.Tensor] = None,
                   dynamical_condition: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forecast x_{t0+h} from x_t at diffusion step ``t`` (a number, or one
    step per sample). The forecaster's condition is the initial condition
    ("data"), nothing ("none"), or the initial condition mixed with noise
    (``forward_noise``, from ``generator``) by the per-sample factor
    ``f = t / (N - 1)``: ``f x0 + (1 - f) noise`` ("data+noise-v1") or
    ``(1 - f) x0 + f noise`` ("data+noise-v2"); the forcings of
    ``dynamical_condition`` follow it. A ``forecast_fn`` whose ``mesh``
    attribute is set runs on that mesh's block of the grid, and the noise
    is the whole grid's, sliced."""
    B = initial_condition.shape[0]
    if isinstance(t, torch.Tensor):
        tt = t.float()
    else:
        tt = torch.full((B,), float(t), dtype=torch.float32, device=x_t.device)
    ctype = cfg.forward_conditioning
    if ctype == "data":
        forward_cond = initial_condition
    elif ctype == "none":
        forward_cond = None
    elif ctype in ("data+noise-v1", "data+noise-v2"):
        f = (tt / (sched.num_timesteps - 1)).reshape((B,) + (1,) * (initial_condition.dim() - 1))
        noise = forward_noise(initial_condition, generator, getattr(forecast_fn, "mesh", None))
        if ctype == "data+noise-v1":
            forward_cond = f * initial_condition + (1 - f) * noise
        else:
            forward_cond = (1 - f) * initial_condition + f * noise
    else:
        raise ValueError(f"Invalid forward conditioning {ctype!r}")
    if dynamical_condition is not None:
        if cfg.dynamic_cond_from_t == "0":
            dyn = dynamical_condition[:, 0]
        elif cfg.dynamic_cond_from_t == "h":
            dyn = dynamical_condition[:, -1]
        elif cfg.dynamic_cond_from_t == "t":
            idx = torch.round(tt).long()
            dyn = dynamical_condition[torch.arange(B, device=idx.device), idx]
        else:
            raise ValueError(f"Invalid dynamic_cond_from_t {cfg.dynamic_cond_from_t!r}")
        forward_cond = dyn if forward_cond is None else torch.cat([forward_cond, dyn], dim=-1)
    return forecast_fn(x_t, sched.encode_time(tt), forward_cond, static_condition)


def p_losses(interpolate_fn: InterpolateFn, forecast_fn: ForecastFn, cfg: DYffusionConfig,
             sched: DiffusionSchedule, input_dynamics: torch.Tensor, xt_last: torch.Tensor,
             generator: torch.Generator, criterion: Optional[Callable] = None,
             **cond_kwargs: Any) -> Dict[str, torch.Tensor]:
    """The forecaster's training loss (the JAX package's ``p_losses``).

    A diffusion step t ~ U{0..N-1} per sample, drawn on the batch's device
    from ``generator`` (a host generator seeds the draw there); for
    t > 0 the training input x_t comes from the interpolator (computed for
    every sample and masked, as in JAX); loss1 = criterion on the forecast
    of x_last. With ``lambda_reconstruction2 > 0`` a second term simulates
    one further diffusion step (t + 1, clamped to N - 1) from the forecast
    (detached with ``reconstruction2_detach_x_last``) and is the criterion
    per sample, averaged over the samples whose t + 1 is a valid step. The
    interpolator and the forecaster draw their dropout from ``generator``
    too."""
    if criterion is None:
        criterion = lambda a, b: torch.mean(torch.abs(a - b))  # noqa: E731 (l1)
    B = input_dynamics.shape[0]
    dev = input_dynamics.device
    t = torch.randint(0, sched.num_timesteps, (B,), device=dev,
                      generator=device_generator(generator, dev))
    x_interp = q_sample(interpolate_fn, sched, input_dynamics, xt_last, sched.d_to_i(t.float()),
                        generator, **cond_kwargs)
    tmask = (t > 0).reshape((B,) + (1,) * (input_dynamics.dim() - 1))
    x_t_model = torch.where(tmask, x_interp, input_dynamics)
    xt_last_pred = predict_x_last(forecast_fn, cfg, sched, input_dynamics, x_t_model, t,
                                  generator=generator, **cond_kwargs)
    loss_forward = criterion(xt_last_pred, xt_last)

    lam1, lam2 = cfg.lambda_reconstruction, cfg.lambda_reconstruction2
    if lam2 > 0:
        t2 = t + 1
        mask = (t2 <= sched.num_timesteps - 1).to(xt_last.dtype)
        x0_2 = xt_last_pred.detach() if cfg.reconstruction2_detach_x_last else xt_last_pred
        t2_safe = torch.clamp(t2, max=sched.num_timesteps - 1)
        x_interp2 = q_sample(interpolate_fn, sched, input_dynamics, x0_2,
                             sched.d_to_i(t2_safe.float()), generator, **cond_kwargs)
        x_last_pred2 = predict_x_last(forecast_fn, cfg, sched, input_dynamics, x_interp2,
                                      t2_safe, generator=generator, **cond_kwargs)
        per_sample = torch.stack([criterion(x_last_pred2[b:b + 1], xt_last[b:b + 1])
                                  for b in range(B)])
        loss_forward2 = torch.sum(per_sample * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss_forward2 = torch.zeros((), dtype=xt_last.dtype, device=dev)
    loss = lam1 * loss_forward + lam2 * loss_forward2
    return {"loss": loss, "loss_forward": loss_forward, "loss_forward2": loss_forward2}


@dataclasses.dataclass
class Intermediates:
    """Outputs of one cold-sampling pass over a horizon window."""

    preds: Dict[int, torch.Tensor]
    x_last: torch.Tensor
    ar_init: Optional[torch.Tensor] = None


def sample_loop(interpolate_fn: InterpolateFn, forecast_fn: ForecastFn,
                cfg: DYffusionConfig, sched: DiffusionSchedule,
                initial_condition: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                **cond_kwargs: Any) -> Intermediates:
    """Cold sampling: per visited step s, ``xhat = F(x_s, s)`` and then
    ``x_s <- x_s + I(xhat, s_next) - I(xhat, s)``, with the special cases at
    the first and last steps."""
    steps = list(sched.sampling_steps)
    N = sched.num_timesteps
    last_plus_one = steps[-1] + 1
    s_next_list = steps[1:] + [last_plus_one]

    x_s = initial_condition
    preds: Dict[int, torch.Tensor] = {}
    ar_init = None
    xhat = None
    dynamics_pred_step = 0

    def interp(x0, t_val):
        return q_sample(interpolate_fn, sched, initial_condition, x0, float(t_val),
                        generator, **cond_kwargs)

    for s, s_next in zip(steps, s_next_list):
        is_last = s == N - 1
        xhat = predict_x_last(forecast_fn, cfg, sched, initial_condition, x_s, float(s),
                              generator=generator, **cond_kwargs)
        xhat_state = (_hack_prepend(initial_condition, xhat)
                      if cfg.hack_for_imprecise_interpolation else xhat)
        time_i_n = float(sched.d_to_i(s_next)) if not is_last else math.inf
        is_dynamics_pred = float(time_i_n).is_integer() or is_last
        if s_next <= N - 1:
            x_int_next = interp(xhat, sched.d_to_i(s_next))
        else:
            x_int_next = xhat_state

        if cfg.sampling_type == "cold":
            if not cfg.use_cold_sampling_for_last_step and is_last:
                if cfg.cold_ar_init:
                    x_int_s = interp(xhat, sched.d_to_i(s))
                    ar = x_s + xhat_state - x_int_s
                    if cfg.hack_for_imprecise_interpolation:
                        ar = ar[..., 1:]
                    ar_init = ar
                x_s = xhat_state
            else:
                x_int_s = interp(xhat, sched.d_to_i(s)) if s > 0 else x_s
                x_s = x_s + x_int_next - x_int_s
        elif cfg.sampling_type == "naive":
            x_s = x_int_next
        else:
            raise ValueError(f"Unknown sampling type {cfg.sampling_type!r}")

        dynamics_pred_step = int(time_i_n) if s < N - 1 else dynamics_pred_step + 1
        if is_dynamics_pred:
            p = x_s if (cfg.use_cold_sampling_for_intermediate_steps or is_last) else x_int_next
            if cfg.hack_for_imprecise_interpolation:
                p = p[..., 1:]
            preds[dynamics_pred_step] = p

    if cfg.refine_intermediate_predictions:
        dyn_steps = cfg.prediction_timesteps or list(sched.dynamical_steps.values())
        for i_n in [i for i in dyn_steps if i < N]:
            p = interp(xhat, i_n)
            if cfg.hack_for_imprecise_interpolation:
                p = p[..., 1:]
            preds[int(i_n) if float(i_n).is_integer() else i_n] = p

    x_last = x_s if last_plus_one < N else xhat
    return Intermediates(preds=preds, x_last=x_last, ar_init=ar_init)


def scan_compatible(cfg: DYffusionConfig, sched: DiffusionSchedule) -> bool:
    """Whether the config admits the double-batch samplers below (the full
    schedule with cold updates everywhere: the released-model path)."""
    return (
        cfg.sampling_type == "cold"
        and tuple(sched.sampling_steps) == tuple(range(sched.num_timesteps))
        and cfg.use_cold_sampling_for_intermediate_steps
        and cfg.use_cold_sampling_for_last_step
        and not cfg.refine_intermediate_predictions
    )


def select_sampler(cfg: DYffusionConfig, sched: DiffusionSchedule):
    """The sampler the JAX package runs for this config: the scan form when
    ``scan_compatible`` (peeled inside it when ``peel_sampler`` and N >= 3),
    else ``sample_loop``."""
    return sample_loop_scan if scan_compatible(cfg, sched) else sample_loop


def _double_batch(interpolate_fn: InterpolateFn, initial_condition: torch.Tensor,
                  xhat: torch.Tensor, t_next: float, t_s: float,
                  generator: Optional[torch.Generator], cond_kwargs: dict):
    """Both interpolations of a cold update as one call on the batch
    ``[xhat, xhat]`` at times ``[t_next, t_s]``; returns the two halves."""
    B = initial_condition.shape[0]
    dev = initial_condition.device
    t_pair = torch.cat([torch.full((B,), float(t_next), dtype=torch.float32, device=dev),
                        torch.full((B,), float(t_s), dtype=torch.float32, device=dev)])
    cond2 = {k: (torch.cat([v, v]) if isinstance(v, torch.Tensor) else v)
             for k, v in cond_kwargs.items()}
    pair = interpolate_fn(torch.cat([initial_condition, initial_condition]),
                          torch.cat([xhat, xhat]), t_pair, generator, **cond2)
    return pair[:B], pair[B:]


def _scan_preds(cfg: DYffusionConfig, sched: DiffusionSchedule, states) -> Dict[int, torch.Tensor]:
    """Iteration s emits the prediction of interpolation step i(s+1); the
    last emits the horizon."""
    N = sched.num_timesteps
    preds: Dict[int, torch.Tensor] = {}
    for s in range(N):
        i_next = sched.d_to_i(s + 1) if s < N - 1 else float(cfg.timesteps)
        if float(i_next).is_integer():
            p = states[s]
            if cfg.hack_for_imprecise_interpolation:
                p = p[..., 1:]
            preds[int(i_next)] = p
    return preds


def sample_loop_scan(interpolate_fn: InterpolateFn, forecast_fn: ForecastFn,
                     cfg: DYffusionConfig, sched: DiffusionSchedule,
                     initial_condition: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     **cond_kwargs: Any) -> Intermediates:
    """Cold sampling with one uniform step body (the JAX package's
    ``lax.scan`` form), the same math as ``sample_loop`` for a
    ``scan_compatible`` config. Every step runs the forecaster once and the
    interpolator once on the double batch; at s = 0 the second half and at
    s = N - 1 the first half are computed and masked away, as on the TPU.
    Dispatches to the peeled form when ``cfg.peel_sampler`` and N >= 3."""
    if not scan_compatible(cfg, sched):
        raise ValueError("config is not scan-compatible; use sample_loop")
    N = sched.num_timesteps
    if cfg.peel_sampler and N >= 3:
        return _sample_loop_scan_peeled(interpolate_fn, forecast_fn, cfg, sched,
                                        initial_condition, generator, **cond_kwargs)
    x_s = initial_condition
    states = []
    xhat = None
    for s in range(N):
        xhat = predict_x_last(forecast_fn, cfg, sched, initial_condition, x_s, float(s),
                              generator=generator, **cond_kwargs)
        xhat_state = (_hack_prepend(initial_condition, xhat)
                      if cfg.hack_for_imprecise_interpolation else xhat)
        # the masked lanes get clamped times; a non-positive time becomes 1
        t_next = float(sched.d_to_i(min(s + 1, N - 1)))
        t_s = float(sched.d_to_i(max(s, 1)))
        x_int_next, x_int_s = _double_batch(
            interpolate_fn, initial_condition, xhat, t_next if t_next > 0 else 1.0,
            t_s if t_s > 0 else 1.0, generator, cond_kwargs)
        if s == N - 1:
            x_int_next = xhat_state
        if s == 0:
            x_int_s = x_s
        x_s = x_s + x_int_next - x_int_s
        states.append(x_s)
    return Intermediates(preds=_scan_preds(cfg, sched, states), x_last=xhat, ar_init=None)


def _sample_loop_scan_peeled(interpolate_fn: InterpolateFn, forecast_fn: ForecastFn,
                             cfg: DYffusionConfig, sched: DiffusionSchedule,
                             initial_condition: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             **cond_kwargs: Any) -> Intermediates:
    """``sample_loop_scan`` with the s = 0 and s = N - 1 steps peeled off, so
    no interpolator row is masked away:

    * s = 0: ``x_int_s == x_s``, so ``x_1 = I(xhat_0, i(1))``, one
      single-batch interpolation;
    * s = 1 .. N-2: the uniform double-batch step with both halves live;
    * s = N - 1: ``x_int_next == xhat``, so
      ``x_N = x_{N-1} + xhat - I(xhat, i(N-1))``, one single-batch
      interpolation."""
    N = sched.num_timesteps
    B = initial_condition.shape[0]
    dev = initial_condition.device

    def interp1(xhat, i_t):
        t = torch.full((B,), float(i_t), dtype=torch.float32, device=dev)
        return interpolate_fn(initial_condition, xhat, t, generator, **cond_kwargs)

    xhat = predict_x_last(forecast_fn, cfg, sched, initial_condition, initial_condition, 0.0,
                          generator=generator, **cond_kwargs)
    x_s = interp1(xhat, sched.d_to_i(1))
    states = [x_s]
    for s in range(1, N - 1):
        xhat = predict_x_last(forecast_fn, cfg, sched, initial_condition, x_s, float(s),
                              generator=generator, **cond_kwargs)
        x_int_next, x_int_s = _double_batch(interpolate_fn, initial_condition, xhat,
                                            sched.d_to_i(s + 1), sched.d_to_i(s), generator,
                                            cond_kwargs)
        x_s = x_s + x_int_next - x_int_s
        states.append(x_s)
    xhat = predict_x_last(forecast_fn, cfg, sched, initial_condition, x_s, float(N - 1),
                          generator=generator, **cond_kwargs)
    xhat_state = (_hack_prepend(initial_condition, xhat)
                  if cfg.hack_for_imprecise_interpolation else xhat)
    states.append(x_s + xhat_state - interp1(xhat, sched.d_to_i(N - 1)))
    return Intermediates(preds=_scan_preds(cfg, sched, states), x_last=xhat, ar_init=None)
