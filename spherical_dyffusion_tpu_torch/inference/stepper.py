"""DYffusion multi-step stepper: one window of an autoregressive rollout.

Counterpart of ``spherical_dyffusion_tpu/inference/stepper.py``
(``DYffusionStepper.run_window`` and the segment logic of
``_build_rollout``), written as a Python loop over segments instead of one
compiled ``lax.scan``:

* every ``horizon`` steps a new cold-sampling pass runs from the last
  (prescribed) prediction, and its intermediate horizons are emitted; the
  pass uses the sampler the JAX stepper compiles
  (``DYffusionForecastingExperiment.predict``: the double-batch scan form
  when ``scan_compatible``, peeled with ``peel_sampler``, else
  ``sample_loop``);
* forcings enter as ``static_condition`` at the segment's start time;
* the prescriber overwrites the prescribed channel of every emitted step;
* input channels that are not predicted are carried from the previous state;
* a trailing partial segment hands off its r-th prediction;
* the inputs noise (``prediction_inputs_noise``) perturbs the initial state
  of the rollout's first window only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..training.experiments import DYffusionForecastingExperiment
from .prescriber import NullPrescriber, PackedPrescriber

__all__ = ["DYffusionStepper"]


class DYffusionStepper:
    """Runs windows of an autoregressive DYffusion rollout."""

    def __init__(self, experiment: DYffusionForecastingExperiment,
                 prescriber: Optional[PackedPrescriber] = None,
                 inputs_noise: Optional[float] = None):
        self.exp = experiment
        self.prescriber = prescriber or NullPrescriber()
        self.inputs_noise = float(inputs_noise if inputs_noise is not None
                                  else experiment.cfg.prediction_inputs_noise or 0.0)
        self.horizon = experiment.cfg.horizon
        in_names = list(experiment.in_packer.names)
        out_names = list(experiment.out_packer.names)
        self._out_idx = [in_names.index(n) for n in out_names]
        self._carry_idx = [i for i, n in enumerate(in_names) if n not in out_names]

    def _segment(self, x, forcing, tgt, mask, generator, handoff_step: int):
        """One cold-sampling pass from state x; returns (next state, preds
        (B, horizon, H, W, C_out))."""
        H = self.horizon
        out = self.exp.predict(x, generator, static_condition=forcing)
        preds = torch.stack([out.preds[h] for h in range(1, H + 1)], dim=1)
        has_prescriber = not isinstance(self.prescriber, NullPrescriber)
        if has_prescriber:
            preds = self.prescriber(preds, tgt, mask)
        if out.ar_init is not None and handoff_step == H:
            last = out.ar_init
            if has_prescriber:
                last = self.prescriber(last, tgt[:, -1], mask[:, -1])
        else:
            last = preds[:, handoff_step - 1]
        x_next = torch.zeros_like(x)
        x_next[..., self._out_idx] = last.to(x.dtype)
        if self._carry_idx:
            x_next[..., self._carry_idx] = x[..., self._carry_idx]
        return x_next, preds

    @torch.inference_mode()
    def run_window(self, x0_norm: torch.Tensor,
                   window_forcing_norm: Optional[torch.Tensor],
                   window_prescribed_target_norm: Optional[torch.Tensor],
                   mask: Optional[torch.Tensor], generator: torch.Generator,
                   n_steps: int, apply_inputs_noise: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Roll ``n_steps`` forecast steps from x0_norm (B, H, W, C_in).

        window_forcing_norm: (B, T+1, H, W, Cf) or None; the prescribed
        target: (B, T+1, H, W) or None; mask: (B, T+1, H, W) per time,
        (B, H, W) static, or None. ``generator`` is a host-side
        ``torch.Generator`` that drives the inputs noise and the
        interpolator's dropout. Returns (final state, preds
        (B, n_steps, H, W, C_out))."""
        H = self.horizon
        n_full, r = divmod(n_steps, H)
        n_seg = n_full + (1 if r > 0 else 0)
        B = x0_norm.shape[0]
        grid = tuple(x0_norm.shape[1:3])
        dev = x0_norm.device

        def seg_frames(arr, s):
            # frames s*H+1 .. s*H+H, edge-padded for the partial segment
            frames = arr[:, s * H + 1: s * H + H + 1]
            if frames.shape[1] < H:
                pad = arr[:, -1:].expand(B, H - frames.shape[1], *arr.shape[2:])
                frames = torch.cat([frames, pad], dim=1)
            return frames

        x = x0_norm
        if apply_inputs_noise and self.inputs_noise > 0.0:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
            x = x + self.inputs_noise * noise.to(dev)
        parts = []
        for s in range(n_seg):
            forcing = (window_forcing_norm[:, s * H]
                       if window_forcing_norm is not None else None)
            if window_prescribed_target_norm is not None:
                tgt = seg_frames(window_prescribed_target_norm, s)
            else:
                tgt = torch.zeros((B, H) + grid, dtype=x.dtype, device=dev)
            if mask is None:
                msk = torch.zeros_like(tgt)
            elif mask.dim() == 4:
                msk = seg_frames(mask, s)
            else:
                msk = mask[:, None].expand(B, H, *mask.shape[1:3])
            handoff = H if s < n_full else r
            x, preds = self._segment(x, forcing, tgt, msk, generator, handoff)
            parts.append(preds if s < n_full else preds[:, :r])
        return x, torch.cat(parts, dim=1)
