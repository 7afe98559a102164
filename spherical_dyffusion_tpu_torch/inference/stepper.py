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

The options of the JAX stepper's constructor that the 10-year config uses
are here: ``use_ema_params`` with ``ema_params``, ``params_dtype`` and
``preds_dtype``. The networks are ``nn.Module``s that hold their weights, so
the EMA tree is loaded into the experiment's forecaster and ``params_dtype``
rounds the weights of both networks in place (see ``__init__``).

``mesh`` (``parallel/mesh.py``) splits the rows (initial conditions x
ensemble members) over its "data" group and the grid over "h" (latitudes)
and "w" (longitudes), as the JAX stepper's ``shard_rows`` places the
window's arrays: each rank rolls out its rows of its block, with the
generator folded with its data index (so the ranks of one data index draw
alike), both networks attached to the mesh for the window
(``SFNO.set_mesh``) where "h" or "w" is above 1, and ``run_window`` returns
the window gathered, so callers see the global batch; the weights are
broadcast from the mesh's first rank. Rows that do not divide by the data
size stay whole on every rank, as JAX leaves them replicated; the grid must
divide by "h" and "w". Ranks that differ only in "matmul" hold replicas, as
JAX shards no window array over it. The inputs noise is drawn for the whole
grid and sliced to the block, and so is the noise of the noised forecaster
conditionings ("data+noise", ``diffusion/dyffusion.py:forward_noise``, from
the forecaster's mesh). The sampler is pointwise but for its network calls
and its generator, so it needs no change. Both backbones have a split-grid
route: every SFNO option (``SFNO.set_mesh``), and the UNet
(``UNet.set_mesh``: halo exchanges before its convolutions, grid-wide norm
and attention sums, its deepest levels whole on every rank).
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping, Optional, Tuple

import torch

from ..models.modules import fold_generator
from ..parallel.mesh import (
    AXIS_DATA,
    AXIS_H,
    AXIS_W,
    Mesh,
    gather,
    replicated,
    shard,
    spatial_block,
)
from ..training.experiments import DYffusionForecastingExperiment
from ..utils.convert import flax_to_state_dict
from ..utils.device import to_device
from .prescriber import NullPrescriber, PackedPrescriber

__all__ = ["DYffusionStepper", "round_params"]


def round_params(net: torch.nn.Module, dtype: str) -> None:
    """Round every floating parameter and buffer of ``net`` to ``dtype``
    values in place; they stay float32 tensors."""
    dt = getattr(torch, dtype)
    with torch.no_grad():
        for t in (*net.parameters(), *net.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(dt))


class DYffusionStepper:
    """Runs windows of an autoregressive DYffusion rollout."""

    def __init__(self, experiment: DYffusionForecastingExperiment,
                 prescriber: Optional[PackedPrescriber] = None,
                 use_ema_params: bool = False,
                 ema_params: Optional[Mapping[str, Any]] = None,
                 inputs_noise: Optional[float] = None,
                 params_dtype: Optional[str] = None,
                 preds_dtype: Optional[str] = None, mesh: Optional[Mesh] = None):
        """``use_ema_params`` loads the forecaster's EMA weights,
        ``ema_params`` (a flax variable tree, converted by
        ``utils/convert.py``, or a ``state_dict``), into the experiment's
        forecaster; it raises without them. The interpolator runs the
        weights its experiment loaded: with ``interpolator_use_ema`` its
        checkpoint's EMA weights (the JAX stepper's
        ``active_interpolator_params``).

        ``params_dtype="bfloat16"`` rounds every floating parameter and
        buffer of both networks (the transforms' matrices too, as the JAX
        stepper's cast covers the ``constants`` collection) to bf16 values.
        They stay float32 tensors: K1 takes float32 weights, and every other
        consumer casts at use, so the values, not the storage, decide the
        result. The rounding is an in-place update, so K1's weight images are
        made again, once, at the next forward.

        ``preds_dtype`` is the dtype of the emitted predictions: only the
        emitted copy is rounded, and the hand-off state stays float32.
        ``mesh``: see the module's docstring."""
        self.exp = experiment
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._nets = ((experiment.model, experiment.interpolator.model)
                      if self.mesh is not None else ())
        if self.mesh is not None and self.mesh.spatial:
            for net in self._nets:  # a grid that does not split raises here
                net.set_mesh(self.mesh)
                net.set_mesh(None)
        if use_ema_params:
            if ema_params is None:
                raise ValueError("use_ema_params=True requires ema_params (the checkpoint "
                                 "has no EMA weights)")
            experiment.model.load_state_dict(_as_state_dict(ema_params))
        if self.mesh is not None:
            for net in self._nets:
                replicated(self.mesh, list(net.parameters()))
        if params_dtype:
            for net in (experiment.model, experiment.interpolator.model):
                round_params(net, params_dtype)
        self.preds_dtype = getattr(torch, preds_dtype) if preds_dtype else None
        self.prescriber = prescriber or NullPrescriber()
        self.inputs_noise = float(inputs_noise if inputs_noise is not None
                                  else experiment.cfg.prediction_inputs_noise or 0.0)
        self.horizon = experiment.cfg.horizon
        in_names = list(experiment.in_packer.names)
        out_names = list(experiment.out_packer.names)
        # index tensors on the networks' device: a host index would be
        # copied to the card at every segment, waiting for the stream
        dev = next(experiment.model.parameters()).device
        self._out_idx = to_device(torch.tensor([in_names.index(n) for n in out_names]), dev)
        self._carry_idx = to_device(torch.tensor(
            [i for i, n in enumerate(in_names) if n not in out_names], dtype=torch.long), dev)

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
        if self._carry_idx.numel():
            x_next[..., self._carry_idx] = x[..., self._carry_idx]
        if self.preds_dtype is not None:
            preds = preds.to(self.preds_dtype)
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
        (B, n_steps, H, W, C_out)); on a mesh, the window of every rank
        gathered."""
        mesh = self.mesh
        if mesh is None:
            return self._run_window(x0_norm, window_forcing_norm, window_prescribed_target_norm,
                                    mask, generator, n_steps, apply_inputs_noise)
        rows = mesh.shape[AXIS_DATA] > 1 and x0_norm.shape[0] % mesh.shape[AXIS_DATA] == 0
        if not rows and not mesh.spatial:
            return self._run_window(x0_norm, window_forcing_norm, window_prescribed_target_norm,
                                    mask, generator, n_steps, apply_inputs_noise)

        def spec(x, lat):
            """JAX's ``shard_rows(x, spatial_dims=(lat, lat + 1))``: rows over
            "data" where they divide, latitudes and longitudes over "h"/"w"."""
            if x is None:
                return None
            out = [None] * x.dim()
            out[0] = AXIS_DATA if rows else None
            if mesh.spatial:
                out[lat], out[lat + 1] = AXIS_H, AXIS_W
            return tuple(out)

        specs = [spec(x0_norm, 1), spec(window_forcing_norm, 2),
                 spec(window_prescribed_target_norm, 2),
                 spec(mask, mask.dim() - 2) if mask is not None else None]
        args = [shard(mesh, a, sp) if a is not None else None
                for a, sp in zip((x0_norm, window_forcing_norm, window_prescribed_target_norm,
                                  mask), specs)]
        if rows:
            generator = fold_generator(generator, mesh.index(AXIS_DATA))
        with contextlib.ExitStack() as stack:
            if mesh.spatial:
                for net in self._nets:
                    net.set_mesh(mesh)
                    stack.callback(net.set_mesh, None)
            x, preds = self._run_window(*args, generator, n_steps, apply_inputs_noise,
                                        whole=tuple(x0_norm.shape[1:3]) if mesh.spatial else None)
        return gather(mesh, x, specs[0]), gather(mesh, preds, spec(preds, 2))

    def _run_window(self, x0_norm, window_forcing_norm, window_prescribed_target_norm, mask,
                    generator, n_steps, apply_inputs_noise, whole=None):
        """The window on this rank's block; ``whole``: the whole grid's (H, W)
        where the block is a part of it (the inputs noise is drawn for the
        whole grid and sliced)."""
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
            if whole is None:
                noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
            else:
                blk = spatial_block(self.mesh, x.shape[1:3])
                noise = torch.randn((x.shape[0],) + whole + x.shape[3:], generator=generator,
                                    dtype=x.dtype)[:, blk.rows(), blk.cols()]
            x = x + self.inputs_noise * to_device(noise, dev)
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


def _as_state_dict(tree: Mapping[str, Any]) -> Mapping[str, torch.Tensor]:
    """A ``state_dict`` as it is, a flax variable tree converted."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return tree
    return flax_to_state_dict(tree)
