"""Running metric aggregators of a long rollout, reducing on the card.

Counterpart of ``spherical_dyffusion_tpu/evaluation/aggregators.py``:
``TimeMeanAggregator``, ``ReducedMetricsAggregator``, ``SnapshotAggregator``,
``ZonalMeanAggregator`` and ``InferenceAggregator`` with the same log keys
(``{label}/{metric}/{var}``, ``{label}/avg/{metric}``,
``{label}/time_mean/{metric}/{var}``). The JAX package jits one fused
reduction per window; here the reductions are plain PyTorch on the tensors'
device, and every table and snapshot stays there until ``series()``, a
``get_logs`` call or ``snapshots`` reads it: recording a window never moves
data to the host, so it does not wait for the device.
Predictions may arrive in bf16 and are reduced in float32. With
``log_video`` a ``VideoAggregator`` (``evaluation/video.py``) records each
window from host copies that the caller hands ``record_batch``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import to_device
from . import metrics as M

__all__ = [
    "TimeMeanAggregator",
    "ReducedMetricsAggregator",
    "SnapshotAggregator",
    "ZonalMeanAggregator",
    "InferenceAggregator",
]


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else to_device(t, device)


class TimeMeanAggregator:
    """Time-mean prediction and target maps; logs are the area-weighted RMSE
    and bias of the time means per variable, and with several members the
    per-member averages ``rmse_member_avg`` / ``bias_member_avg``.

    The maps are running means (Chan's update with frac = T / (n + T)), not
    raw sums, so over a 10-year rollout they stay at field magnitude, where
    float32 keeps small biases."""

    def __init__(self, names: Sequence[str], area_weights: torch.Tensor):
        self.names = list(names)
        self.w = area_weights
        self._pred_mean: Optional[torch.Tensor] = None  # (E, H, W, C) or (H, W, C)
        self._tgt_mean: Optional[torch.Tensor] = None
        self._n = 0

    def record(self, preds: torch.Tensor, targets: torch.Tensor):
        """preds (E, T, H, W, C) or (T, H, W, C); targets (T, H, W, C)."""
        T = preds.shape[-4]
        pm = torch.mean(preds.float(), dim=-4)
        tm = torch.mean(targets.float(), dim=0)
        if self._pred_mean is None:
            self._pred_mean, self._tgt_mean = pm, tm
        else:
            frac = T / (self._n + T)
            self._pred_mean = self._pred_mean + (pm - self._pred_mean) * frac
            self._tgt_mean = self._tgt_mean + (tm - self._tgt_mean) * frac
        self._n += T

    def get_logs(self, label: str = "time_mean") -> Dict[str, float]:
        if self._n == 0:
            return {}
        pred_mean, tgt_mean = self._pred_mean.float(), self._tgt_mean.float()
        is_ensemble = pred_mean.dim() == 4
        w = _on(self.w, pred_mean.device)[..., None]
        ens_mean = torch.mean(pred_mean, dim=0) if is_ensemble else pred_mean
        tables = {
            "rmse": M.root_mean_squared_error(tgt_mean, ens_mean, w, dim=(-3, -2)),
            "bias": M.weighted_mean_bias(tgt_mean, ens_mean, w, dim=(-3, -2)),
        }
        if is_ensemble and pred_mean.shape[0] > 1:
            tables["rmse_member_avg"] = torch.mean(M.root_mean_squared_error(
                tgt_mean, pred_mean, w, dim=(-3, -2)), dim=0)
            tables["bias_member_avg"] = torch.mean(M.weighted_mean_bias(
                tgt_mean, pred_mean, w, dim=(-3, -2)), dim=0)
        out = {}
        for metric, row in tables.items():
            row = row.cpu().numpy()
            for i, n in enumerate(self.names):
                out[f"{label}/{metric}/{n}"] = float(row[..., i].mean())
        return out

    @property
    def maps(self):
        if self._n == 0:
            return None
        p = self._pred_mean
        if p.dim() == 4:
            p = p.mean(dim=0)
        return p, self._tgt_mean


def _window_tables(preds: torch.Tensor, targets: torch.Tensor, w: torch.Tensor,
                   norm_stats=None) -> Dict[str, torch.Tensor]:
    """One window's (T, C) tables from preds (E, T, H, W, C) and targets
    (T, H, W, C). With ``norm_stats`` = (means, stds) the ``*_normed``
    variants on the standardized fields are added."""
    preds = preds.float()
    targets = targets.float()
    wc = w[..., None]
    ens_mean = torch.mean(preds, dim=0)
    out = {
        "rmse": M.root_mean_squared_error(targets, ens_mean, wc, dim=(-3, -2)),
        "bias": M.weighted_mean_bias(targets, ens_mean, wc, dim=(-3, -2)),
        "grad_mag_percent_diff": M.gradient_magnitude_percent_diff(targets, ens_mean, wc,
                                                                   dim=(-3, -2)),
    }
    if preds.shape[0] > 1:
        out["crps"] = M.crps_ensemble(targets, preds, wc, dim=(-3, -2))
        out["ssr"] = M.spread_skill_ratio(targets, preds, wc, dim=(-3, -2))
    if norm_stats is not None:
        mu, sd = norm_stats
        out.update({f"{k}_normed": v for k, v in
                    _window_tables((preds - mu) / sd, (targets - mu) / sd, w).items()})
    return out


class ReducedMetricsAggregator:
    """Per-timestep metric tables over a rollout, rows indexed by global
    timestep. ``normalizer``: optional ``StandardNormalizer`` over ``names``,
    which adds the ``_normed`` variant of every metric."""

    def __init__(self, names: Sequence[str], area_weights: torch.Tensor, normalizer=None):
        self.names = list(names)
        self.w = area_weights
        self._norm_stats = ((normalizer.means, normalizer.stds)
                            if normalizer is not None else None)
        self._tables: Dict[str, List[torch.Tensor]] = {}
        self._steps: List[int] = []

    def _device_args(self, device):
        self.w = _on(self.w, device)
        if self._norm_stats is not None:
            self._norm_stats = tuple(_on(s, device) for s in self._norm_stats)
        return self.w, self._norm_stats

    def _append(self, tables: Dict[str, torch.Tensor], start_step: int, T: int):
        self._steps.extend(range(start_step, start_step + T))
        for k, v in tables.items():
            self._tables.setdefault(k, []).append(v)

    def record(self, preds: torch.Tensor, targets: torch.Tensor, start_step: int = 0):
        if preds.dim() == 4:
            preds = preds[None]
        w, stats = self._device_args(preds.device)
        self._append(_window_tables(preds, targets, w, stats), start_step, preds.shape[1])

    def series(self) -> Dict[str, np.ndarray]:
        """{metric: (total_T, C)} tables, moved to the host."""
        return {k: torch.cat(v, dim=0).cpu().numpy() for k, v in self._tables.items()}

    def get_logs(self, label: str = "") -> Dict[str, float]:
        """Time-averaged metrics per variable and their average over
        variables (``avg/``)."""
        out = {}
        prefix = f"{label}/" if label else ""
        for metric, rows in self.series().items():
            mean_t = rows.mean(axis=0)
            for i, n in enumerate(self.names):
                out[f"{prefix}{metric}/{n}"] = float(mean_t[i])
            out[f"{prefix}avg/{metric}"] = float(mean_t.mean())
        return out


class SnapshotAggregator:
    """(pred, target) maps at fixed global timesteps, the first member's.
    They stay on the device while the rollout runs, so recording one does
    not wait for the card; ``snapshots`` copies them to the host."""

    DEFAULT_STEPS = (20, 500, 1400, 5000, 10000, 14600)

    def __init__(self, names: Sequence[str], steps: Optional[Sequence[int]] = None):
        self.names = list(names)
        self.steps = sorted(steps if steps is not None else self.DEFAULT_STEPS)
        self._maps: Dict[int, Dict[str, torch.Tensor]] = {}

    def record(self, preds: torch.Tensor, targets: torch.Tensor, start_step: int = 0):
        if preds.dim() == 5:
            preds = preds[0]
        T = preds.shape[0]
        for s in self.steps:
            local = s - start_step
            if 0 <= local < T and s not in self._maps:
                # a copy of the selected (H, W, C) slice, not a view that
                # would keep the whole window alive
                self._maps[s] = {"preds": preds[local].to(torch.float32, copy=True),
                                 "targets": targets[local].to(torch.float32, copy=True)}

    @property
    def snapshots(self) -> Dict[int, Dict[str, np.ndarray]]:
        return {s: {k: v.cpu().numpy() for k, v in m.items()} for s, m in self._maps.items()}


class ZonalMeanAggregator:
    """Zonal-mean (over longitude) Hovmoeller rows of the ensemble mean and
    the targets, (T, H, C) a window."""

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self._pred_rows: List[torch.Tensor] = []
        self._tgt_rows: List[torch.Tensor] = []

    def record(self, preds: torch.Tensor, targets: torch.Tensor, start_step: int = 0):
        ens = preds.mean(dim=0) if preds.dim() == 5 else preds
        self._pred_rows.append(ens.float().mean(dim=-2))
        self._tgt_rows.append(targets.float().mean(dim=-2))

    def get_maps(self):
        if not self._pred_rows:
            return None
        return (torch.cat(self._pred_rows, dim=0).cpu().numpy(),
                torch.cat(self._tgt_rows, dim=0).cpu().numpy())


class InferenceAggregator:
    """The aggregators of one rollout: per-step tables, time means,
    snapshots, (optionally) zonal means and (``log_video``) the video, fed
    one window at a time."""

    def __init__(self, names: Sequence[str], area_weights: torch.Tensor,
                 log_zonal_mean_images: bool = True,
                 snapshot_steps: Optional[Sequence[int]] = None, normalizer=None,
                 log_video: bool = False):
        from .video import VideoAggregator

        self.names = list(names)
        self.time_mean = TimeMeanAggregator(names, area_weights)
        self.reduced = ReducedMetricsAggregator(names, area_weights, normalizer=normalizer)
        self.snapshots = SnapshotAggregator(names, snapshot_steps)
        self.zonal = ZonalMeanAggregator(names) if log_zonal_mean_images else None
        self.video = VideoAggregator(names) if log_video else None

    def record_batch(self, preds: torch.Tensor, targets: torch.Tensor, start_step: int = 0,
                     host=None):
        """preds (E, T, H, W, C) or (T, H, W, C) and targets (T, H, W, C),
        both raw (denormalized), on one device. Every reduction runs there;
        the float32 upcast of bf16 preds is made once and shared. ``host``:
        the same window's (preds, targets) as host numpy arrays, which the
        video records, and which it needs (recording never reads the
        window's tensors back, so never waits for the card)."""
        if self.video is not None:
            if host is None:
                raise ValueError("log_video: record_batch needs the window's host copies "
                                 "(host=(preds, targets))")
            self.video.record_batch(host[0], host[1], start_step)
        if preds.dim() == 4:
            preds = preds[None]
        preds = preds.float()
        targets = targets.float()
        w, stats = self.reduced._device_args(preds.device)
        self.reduced._append(_window_tables(preds, targets, w, stats), start_step,
                             preds.shape[1])
        self.time_mean.record(preds, targets)
        if self.zonal is not None:
            self.zonal.record(preds, targets)
        self.snapshots.record(preds, targets, start_step)

    def get_logs(self, label: str = "inference") -> Dict[str, float]:
        logs = {}
        logs.update(self.reduced.get_logs(label))
        logs.update(self.time_mean.get_logs(f"{label}/time_mean"))
        return logs

    def get_inference_logs(self, label: str = "inference") -> List[Dict[str, float]]:
        """One log dict per rollout step, the time-mean metrics attached to
        the last."""
        prefix = f"{label}/" if label else ""
        series = self.reduced.series()
        out: List[Dict[str, float]] = []
        for row, step in enumerate(self.reduced._steps):
            entry: Dict[str, float] = {"timestep": step}
            for metric, rows in series.items():
                for i, n in enumerate(self.names):
                    entry[f"{prefix}{metric}/{n}"] = float(rows[row, i])
                entry[f"{prefix}avg/{metric}"] = float(rows[row].mean())
            out.append(entry)
        if out:
            out[-1].update(self.time_mean.get_logs(f"{label}/time_mean"))
        return out
