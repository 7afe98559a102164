"""Video aggregation: running per-timestep mean/variance/error recorders.

Counterpart of ``spherical_dyffusion_tpu/evaluation/video.py``, the same
numpy on the host: per-timestep running statistics, accumulated across
windows and members in float64 (a batched Welford update with Chan's
combine), so that (time, lat, lon) videos of the ensemble mean and variance,
the target mean and the error of the ensemble mean come out at the end of a
rollout without holding its frames. Its inputs are host arrays: the rollout
loops hand it the host copies of each window (``inference/loop.py``), and it
never reads a tensor from the card. ``save`` writes the videos through
``data/hdf5.py``'s ``Writer``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["VideoAggregator"]


class _RunningMoments:
    """Per-timestep streaming mean/variance over recorded samples."""

    def __init__(self):
        self.count: Optional[np.ndarray] = None
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def update(self, start: int, values: np.ndarray):
        """values: (n_samples, T, H, W, C) recorded for steps [start, start+T)."""
        n, T = values.shape[0], values.shape[1]
        end = start + T
        if self.mean is None:
            shape = (end,) + values.shape[2:]
            self.count = np.zeros((end,) + (1,) * (values.ndim - 2))
            self.mean = np.zeros(shape, np.float64)
            self.m2 = np.zeros(shape, np.float64)
        elif end > self.mean.shape[0]:
            extra = end - self.mean.shape[0]
            self.count = np.concatenate([self.count, np.zeros((extra,) + self.count.shape[1:])])
            self.mean = np.concatenate([self.mean, np.zeros((extra,) + self.mean.shape[1:])])
            self.m2 = np.concatenate([self.m2, np.zeros((extra,) + self.m2.shape[1:])])
        # batched Welford (Chan's parallel combine): one vectorized update for
        # the whole member batch instead of a python loop per member —
        # identical moments, O(n) fewer passes over the (T, H, W, C) videos
        x = values.astype(np.float64)
        b_mean = x.mean(axis=0)
        b_m2 = ((x - b_mean) ** 2).sum(axis=0)
        old_count = self.count[start:end]
        new_count = old_count + n
        delta = b_mean - self.mean[start:end]
        self.mean[start:end] += delta * (n / new_count)
        self.m2[start:end] += b_m2 + delta**2 * (old_count * n / new_count)
        self.count[start:end] = new_count

    @property
    def variance(self) -> Optional[np.ndarray]:
        if self.m2 is None:
            return None
        return self.m2 / np.maximum(self.count - 1, 1)


class VideoAggregator:
    """Composes mean/variance/error video recorders
    (reference _MeanVideoData:101, _VarianceVideoData:159, _ErrorVideoData:29)."""

    def __init__(self, names: Sequence[str], enable_variance: bool = True):
        self.names = list(names)
        self.gen = _RunningMoments()
        self.target = _RunningMoments()
        self.error = _RunningMoments()
        self.enable_variance = enable_variance

    def record_batch(self, preds: np.ndarray, targets: Optional[np.ndarray] = None,
                     start_step: int = 0):
        """preds: (E, T, H, W, C); targets: (T, H, W, C) or None (gen-only)."""
        preds = np.asarray(preds)
        if preds.ndim == 4:
            preds = preds[None]
        self.gen.update(start_step, preds)
        if targets is not None:
            targets = np.asarray(targets)
            self.target.update(start_step, targets[None])
            err = preds.mean(axis=0, keepdims=True) - targets[None]
            self.error.update(start_step, err)

    def get_videos(self) -> Dict[str, np.ndarray]:
        out = {
            "gen_mean": self.gen.mean,
            "target_mean": self.target.mean,
            "error_mean": self.error.mean,
        }
        if self.enable_variance and self.gen.variance is not None:
            out["gen_variance"] = self.gen.variance
        return {k: v.astype(np.float32) for k, v in out.items() if v is not None}

    def save(self, path: str):
        """One ``{key}/{name}`` dataset per video and variable."""
        from ..data.hdf5 import Writer

        with Writer(path) as f:
            for key, video in self.get_videos().items():
                for i, n in enumerate(self.names):
                    f.write(f"{key}/{n}", video[..., i])
