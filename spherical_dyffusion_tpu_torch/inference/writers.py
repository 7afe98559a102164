"""Rollout output writers: predictions, histograms and videos as netCDF-4
(HDF5) files.

Counterpart of ``spherical_dyffusion_tpu/inference/writers.py``, the same
numpy on host arrays, over ``data/hdf5.py``'s ``Writer`` instead of h5py
(which the card's machine does not have): on the same float32 inputs the
files hold the same values. The rollout loops hand each writer the host
copies of a window (``inference/loop.py``); an array given to ``append`` is
valid for that call only, since the loops reuse their pinned host buffers,
so a writer that keeps data past the call copies it (``TimeCoarsen``).

One departure: the JAX ``DataWriter`` builds a ``HistogramWriter`` for
``save_histogram_files`` whose ``close`` writes nothing; here ``close``
saves the histograms to ``histograms.nc`` in the output directory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.hdf5 import Writer
from ..utils.naming import variable_metadata

__all__ = [
    "PredictionWriter",
    "DynamicHistogram",
    "HistogramWriter",
    "VideoWriter",
    "TimeCoarsen",
    "DataWriterConfig",
    "DataWriter",
]


class PredictionWriter:
    """Appends predicted (and optionally target) fields to a netCDF-style
    HDF5 file with an unlimited time axis: ``(E, T, H, W)`` float32 per
    variable, chunked ``(1, 1, H, W)``, with ``long_name`` and ``units``;
    ``target_{name}`` ``(T, H, W)`` with ``save_targets``. The chunks go to
    disk as they are appended; ``close`` writes the index and renames the
    file into place."""

    def __init__(self, path: str, names: Sequence[str], lat: np.ndarray, lon: np.ndarray,
                 n_ensemble: int = 1, save_targets: bool = False,
                 save_names: Optional[Sequence[str]] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.names = list(names)
        # save_raw_prediction_names: the variables kept; channels still
        # follow `names`
        self.save_set = set(save_names) if save_names is not None else None
        unknown = (self.save_set or set()) - set(self.names)
        if unknown:
            raise ValueError(f"save_raw_prediction_names not in outputs: {sorted(unknown)}")
        self.save_targets = save_targets
        self.f = Writer(path)
        self.f.write("lat", np.asarray(lat))
        self.f.write("lon", np.asarray(lon))
        H, W = len(lat), len(lon)
        self._dsets = {}
        for n in self.names:
            if self.save_set is not None and n not in self.save_set:
                continue
            ln, u = variable_metadata(n)
            attrs = {"long_name": ln, **({"units": u} if u else {})}
            self._dsets[n] = self.f.create_growing(n, (n_ensemble, 0, H, W), np.float32, 1,
                                                   attrs)
            if save_targets:
                self._dsets["target_" + n] = self.f.create_growing(
                    "target_" + n, (0, H, W), np.float32, 0)

    def append(self, preds: np.ndarray, targets: Optional[np.ndarray] = None):
        """preds: (E, T, H, W, C); targets: (T, H, W, C)."""
        preds = np.asarray(preds)
        if preds.dtype not in (np.float32, np.float64):
            preds = preds.astype(np.float32)
        for i, n in enumerate(self.names):
            if n not in self._dsets:
                continue
            self._dsets[n].append(preds[..., i])
            if self.save_targets and targets is not None:
                self._dsets["target_" + n].append(np.asarray(targets)[..., i])

    def close(self):
        self.f.close()

    def abort(self):
        """Closes and removes the file written so far."""
        self.f.abort()


class DynamicHistogram:
    """Fixed-bin-count histogram whose bins double in width whenever a new
    value falls outside the current range, pairwise-merging existing counts,
    so that no value is dropped. ``n_bins`` must be even (bin pairs merge on
    resize)."""

    EPSILON = 1.0e-6

    def __init__(self, n_bins: int = 300):
        if n_bins % 2:
            raise ValueError("n_bins must be even (bins merge pairwise on resize)")
        self.n_bins = n_bins
        self.bin_edges: np.ndarray = None
        self.counts = np.zeros(n_bins, np.int64)

    def add(self, value: np.ndarray):
        v = np.asarray(value).ravel()
        vmin, vmax = float(v.min()), float(v.max())
        if vmin == vmax:
            vmin -= self.EPSILON
            vmax += self.EPSILON
        if self.bin_edges is None:
            self.bin_edges = np.linspace(vmin, vmax, self.n_bins + 1)
        else:
            while vmin < self.bin_edges[0]:
                self._double(left=True)
            while vmax > self.bin_edges[-1]:
                self._double(left=False)
        self.counts += np.histogram(v, bins=self.bin_edges)[0]

    def _double(self, left: bool):
        span = 2 * (self.bin_edges[-1] - self.bin_edges[0])
        merged = self.counts[::2] + self.counts[1::2]
        new_counts = np.zeros(self.n_bins, np.int64)
        if left:
            self.bin_edges = np.linspace(
                self.bin_edges[-1] - span, self.bin_edges[-1], self.n_bins + 1
            )
            new_counts[self.n_bins // 2:] = merged
        else:
            self.bin_edges = np.linspace(
                self.bin_edges[0], self.bin_edges[0] + span, self.n_bins + 1
            )
            new_counts[: self.n_bins // 2] = merged
        self.counts = new_counts


class HistogramWriter:
    """Running per-variable histograms of the predictions, whose bins
    rescale rather than drop an out-of-range value; ``save`` writes
    ``{name}_counts`` (int64) and ``{name}_edges`` (float64), and ``close``
    saves to ``path`` where one is given."""

    def __init__(self, names: Sequence[str], n_bins: int = 300, path: Optional[str] = None):
        self.names = list(names)
        self.n_bins = n_bins
        self.path = path
        self._hists: Dict[str, DynamicHistogram] = {}

    def append(self, preds: np.ndarray, targets=None):
        preds = np.asarray(preds)
        for i, n in enumerate(self.names):
            if n not in self._hists:
                self._hists[n] = DynamicHistogram(self.n_bins)
            self._hists[n].add(preds[..., i])

    def histogram(self, name: str):
        h = self._hists[name]
        return h.counts, h.bin_edges

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with Writer(path) as f:
            for n in self.names:
                if n in self._hists:
                    c, e = self.histogram(n)
                    f.write(f"{n}_counts", c)
                    f.write(f"{n}_edges", e)

    def close(self):
        if self.path is not None:
            self.save(self.path)

    def abort(self):
        """Nothing is on disk before ``close``."""


class VideoWriter:
    """Writes the ``VideoAggregator``'s running (time, lat, lon)
    statistics of the rollout as ``{key}-{name}`` datasets with
    ``long_name``, ``units`` and ``dims`` attributes, at ``close``."""

    def __init__(self, path: str, names: Sequence[str], lat: np.ndarray, lon: np.ndarray):
        from ..evaluation.video import VideoAggregator

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.names = list(names)
        self.lat = np.asarray(lat)
        self.lon = np.asarray(lon)
        self.agg = VideoAggregator(self.names)
        self._t = 0

    def append(self, preds: np.ndarray, targets: Optional[np.ndarray] = None):
        """preds: (E, T, H, W, C); targets: (T, H, W, C) (optional: without
        them only the generated-ensemble statistics are recorded)."""
        preds = np.asarray(preds)
        self.agg.record_batch(preds, targets, start_step=self._t)
        self._t += preds.shape[1]

    def close(self):
        with Writer(self.path) as f:
            f.write("lat", self.lat)
            f.write("lon", self.lon)
            for key, video in self.agg.get_videos().items():
                for i, n in enumerate(self.names):
                    ln, u = variable_metadata(n)
                    attrs = {"long_name": f"{key} of {ln}", **({"units": u} if u else {}),
                             "dims": "time,lat,lon"}
                    f.write(f"{key}-{n}", video[..., i], attrs)

    def abort(self):
        """Nothing is on disk before ``close``."""


class TimeCoarsen:
    """Wraps a writer, averaging every ``factor`` consecutive steps; targets
    (time-leading rank-4 arrays) are coarsened on the same boundaries as
    the predictions. The steps left over from a window are copied and
    carried into the next."""

    def __init__(self, writer, factor: int):
        self.writer = writer
        self.factor = factor
        self._buffer = None
        self._tbuffer = None

    def append(self, preds: np.ndarray, targets: Optional[np.ndarray] = None):
        preds = np.asarray(preds)
        if self._buffer is not None:
            preds = np.concatenate([self._buffer, preds], axis=1)
            self._buffer = None
        if targets is not None:
            targets = np.asarray(targets)
            if self._tbuffer is not None:
                targets = np.concatenate([self._tbuffer, targets], axis=0)
                self._tbuffer = None
        T = preds.shape[1]
        n_full = T // self.factor
        rem = T - n_full * self.factor
        if rem:
            self._buffer = preds[:, T - rem:].copy()
            preds = preds[:, : T - rem]
            if targets is not None:
                self._tbuffer = targets[T - rem:].copy()
                targets = targets[: T - rem]
        if n_full:
            E = preds.shape[0]
            coarse = preds.reshape((E, n_full, self.factor) + preds.shape[2:]).mean(axis=2)
            ct = None
            if targets is not None:
                ct = targets.reshape((n_full, self.factor) + targets.shape[1:]).mean(axis=1)
            self.writer.append(coarse, ct)

    def close(self):
        self.writer.close()

    def abort(self):
        self.writer.abort()


@dataclasses.dataclass
class DataWriterConfig:
    """The ``data_writer`` options of the inference command lines."""

    save_prediction_files: bool = False
    save_histogram_files: bool = False
    log_extended_video_netcdfs: bool = False
    save_raw_prediction_names: Optional[Sequence[str]] = None
    time_coarsen_factor: Optional[int] = None

    def __post_init__(self):
        if self.save_raw_prediction_names is not None and not self.save_prediction_files:
            raise ValueError(
                "save_raw_prediction_names provided but save_prediction_files is False"
            )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "DataWriterConfig":
        """A config's ``data_writer`` block, as the JAX command lines read
        it."""
        d = d or {}
        return cls(save_prediction_files=bool(d.get("save_prediction_files", False)),
                   save_histogram_files=bool(d.get("save_histogram_files", False)),
                   log_extended_video_netcdfs=bool(d.get("log_extended_video_netcdfs", False)),
                   save_raw_prediction_names=d.get("save_raw_prediction_names"),
                   time_coarsen_factor=d.get("time_coarsen_factor"))


class DataWriter:
    """The configured writers, each optionally time-coarsened:
    ``autoregressive_predictions.nc`` (predictions),
    ``reduced_autoregressive_predictions.nc`` (videos) and
    ``histograms.nc`` in ``out_dir``.

    Used as a context manager, it closes every writer when the block ends
    and aborts them when it raises, so a rollout that fails leaves no
    temporary file and no file that looks whole."""

    def __init__(self, cfg: DataWriterConfig, out_dir: str, names, lat, lon,
                 n_ensemble: int = 1):
        self.writers = []

        def _coarsened(w):
            return TimeCoarsen(w, cfg.time_coarsen_factor) if cfg.time_coarsen_factor else w

        if cfg.save_prediction_files:
            self.writers.append(_coarsened(PredictionWriter(
                os.path.join(out_dir, "autoregressive_predictions.nc"),
                names, lat, lon, n_ensemble,
                save_names=cfg.save_raw_prediction_names,
            )))
        if cfg.log_extended_video_netcdfs:
            self.writers.append(_coarsened(VideoWriter(
                os.path.join(out_dir, "reduced_autoregressive_predictions.nc"),
                names, lat, lon,
            )))
        if cfg.save_histogram_files:
            self.writers.append(HistogramWriter(names,
                                                path=os.path.join(out_dir, "histograms.nc")))

    def append(self, preds, targets=None):
        for w in self.writers:
            w.append(preds, targets)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()

    def close(self):
        """Closes each writer in turn; if one fails, the writers after it
        are aborted and the error raised (a failed close removes its own
        temporary file)."""
        for i, w in enumerate(self.writers):
            try:
                w.close()
            except BaseException:
                for rest in self.writers[i + 1:]:
                    rest.abort()
                raise

    def abort(self):
        """Aborts every writer: each removes what it has written so far."""
        for w in self.writers:
            w.abort()
