"""Host-side data plumbing: batch iteration over windowed datasets.

Counterpart of ``spherical_dyffusion_tpu/data/datamodule.py``: ``prefetched``
(copied: that module imports the JAX package's netCDF sources),
``batch_iterator``, ``DataModuleConfig``, ``BaseDataModule``,
``normalizer_for``, ``FV3GFSDataModule`` (the production datamodule over
netCDF directories), ``StochasticDataModule`` (the skill-study systems) and
``DebugDataModule``. Batches are stacked with numpy, as in the JAX package;
``train_batches`` and ``val_batches`` hand them on as torch tensors, pinned
when there is a card, so that ``utils/device.py:to_device`` uploads them
without waiting for it; the stacking and pinning run on the prefetch thread.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from .coords import GridMetadata
from .datasets import (
    ChaoticModalTimeSeries,
    ConcatSource,
    NetCDFTimeSeries,
    StochasticModalTimeSeries,
    SyntheticTimeSeries,
    TimeSeriesSource,
    WindowedDataset,
)
from .normalization import StandardNormalizer, get_normalizer
from .packer import Packer

__all__ = ["prefetched", "batch_iterator", "DataModuleConfig", "BaseDataModule",
           "normalizer_for", "FV3GFSDataModule", "StochasticDataModule", "DebugDataModule"]


def prefetched(iterable: Iterable, depth: int = 2) -> Iterator:
    """Background-thread prefetch with a bounded queue (double buffering at
    ``depth=2``): one producer thread runs the underlying iterator while the
    consumer works, so every source read happens on that one thread.
    Exceptions re-raise at the consumer. ``depth <= 0`` disables it."""
    if depth <= 0:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    errbox: list = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            errbox.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True, name="data-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if errbox:
                raise errbox[0]
            return
        yield item


def batch_iterator(dataset: WindowedDataset, batch_size: int, shuffle: bool = False,
                   seed: int = 0, drop_last: bool = True,
                   max_samples: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Stacks samples along a new batch axis; with ``shuffle``, in the order
    of numpy's generator seeded with ``seed``."""
    n = len(dataset)
    if max_samples is not None:
        n = min(n, max_samples)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        chunk = [dataset[int(j)] for j in idx[i:i + batch_size]]
        yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}


def _host_tensors(batches: Iterable[Dict[str, np.ndarray]]) -> Iterator[Dict[str, torch.Tensor]]:
    pin = torch.cuda.is_available()
    for batch in batches:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        yield {k: v.pin_memory() for k, v in out.items()} if pin else out


@dataclasses.dataclass(frozen=True)
class DataModuleConfig:
    """The JAX package's datamodule settings, same names and defaults."""

    in_names: Sequence[str]
    out_names: Sequence[str]
    forcing_names: Sequence[str] = ()
    data_dir: Optional[str] = None
    data_dir_stats: Optional[str] = None
    horizon: int = 6
    window: int = 1
    prediction_horizon: int = 504
    prediction_horizon_long: int = 1464
    batch_size: int = 1
    eval_batch_size: int = 1
    max_train_samples: Optional[int] = None
    max_val_samples: Optional[int] = 80
    training_sub_paths: Optional[Sequence[str]] = None
    debug_mode: bool = False
    prefetch_depth: int = 2


class BaseDataModule:
    """Normalizer, packers and split horizons (train: ``horizon``; val:
    ``prediction_horizon``; test: ``prediction_horizon_long``)."""

    def __init__(self, cfg: DataModuleConfig, normalizer: StandardNormalizer):
        self.cfg = cfg
        self.normalizer = normalizer
        self.in_packer = Packer(cfg.in_names)
        self.out_packer = Packer(cfg.out_names)
        self.forcing_packer = Packer(cfg.forcing_names) if cfg.forcing_names else None
        self.forcing_normalizer = (
            normalizer_for(cfg.forcing_names, normalizer)
            if cfg.forcing_names and all(n in normalizer.names for n in cfg.forcing_names)
            else None)

    def horizon_for_split(self, split: str) -> int:
        if split == "train":
            return self.cfg.horizon
        if split in ("val", "validation"):
            return self.cfg.prediction_horizon or self.cfg.horizon
        return self.cfg.prediction_horizon_long or self.cfg.horizon

    def _source(self, split: str) -> TimeSeriesSource:
        raise NotImplementedError

    def dataset(self, split: str, horizon: Optional[int] = None) -> WindowedDataset:
        return WindowedDataset(
            source=self._source(split), in_names=self.cfg.in_names,
            horizon=horizon if horizon is not None else self.horizon_for_split(split),
            window=self.cfg.window, forcing_names=self.cfg.forcing_names,
            forcing_normalizer=self.forcing_normalizer)

    def train_batches(self, seed: int = 0, horizon: Optional[int] = None):
        """Shuffled training batches of torch host tensors (pinned when
        there is a card), made on the prefetch thread."""
        return prefetched(_host_tensors(batch_iterator(
            self.dataset("train", horizon), self.cfg.batch_size, shuffle=True, seed=seed,
            max_samples=self.cfg.max_train_samples)), depth=self.cfg.prefetch_depth)

    def val_batches(self, horizon: Optional[int] = None):
        return prefetched(_host_tensors(batch_iterator(
            self.dataset("val", horizon), self.cfg.eval_batch_size, shuffle=False,
            drop_last=False, max_samples=self.cfg.max_val_samples)),
            depth=self.cfg.prefetch_depth)

    @property
    def grid(self) -> GridMetadata:
        src = self._source("train")
        return GridMetadata(horizontal=src.horizontal, sigma=src.sigma)


def normalizer_for(names: Sequence[str], base: StandardNormalizer) -> StandardNormalizer:
    return base.subset(list(names))


class FV3GFSDataModule(BaseDataModule):
    """The production datamodule: statistics from ``centering.nc`` and
    ``scaling.nc`` in ``data_dir_stats`` (else ``data_dir``), training on
    the ensemble members ``ic_*`` under ``data_dir`` (or
    ``training_sub_paths``; the first alone with ``debug_mode``; the
    directory itself when it has none), validation on the held-out member
    ``validation/ic_0011`` (else ``data_dir``)."""

    def __init__(self, cfg: DataModuleConfig):
        stats_dir = cfg.data_dir_stats or cfg.data_dir
        all_names = list(dict.fromkeys(list(cfg.in_names) + list(cfg.forcing_names)))
        self._full_normalizer = get_normalizer(os.path.join(stats_dir, "centering.nc"),
                                               os.path.join(stats_dir, "scaling.nc"), all_names)
        super().__init__(cfg, self._full_normalizer.subset(list(cfg.in_names)))
        if cfg.forcing_names:
            self.forcing_normalizer = self._full_normalizer.subset(list(cfg.forcing_names))

    def _source(self, split: str) -> TimeSeriesSource:
        root = self.cfg.data_dir
        if split == "train":
            subs = self.cfg.training_sub_paths
            if subs is None:
                subs = sorted(d for d in os.listdir(root)
                              if d.startswith("ic_") and os.path.isdir(os.path.join(root, d)))
            if self.cfg.debug_mode:
                subs = subs[:1]
            if not subs:
                return NetCDFTimeSeries(root)
            return ConcatSource([NetCDFTimeSeries(os.path.join(root, s)) for s in subs])
        val_dir = os.path.join(root, "validation", "ic_0011")
        if not os.path.isdir(val_dir):
            val_dir = root
        return NetCDFTimeSeries(val_dir)


class StochasticDataModule(BaseDataModule):
    """A datamodule over the skill-study systems: ``system`` "ou"
    (``StochasticModalTimeSeries``: decaying perturbations) or "chaotic"
    (``ChaoticModalTimeSeries``: growing ones). Train and val share the
    structure seed and draw independent trajectories (noise seeds seed + 1
    and seed + 2); the statistics are those of the first (up to) 64
    training frames."""

    def __init__(self, channels: int = 2, height: int = 64, width: int = 128,
                 horizon: int = 6, window: int = 1, n_timesteps: int = 4096,
                 n_val_timesteps: int = 1024, batch_size: int = 8, seed: int = 0,
                 omega_px: int = 2, n_modes: int = 8, rho: float = 0.9, sigma: float = 0.35,
                 system: str = "ou", dt: float = 0.1, **cfg_kwargs):
        in_names = [f"var_{i}" for i in range(channels)]
        cfg = DataModuleConfig(
            in_names=in_names, out_names=in_names, horizon=horizon, window=window,
            batch_size=batch_size,
            prediction_horizon=cfg_kwargs.pop("prediction_horizon", horizon),
            prediction_horizon_long=cfg_kwargs.pop("prediction_horizon_long", horizon),
            **cfg_kwargs)
        common = dict(spatial_shape=(height, width), seed=seed, omega_px=omega_px,
                      n_modes=n_modes, sigma=sigma)
        if system == "chaotic":
            src_cls = ChaoticModalTimeSeries
            common["dt"] = dt
        elif system == "ou":
            src_cls = StochasticModalTimeSeries
            common["rho"] = rho
        else:
            raise ValueError(f"Unknown system {system!r}")
        self._train_src = src_cls(in_names, n_timesteps=n_timesteps, noise_seed=seed + 1,
                                  **common)
        self._val_src = src_cls(in_names, n_timesteps=n_val_timesteps, noise_seed=seed + 2,
                                **common)
        sample = self._train_src.read_window(0, min(64, n_timesteps), in_names)
        means = {n: float(np.mean(v)) for n, v in sample.items()}
        stds = {n: float(np.std(v) + 1e-6) for n, v in sample.items()}
        super().__init__(cfg, StandardNormalizer.from_dicts(means, stds, in_names))

    def _source(self, split: str) -> TimeSeriesSource:
        return self._train_src if split == "train" else self._val_src


class DebugDataModule(BaseDataModule):
    """Synthetic datamodule: ``channels`` state variables ``var_i`` and
    ``n_forcing`` forcings ``forcing_i`` from one ``SyntheticTimeSeries``,
    normalized with statistics of its first (up to) 32 frames."""

    def __init__(self, channels: int = 4, height: int = 16, width: int = 32, horizon: int = 6,
                 window: int = 1, n_timesteps: int = 96, n_forcing: int = 0,
                 batch_size: int = 2, seed: int = 0, **cfg_kwargs):
        in_names = [f"var_{i}" for i in range(channels)]
        forcing_names = [f"forcing_{i}" for i in range(n_forcing)]
        cfg = DataModuleConfig(
            in_names=in_names, out_names=in_names, forcing_names=forcing_names,
            horizon=horizon, window=window, batch_size=batch_size,
            prediction_horizon=cfg_kwargs.pop("prediction_horizon", horizon),
            prediction_horizon_long=cfg_kwargs.pop("prediction_horizon_long", horizon),
            **cfg_kwargs)
        names = in_names + forcing_names
        self._src = SyntheticTimeSeries(names, n_timesteps=n_timesteps,
                                        spatial_shape=(height, width), seed=seed)
        sample = self._src.read_window(0, min(32, n_timesteps), names)
        means = {n: float(np.mean(v)) for n, v in sample.items()}
        stds = {n: float(np.std(v) + 1e-6) for n, v in sample.items()}
        super().__init__(cfg, StandardNormalizer.from_dicts(means, stds, in_names))
        if forcing_names:
            self.forcing_normalizer = StandardNormalizer.from_dicts(means, stds, forcing_names)

    def _source(self, split: str) -> TimeSeriesSource:
        return self._src
