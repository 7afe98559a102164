"""Time-series sources of named (T, H, W) fields, and the windowed dataset
over them, on the host in numpy.

A copy of the generated sources of ``spherical_dyffusion_tpu/data/datasets.py``
(that module imports the JAX package's netCDF reader, so it is repeated here,
not imported): ``TimeSeriesSource``, ``SyntheticTimeSeries`` (the source the
product rollout and the training slice read) and
``StochasticModalTimeSeries`` (the skill-study system). The same numpy
generators from the same seeds give the same float32 arrays;
``tests/test_torch_port_inference.py`` pins the copy to the original.
``WindowedDataset`` maps a sample index to its window of packed frames, as
the JAX package's does with its numpy packing. ``NetCDFTimeSeries`` and
``ConcatSource`` (several ensemble members) are not ported: the reader needs
h5py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .coords import HorizontalCoordinates, SigmaCoordinates

__all__ = ["TimeSeriesSource", "SyntheticTimeSeries", "StochasticModalTimeSeries",
           "WindowedDataset", "pack_normalize"]


class TimeSeriesSource:
    """Abstract source of named (T, H, W) fields."""

    n_timesteps: int
    spatial_shape: tuple

    def read_window(self, start: int, length: int, names: Sequence[str]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @property
    def horizontal(self) -> HorizontalCoordinates:
        raise NotImplementedError

    @property
    def sigma(self) -> Optional[SigmaCoordinates]:
        return None


class SyntheticTimeSeries(TimeSeriesSource):
    """Deterministic synthetic fields for smoke and benchmark runs: a few
    random low-frequency spatial modes per variable with slow temporal
    rotation, so the dynamics are smooth and band-limited."""

    def __init__(self, names: Sequence[str], n_timesteps: int = 96,
                 spatial_shape: tuple = (180, 360), seed: int = 0):
        self.names = list(names)
        self.n_timesteps = n_timesteps
        self.spatial_shape = tuple(spatial_shape)
        self.seed = seed
        H, W = self.spatial_shape
        rng = np.random.default_rng(seed)
        self._phases = rng.uniform(0, 2 * np.pi, (len(self.names), 4))
        self._freqs = rng.uniform(0.02, 0.1, (len(self.names), 4))
        ky = rng.integers(1, 4, (len(self.names), 4))
        kx = rng.integers(1, 4, (len(self.names), 4))
        yy = np.linspace(0, 2 * np.pi, H, endpoint=False)[:, None]
        xx = np.linspace(0, 2 * np.pi, W, endpoint=False)[None, :]
        self._modes = np.stack([
            np.stack([np.sin(ky[v, i] * yy + kx[v, i] * xx) for i in range(4)])
            for v in range(len(self.names))
        ])  # (V, 4, H, W)

    @property
    def horizontal(self) -> HorizontalCoordinates:
        return HorizontalCoordinates.regular(*self.spatial_shape)

    @property
    def sigma(self) -> Optional[SigmaCoordinates]:
        k = 8
        return SigmaCoordinates(ak=np.linspace(0.0, 0.0, k + 1), bk=np.linspace(0.0, 1.0, k + 1))

    def read_window(self, start: int, length: int, names: Sequence[str]) -> Dict[str, np.ndarray]:
        t = np.arange(start, start + length)[:, None]
        out = {}
        for n in names:
            v = self.names.index(n)
            coef = np.cos(self._freqs[v][None, :] * t + self._phases[v][None, :])  # (T, 4)
            field = np.einsum("tk,khw->thw", coef, self._modes[v])
            out[n] = field.astype(np.float32)
        return out


class StochasticModalTimeSeries(TimeSeriesSource):
    """Stochastic spherical dynamics for skill studies: each variable is a
    solid-body rotation of a smooth base field plus an Ornstein-Uhlenbeck
    modal process,

        x_v(t) = roll_lon(base_v, omega * t) + sum_k a_{v,k}(t) m_{v,k}
        a(t+1) = rho a(t) + sigma sqrt(1 - rho^2) eps,   eps ~ N(0, 1).

    ``seed`` fixes the structure (base fields, modes) shared by the splits;
    ``noise_seed`` picks the OU realization."""

    def __init__(self, names: Sequence[str], n_timesteps: int = 4096,
                 spatial_shape: tuple = (64, 128), seed: int = 0, omega_px: int = 2,
                 n_modes: int = 8, rho: float = 0.9, sigma: float = 0.35,
                 noise_seed: Optional[int] = None):
        self.names = list(names)
        self.n_timesteps = int(n_timesteps)
        self.spatial_shape = tuple(spatial_shape)
        self.omega_px = int(omega_px)
        H, W = self.spatial_shape
        V, K = len(self.names), int(n_modes)
        rng = np.random.default_rng(seed)
        yy = np.linspace(0, np.pi, H, endpoint=False)[:, None]
        xx = np.linspace(0, 2 * np.pi, W, endpoint=False)[None, :]
        base = np.zeros((V, H, W), np.float32)
        for v in range(V):
            for _ in range(6):
                ky, kx = rng.integers(1, 5), rng.integers(1, 5)
                ph = rng.uniform(0, 2 * np.pi, 2)
                base[v] += rng.normal(0, 0.5) * (
                    np.sin(ky * yy + ph[0]) * np.cos(kx * xx + ph[1])).astype(np.float32)
        self._base = base
        modes = np.zeros((V, K, H, W), np.float32)
        for v in range(V):
            for k in range(K):
                ky, kx = rng.integers(1, 6), rng.integers(1, 6)
                ph = rng.uniform(0, 2 * np.pi, 2)
                modes[v, k] = (np.sin(ky * yy + ph[0]) * np.sin(kx * xx + ph[1])).astype(np.float32)
                modes[v, k] /= np.sqrt(np.mean(modes[v, k] ** 2) + 1e-8)
        self._modes = modes
        # the full OU coefficient trajectory, from a stationary start
        nrng = np.random.default_rng(noise_seed if noise_seed is not None else seed + 1000)
        a = np.zeros((self.n_timesteps, V, K), np.float32)
        a[0] = sigma * nrng.standard_normal((V, K))
        innov = sigma * np.sqrt(1 - rho ** 2) * nrng.standard_normal((self.n_timesteps - 1, V, K))
        for t in range(1, self.n_timesteps):
            a[t] = rho * a[t - 1] + innov[t - 1]
        self._a = a

    @property
    def horizontal(self) -> HorizontalCoordinates:
        return HorizontalCoordinates.regular(*self.spatial_shape)

    def read_window(self, start: int, length: int, names: Sequence[str]) -> Dict[str, np.ndarray]:
        out = {}
        t_idx = np.arange(start, start + length)
        for n in names:
            v = self.names.index(n)
            frames = np.empty((length,) + self.spatial_shape, np.float32)
            for i, t in enumerate(t_idx):
                det = np.roll(self._base[v], (self.omega_px * int(t)) % self.spatial_shape[1],
                              axis=1)
                frames[i] = det + np.einsum("k,khw->hw", self._a[t, v], self._modes[v])
            out[n] = frames
        return out


def pack_normalize(arrays: Sequence[np.ndarray], means: Optional[np.ndarray] = None,
                   stds: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-variable (T, H, W) arrays -> channels-last (T, H, W, C) float32,
    z-scored per channel when ``means`` and ``stds`` are given: the numpy
    form of the JAX package's ``utils/native.py:pack_normalize``."""
    out = np.stack([np.asarray(a, np.float32) for a in arrays], axis=-1)
    if means is not None:
        out = (out - np.asarray(means, np.float32)) / np.asarray(stds, np.float32)
    return out


@dataclasses.dataclass
class WindowedDataset:
    """Maps a sample index to ``window + horizon`` frames, packed channels
    last: ``{"dynamics": (T, H, W, C_in)`` raw, ``"dynamical_condition":
    (T, H, W, C_forcing)`` normalized (with ``forcing_names``)``}``.

    ``strategy``: "sequential" keeps every frame; "direct" the window frames
    and the last; "random" the window frames and one step t in [1, horizon];
    "interpolation" the window frames, a step t in [1, horizon - 1] and the
    last frame. The sparse strategies read only the frames they keep and
    return their draw as ``random_timestep``, from numpy's generator seeded
    with ``(seed, index)``."""

    source: TimeSeriesSource
    in_names: Sequence[str]
    horizon: int
    window: int = 1
    forcing_names: Sequence[str] = ()
    forcing_normalizer: Optional[object] = None  # StandardNormalizer of the forcings
    stride: int = 1
    strategy: str = "sequential"
    seed: int = 0

    def __len__(self) -> int:
        total = self.window + self.horizon
        return max(0, (self.source.n_timesteps - total) // self.stride + 1)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        start = i * self.stride
        total = self.window + self.horizon
        names = list(self.in_names) + [n for n in self.forcing_names if n not in self.in_names]
        random_timestep = None
        if self.strategy in ("sequential", "direct"):
            raw = self.source.read_window(start, total, names)
            if self.strategy == "direct":
                keep = list(range(self.window)) + [total - 1]
                raw = {k: v[keep] for k, v in raw.items()}
        elif self.strategy in ("random", "interpolation"):
            rng = np.random.default_rng((self.seed, i))
            hi = self.horizon + 1 if self.strategy == "random" else self.horizon
            random_timestep = int(rng.integers(1, hi))
            offsets = list(range(self.window)) + [self.window - 1 + random_timestep]
            if self.strategy == "interpolation":
                offsets.append(total - 1)
            chunks = [self.source.read_window(start + off, 1, names) for off in offsets]
            raw = {k: np.stack([c[k][0] for c in chunks]) for k in names}
        else:
            raise ValueError(f"Unknown strategy {self.strategy!r}")
        out = {"dynamics": pack_normalize([raw[n] for n in self.in_names])}
        if random_timestep is not None:
            out["random_timestep"] = np.int64(random_timestep)
        if self.forcing_names:
            fn = self.forcing_normalizer
            out["dynamical_condition"] = pack_normalize(
                [raw[n] for n in self.forcing_names],
                means=fn.means.numpy() if fn is not None else None,
                stds=fn.stds.numpy() if fn is not None else None)
        return out
