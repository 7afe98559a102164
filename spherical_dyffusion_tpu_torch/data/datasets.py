"""Time-series sources of named (T, H, W) fields, and the windowed dataset
over them, on the host in numpy.

Counterpart of ``spherical_dyffusion_tpu/data/datasets.py`` (a copy: that
module imports the JAX package): ``TimeSeriesSource``, ``NetCDFTimeSeries``
(a directory of netCDF files read through ``data/netcdf.py``, windows
crossing file boundaries), ``SyntheticTimeSeries`` (the source the product
rollout and the training slice read), ``StochasticModalTimeSeries`` and
``ChaoticModalTimeSeries`` (the skill-study systems) and ``ConcatSource``
(ensemble members, which a window never crosses). The same numpy
generators from the same seeds give the same float32 arrays;
``tests/test_torch_port_inference.py`` and ``tests/test_torch_port_data.py``
pin the copies to the originals. ``WindowedDataset`` maps a sample index to
its window of packed frames through the native packer
(``utils/native.py``), as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import native
from .coords import HorizontalCoordinates, SigmaCoordinates
from .netcdf import NetCDFFile

__all__ = ["TimeSeriesSource", "NetCDFTimeSeries", "SyntheticTimeSeries",
           "StochasticModalTimeSeries", "ChaoticModalTimeSeries", "ConcatSource",
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


class NetCDFTimeSeries(TimeSeriesSource):
    """Multi-file netCDF time series with a cumulative timestep index:
    windows may cross file boundaries.

    Files are the sorted ``*.nc`` members of ``path`` (or a single file).
    Variables with a leading time dimension (3-D) are time-dependent; 2-D
    ones are broadcast over a window's steps. Each file stays open once
    read; every read is an ``os.pread``.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "*.nc")))
        else:
            self.files = [path]
        if not self.files:
            raise FileNotFoundError(f"No .nc files under {path}")
        self._handles: Dict[int, NetCDFFile] = {}
        counts = []
        f0 = self._file(0)
        # the spatial dims from a 3-D variable
        self._time_dependent: Dict[str, bool] = {}
        spatial = None
        for name in f0.variables:
            shp = f0.shape(name)
            if len(shp) == 3:
                spatial = shp[1:]
                self._time_dependent[name] = True
            elif len(shp) == 2:
                self._time_dependent[name] = False
        if spatial is None:
            raise ValueError(f"No (time, lat, lon) variables found in {self.files[0]}")
        self.spatial_shape = spatial
        for i in range(len(self.files)):
            f = self._file(i)
            n = None
            for name, td in self._time_dependent.items():
                if td and name in f.variables:
                    n = f.shape(name)[0]
                    break
            counts.append(n or 0)
        self._counts = np.asarray(counts)
        self._starts = np.concatenate([[0], np.cumsum(self._counts)])
        self.n_timesteps = int(self._starts[-1])

    def _file(self, i: int) -> NetCDFFile:
        if i not in self._handles:
            self._handles[i] = NetCDFFile(self.files[i])
        return self._handles[i]

    def close(self) -> None:
        for f in self._handles.values():
            f.close()
        self._handles.clear()

    @property
    def horizontal(self) -> HorizontalCoordinates:
        f = self._file(0)
        lat = lon = None
        for cand in ("lat", "grid_yt", "latitude"):
            if cand in f.variables:
                lat = np.asarray(f.read(cand))
                break
        for cand in ("lon", "grid_xt", "longitude"):
            if cand in f.variables:
                lon = np.asarray(f.read(cand))
                break
        if lat is None or lon is None:
            return HorizontalCoordinates.regular(*self.spatial_shape)
        return HorizontalCoordinates(lat, lon)

    @property
    def sigma(self) -> Optional[SigmaCoordinates]:
        f = self._file(0)
        aks = sorted([v for v in f.variables if v.startswith("ak_")],
                     key=lambda s: int(s.split("_")[1]))
        bks = sorted([v for v in f.variables if v.startswith("bk_")],
                     key=lambda s: int(s.split("_")[1]))
        if aks and bks:
            ak = np.asarray([float(f.read(v)) for v in aks])
            bk = np.asarray([float(f.read(v)) for v in bks])
            return SigmaCoordinates(ak, bk)
        if "ak" in f.variables and "bk" in f.variables:
            return SigmaCoordinates(np.asarray(f.read("ak")), np.asarray(f.read("bk")))
        return None

    def read_window(self, start: int, length: int, names: Sequence[str]) -> Dict[str, np.ndarray]:
        out = {n: [] for n in names}
        remaining = length
        t = start
        while remaining > 0:
            fi = int(np.searchsorted(self._starts, t, side="right") - 1)
            local = t - int(self._starts[fi])
            take = min(remaining, int(self._counts[fi]) - local)
            f = self._file(fi)
            for n in names:
                if self._time_dependent.get(n, True):
                    out[n].append(np.asarray(f.read(n, slice(local, local + take))))
                else:
                    arr = np.asarray(f.read(n))
                    out[n].append(np.broadcast_to(arr, (take,) + arr.shape))
            t += take
            remaining -= take
        return {n: np.concatenate(v, axis=0) if len(v) > 1 else v[0] for n, v in out.items()}


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
        self.ou_rho = float(rho)
        self.ou_sigma = float(sigma)
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

    def conditional_forecast_std(self, h: int) -> float:
        """The stationary per-mode std of a(t + h) given a(t),
        ``sigma sqrt(1 - rho^(2h))``: the irreducible spread that a
        calibrated h-step ensemble should match."""
        return self.ou_sigma * float(np.sqrt(1.0 - self.ou_rho ** (2 * h)))


class ChaoticModalTimeSeries(TimeSeriesSource):
    """Chaotic spherical dynamics for skill studies: the spatial
    decomposition of ``StochasticModalTimeSeries`` (a solid-body-rotating
    base field plus modal coefficients over fixed spatial modes) with
    coefficients that follow Lorenz-96,

        da_k/dt = (a_{k+1} - a_{k-2}) a_{k-1} - a_k + F,   F = 8,

    whose leading Lyapunov exponent is positive: perturbations grow
    (``empirical_growth_factor``). ``dt`` is the model time per frame."""

    def __init__(self, names: Sequence[str], n_timesteps: int = 4096,
                 spatial_shape: tuple = (64, 128), seed: int = 0, omega_px: int = 2,
                 n_modes: int = 8, sigma: float = 0.35, dt: float = 0.1,
                 forcing: float = 8.0, noise_seed: Optional[int] = None):
        if n_modes < 4:
            raise ValueError("Lorenz-96 needs at least 4 modes")
        self.names = list(names)
        self.n_timesteps = int(n_timesteps)
        self.spatial_shape = tuple(spatial_shape)
        self.omega_px = int(omega_px)
        self.amp_sigma = float(sigma)
        self.dt = float(dt)
        self.forcing = float(forcing)
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
        # Lorenz-96 per variable: spin up onto the attractor, then record
        nrng = np.random.default_rng(noise_seed if noise_seed is not None else seed + 1000)
        s = self.forcing + 0.5 * nrng.standard_normal((V, K))
        s = self._integrate(s, 10.0)
        raw = np.empty((self.n_timesteps, V, K), np.float64)
        for t in range(self.n_timesteps):
            raw[t] = s
            s = self._integrate(s, self.dt)
        # standardized to about ``sigma`` (at F = 8: mean about 2.3, std 3.6)
        self._coef_mean = raw.mean(axis=(0, 2), keepdims=True)
        self._coef_std = raw.std(axis=(0, 2), keepdims=True) + 1e-8
        self._a = (self.amp_sigma * (raw - self._coef_mean) / self._coef_std).astype(np.float32)
        self._raw = raw

    def _l96_rhs(self, s: np.ndarray) -> np.ndarray:
        return (np.roll(s, -1, -1) - np.roll(s, 2, -1)) * np.roll(s, 1, -1) - s + self.forcing

    def _integrate(self, s: np.ndarray, total_t: float) -> np.ndarray:
        """RK4 in sub-steps of at most 0.01 model time."""
        n_sub = max(1, int(np.ceil(total_t / 0.01)))
        h = total_t / n_sub
        for _ in range(n_sub):
            k1 = self._l96_rhs(s)
            k2 = self._l96_rhs(s + 0.5 * h * k1)
            k3 = self._l96_rhs(s + 0.5 * h * k2)
            k4 = self._l96_rhs(s + h * k3)
            s = s + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return s

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

    def empirical_growth_factor(self, h: int, eps: float = 1e-5, n_probe: int = 16) -> float:
        """Mean h-step growth ||delta(h)|| / ||delta(0)|| of perturbed twins
        started from states on the recorded trajectory (> 1: the positive
        Lyapunov exponent)."""
        rng = np.random.default_rng(0)
        T = self.n_timesteps
        starts = np.linspace(0, max(1, T - h - 1), n_probe).astype(int)
        factors = []
        for t0 in starts:
            s0 = self._raw[t0]
            d0 = eps * rng.standard_normal(s0.shape)
            s_p = s0 + d0
            s_t = s0
            for _ in range(h):
                s_t = self._integrate(s_t, self.dt)
                s_p = self._integrate(s_p, self.dt)
            factors.append(float(np.linalg.norm(s_p - s_t) / np.linalg.norm(d0)))
        return float(np.mean(factors))


class ConcatSource(TimeSeriesSource):
    """Concatenated ensemble-member sources: a window never crosses a
    member's boundary."""

    def __init__(self, sources: List[TimeSeriesSource]):
        if not sources:
            raise ValueError("ConcatSource needs at least one source")
        self.sources = sources
        self.spatial_shape = sources[0].spatial_shape
        self.n_timesteps = sum(s.n_timesteps for s in sources)

    @property
    def horizontal(self):
        return self.sources[0].horizontal

    @property
    def sigma(self):
        return self.sources[0].sigma

    def member_bounds(self) -> List[tuple]:
        starts = np.cumsum([0] + [s.n_timesteps for s in self.sources])
        return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]

    def read_window(self, start: int, length: int, names: Sequence[str]) -> Dict[str, np.ndarray]:
        for (a, b), src in zip(self.member_bounds(), self.sources):
            if a <= start < b:
                if start + length > b:
                    raise IndexError("window crosses ensemble-member boundary")
                return src.read_window(start - a, length, names)
        raise IndexError(start)


def pack_normalize(arrays: Sequence[np.ndarray], means: Optional[np.ndarray] = None,
                   stds: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-variable (T, H, W) arrays -> channels-last (T, H, W, C) float32,
    z-scored per channel as ``(x - mean) * (1 / std)`` when ``means`` and
    ``stds`` are given: the plain version of the native packer
    (``utils/native.py:pack_normalize``, which ``WindowedDataset`` runs),
    equal to it bit for bit."""
    out = np.stack([np.asarray(a, np.float32) for a in arrays], axis=-1)
    if means is not None:
        inv = np.float32(1.0) / np.asarray(stds, np.float32)
        out = (out - np.asarray(means, np.float32)) * inv
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
        if isinstance(self.source, ConcatSource):
            return sum(max(0, (b - a - total) // self.stride + 1)
                       for a, b in self.source.member_bounds())
        return max(0, (self.source.n_timesteps - total) // self.stride + 1)

    def _start_index(self, i: int) -> int:
        """The first frame of sample ``i``; over a ``ConcatSource``, the
        samples of each member in turn."""
        total = self.window + self.horizon
        if isinstance(self.source, ConcatSource):
            for a, b in self.source.member_bounds():
                m = max(0, (b - a - total) // self.stride + 1)
                if i < m:
                    return a + i * self.stride
                i -= m
            raise IndexError(i)
        return i * self.stride

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        start = self._start_index(i)
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
        out = {"dynamics": native.pack_normalize([raw[n] for n in self.in_names])}
        if random_timestep is not None:
            out["random_timestep"] = np.int64(random_timestep)
        if self.forcing_names:
            fn = self.forcing_normalizer
            out["dynamical_condition"] = native.pack_normalize(
                [raw[n] for n in self.forcing_names],
                means=fn.means.numpy() if fn is not None else None,
                stds=fn.stds.numpy() if fn is not None else None)
        return out
