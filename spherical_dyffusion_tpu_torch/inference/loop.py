"""Autoregressive rollout loop: windows over a (possibly repeated) source.

Counterpart of ``spherical_dyffusion_tpu/inference/loop.py``
(``InferenceConfig``, ``InferenceWindows``, ``capped_window`` and
``run_inference``). The stepper returns each window's final state, which is
the next window's initial condition; the host reads forcing and target
windows, uploads them, and feeds the aggregator, which reduces on the card.

The host pipeline around the card:

* a producer thread (``data/datamodule.py:prefetched``) reads window k+1
  from the source while window k runs, and stacks, casts and pins every row
  of it that the card does not already hold (targets, forcings, the
  prescribed target and the mask); all source reads stay on that thread;
* uploads run on the main thread, from pinned memory with
  ``non_blocking=True`` (``utils/device.py:to_device``): the copy is queued
  on the current stream, so it is ordered before every kernel that reads it
  and never races the compute stream, and the host does not wait for it, as
  it would for a copy from pageable memory; the caching host allocator keeps
  a pinned block until its copy has run;
* windows whose wrapped read offsets coincide (``n_repeats > 1``) carry the
  same data, so a host read cache and a device upload cache reuse them;
* the deferred drain: window k's predictions are denormalized on the card
  and handed to the aggregator only after window k+1 is launched, and the
  aggregator's reductions stay on the card, so with an aggregator alone the
  host never waits for the card inside the loop (without a consumer, each
  window ends with a synchronization, as the JAX loop blocks on the carried
  state);
* the host copies: with a writer, or the aggregator's video, each window's
  denormalized predictions are copied to the host once, queued behind the
  window into one of two reused pinned buffers (``utils/device.py:
  HostCopies``); the drain, once window k+1 is launched, waits on that
  copy's event (the loop's one wait on the card a window) and hands the
  host arrays to ``writer.append`` and the video with the window's float32
  target rows, which the producer thread keeps on the host for every
  window;
* the summary is end-synced: ``duration_s`` ends after
  ``torch.cuda.synchronize``, so it counts every step's completion on the
  card, not its launch.

Randomness: one host ``torch.Generator`` seeded from ``cfg.seed``; each
chunk of each window draws from it the seed of the generator its
``run_window`` call gets (``_next_window_generator``), where the JAX loop
splits its key. ``run_dataset_inference`` re-scores a predictions file (the
layout of the JAX package's ``PredictionWriter``) against a source, reading
it through ``data/hdf5.py``; the writers are ``inference/writers.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datamodule import prefetched
from ..data.datasets import TimeSeriesSource
from ..utils.device import HostCopies, to_device
from .stepper import DYffusionStepper

__all__ = ["InferenceConfig", "InferenceWindows", "capped_window", "run_inference",
           "UploadCache", "wrapped_pieces", "UPLOAD_CACHE_ENTRIES", "run_dataset_inference",
           "exp_forcing_normalizer"]

TARGET_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# windows of device buffers kept by the upload cache of either rollout
UPLOAD_CACHE_ENTRIES = 8


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """The JAX package's ``InferenceConfig`` less ``rng_impl``, which names a
    JAX PRNG implementation; the port's draws come from ``torch.Generator``s
    seeded from ``seed``. Rollouts start at ``start_index + ic_first + i *
    ic_interval`` for ``i < n_initial_conditions``; all initial conditions
    times ensemble members are the device batch, run in chunks of
    ``ensemble_in_memory`` rows."""

    n_forward_steps: int = 100
    forward_steps_in_memory: int = 50
    n_ensemble: int = 1
    ensemble_in_memory: Optional[int] = None
    n_repeats: int = 1  # loop the source for rollouts longer than the data
    start_index: int = 0
    n_initial_conditions: int = 1
    ic_first: int = 0
    ic_interval: int = 1
    seed: int = 0
    # distinct repeating windows whose device buffers (targets, and the
    # forcing, prescribed-target and mask rows) stay resident; an aligned
    # source (n_timesteps a multiple of the window) needs one of each
    upload_cache_entries: int = UPLOAD_CACHE_ENTRIES
    # windows of host arrays kept by the read cache when n_repeats > 1 (0:
    # off); read_window is a pure function of (start, length, names)
    host_read_cache_entries: int = 2
    # the resident-memory guard of capped_window; hbm_budget_gb is the JAX
    # package's default, kept so that both packages pick the same window
    auto_window_cap: bool = True
    hbm_budget_gb: float = 4.5
    # dtype of the uploaded target windows the aggregator reduces against;
    # "bfloat16" halves their upload and residency, and rounds the truth
    # values to bf16 (the aggregator upcasts to float32 on the card)
    targets_dtype: str = "float32"

    def __post_init__(self):
        if self.targets_dtype not in TARGET_DTYPES:
            raise ValueError(f"InferenceConfig.targets_dtype must be one of "
                             f"{sorted(TARGET_DTYPES)}, got {self.targets_dtype!r}")

    @property
    def start_indices(self) -> Tuple[int, ...]:
        return tuple(self.start_index + self.ic_first + i * self.ic_interval
                     for i in range(self.n_initial_conditions))


class InferenceWindows:
    """Yields consecutive (start_step, window dict) covering the rollout:
    window k holds frames [k*T, k*T + T] (T = forward_steps_in_memory), read
    with wrap-around over the source when n_repeats > 1."""

    def __init__(self, source: TimeSeriesSource, names: Sequence[str], cfg: InferenceConfig):
        self.source = source
        self.names = list(names)
        self.cfg = cfg
        self.start_indices = list(cfg.start_indices)
        self._read_cache: Dict[tuple, Dict[str, np.ndarray]] = {}
        n_avail = source.n_timesteps * cfg.n_repeats - max(self.start_indices)
        if cfg.n_forward_steps + 1 > n_avail:
            raise ValueError(f"rollout needs {cfg.n_forward_steps + 1} frames, source has "
                             f"{n_avail} (n_repeats={cfg.n_repeats})")

    def _read(self, start: int, length: int,
              names: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Read with wrap-around across repeats of the source."""
        names = list(names) if names is not None else self.names
        pieces = [p for _, p in wrapped_pieces(self.source, start, length, names)]
        return {k: (np.concatenate([p[k] for p in pieces], axis=0) if len(pieces) > 1
                    else pieces[0][k]) for k in names}

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Yields (start_step, data): values (T+1, H, W) with one initial
        condition, (n_ic, T+1, H, W) with several, each read at its own
        offset."""
        cfg = self.cfg
        T = cfg.forward_steps_in_memory
        step = 0
        multi = len(self.start_indices) > 1
        n = self.source.n_timesteps
        cap = cfg.host_read_cache_entries if cfg.n_repeats > 1 else 0
        while step < cfg.n_forward_steps:
            length = min(T, cfg.n_forward_steps - step) + 1
            key = (tuple((s + step) % n for s in self.start_indices) + (length,)
                   if cap > 0 else None)
            data = self._read_cache.get(key) if key is not None else None
            if data is None:
                if not multi:
                    data = self._read(self.start_indices[0] + step, length)
                else:
                    per_ic = [self._read(s + step, length) for s in self.start_indices]
                    data = {k: np.stack([d[k] for d in per_ic]) for k in per_ic[0]}
                if key is not None and len(self._read_cache) < cap:
                    self._read_cache[key] = data
            yield step, data
            step += length - 1

    def iter_ranges(self) -> Iterator[Tuple[int, int]]:
        """(start_step, n_steps) pairs without reading any data."""
        return _ranges(self.cfg, self.cfg.forward_steps_in_memory)


def wrapped_pieces(source: TimeSeriesSource, start: int, length: int,
                   names: Sequence[str]) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """The frames [start, start + length) of ``source`` looped over its
    repeats, as (offset in the window, ``read_window``'s dict) pieces."""
    n = source.n_timesteps
    got = 0
    while got < length:
        local = (start + got) % n
        take = min(length - got, n - local)
        yield got, source.read_window(local, take, names)
        got += take


class UploadCache:
    """Device buffers of the windows that repeat, by key, up to ``cap`` of
    them; a buffer that does not fit is uploaded again at each repeat, and
    ``skips`` counts those uploads."""

    def __init__(self, cap: int = UPLOAD_CACHE_ENTRIES):
        self.cap = int(cap)
        self.entries: Dict[tuple, object] = {}
        self.skips = 0

    def __contains__(self, key) -> bool:
        return key in self.entries

    def get(self, key):
        return self.entries.get(key) if key is not None else None

    def put(self, key, value) -> None:
        if len(self.entries) < self.cap:
            self.entries[key] = value
        else:
            self.skips += 1


def _ranges(cfg: InferenceConfig, T: int) -> Iterator[Tuple[int, int]]:
    step = 0
    while step < cfg.n_forward_steps:
        n = min(T, cfg.n_forward_steps - step)
        yield step, n
        step += n


def _resident_target_windows(cfg: InferenceConfig, n_timesteps: int, T: int) -> int:
    """Target windows on the card at once at window T: without repeats the
    one being computed and the one awaiting its drain; with repeats each
    distinct wrapped window the upload cache keeps, plus two in flight when
    there are more than it keeps."""
    if cfg.n_repeats <= 1:
        return 2
    keys = {tuple((s + step) % n_timesteps for s in cfg.start_indices) + (n,)
            for step, n in _ranges(cfg, T)}
    kept = min(len(keys), cfg.upload_cache_entries)
    return kept + (2 if len(keys) > kept else 0)


def capped_window(cfg: InferenceConfig, n_rows: int, spatial, n_out: int, preds_itemsize: int,
                  horizon: int, target_rows: int = 0,
                  n_timesteps: Optional[int] = None, to_host: bool = False) -> int:
    """The window the rollout runs: ``forward_steps_in_memory``, or, when the
    resident-memory estimate exceeds ``cfg.hbm_budget_gb``, the largest
    multiple of ``horizon`` (at least ``horizon``) that fits. The window is
    a pure performance knob, so the cap does not change results;
    ``auto_window_cap=False`` turns it off.

    The estimate is the JAX package's, the emitted predictions (n_rows x T x
    H x W x n_out x preds_itemsize) held for 2.5 windows, plus what the JAX
    estimate leaves out: with an aggregator attached (``target_rows`` = the
    number of initial conditions, ``n_timesteps`` = the source's length) the
    uploaded target windows (target_rows x T x H x W x n_out in
    ``cfg.targets_dtype``) that are resident at once; with ``to_host`` (a
    writer or the video on) one more window of predictions, the
    channel-first copy that ``HostCopies.copy`` makes on the card while the
    window before is still held. Where neither term binds, the result is the
    JAX package's."""
    T_req = int(cfg.forward_steps_in_memory)
    if not cfg.auto_window_cap:
        return T_req
    Hs, Ws = spatial
    per_step = n_rows * Hs * Ws * n_out * preds_itemsize
    if per_step <= 0:
        return T_req
    budget = cfg.hbm_budget_gb * 1e9
    held = 2.5 + (1 if to_host else 0)  # windows of predictions
    max_T = int(budget / (held * per_step))
    max_T = max(horizon, (max_T // horizon) * horizon)
    T = min(T_req, max_T)
    if target_rows > 0:
        tgt_step = target_rows * Hs * Ws * n_out * TARGET_DTYPES[cfg.targets_dtype].itemsize

        def fits(t):
            windows = _resident_target_windows(cfg, n_timesteps, t)
            return held * per_step * t + windows * tgt_step * t <= budget

        while T > horizon and not fits(T):
            T = max(horizon, ((T - 1) // horizon) * horizon)
    return T


def _next_window_generator(rng: torch.Generator) -> torch.Generator:
    """The generator of one ``run_window`` call, seeded by a draw from the
    rollout's host generator."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    return torch.Generator().manual_seed(seed)


def _denorm_cast(x: torch.Tensor, stds: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """Denormalize in the emitted dtype: float32 statistics would promote
    bf16 predictions back to float32."""
    return (x * stds + means).to(x.dtype)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_inference(stepper: DYffusionStepper, source: TimeSeriesSource, cfg: InferenceConfig,
                  aggregator=None, writer=None, mask_name: Optional[str] = None,
                  verbose: bool = True) -> Dict[str, float]:
    """Run the rollout on the device of the stepper's networks; returns the
    summary: steps, end-synced duration, total and steady steps per second
    (ensemble members and initial conditions counted), upload-cache skips and
    the ``time/*`` host splits (data loading, running the windows, the
    writer and the aggregator). ``writer`` (``inference/writers.py``'s
    ``DataWriter``, or None: nothing crosses to the host) gets each
    window's predictions (E, T, H, W, C) and float32 targets (T, H, W, C)
    on the host, one initial condition only, as in JAX."""
    exp = stepper.exp
    device = next(exp.model.parameters()).device
    in_names = list(exp.in_packer.names)
    out_names = list(exp.out_packer.names)
    forcing_names = list(getattr(exp, "forcing_names", ()))
    consume = aggregator is not None or writer is not None
    video = getattr(aggregator, "video", None) is not None
    to_host = writer is not None or video
    prescribed_name = getattr(stepper.prescriber, "prescribed_name", None)
    # read only what each window consumes; the full in_names only for the
    # initial condition
    needed = list(forcing_names)
    if mask_name:
        needed.append(mask_name)
    if prescribed_name:
        needed.append(prescribed_name)
    if consume:
        needed += out_names
    needed = list(dict.fromkeys(needed))
    n_ic = cfg.n_initial_conditions
    E = cfg.n_ensemble
    itemsize = stepper.preds_dtype.itemsize if stepper.preds_dtype is not None else 4
    T_eff = capped_window(cfg, n_ic * E, source.spatial_shape, len(out_names), itemsize,
                          stepper.horizon, target_rows=n_ic if aggregator is not None else 0,
                          n_timesteps=source.n_timesteps, to_host=to_host)
    if T_eff < cfg.forward_steps_in_memory:
        if verbose:
            print(f"[rollout] forward_steps_in_memory {cfg.forward_steps_in_memory} -> {T_eff}: "
                  f"the resident-memory estimate exceeds hbm_budget_gb={cfg.hbm_budget_gb} "
                  "(results unchanged; auto_window_cap=False overrides)", flush=True)
        cfg = dataclasses.replace(cfg, forward_steps_in_memory=T_eff)
    windows = InferenceWindows(source, needed, cfg)
    if writer is not None and n_ic > 1:
        raise ValueError(
            "data writers support a single initial condition; score multi-IC "
            "rollouts through the aggregator"
        )
    # the statistics on the card once, not copied at every normalize
    in_norm = exp.normalizer.to(device)
    out_norm = exp.normalizer.subset(out_names).to(device)
    out_stds, out_means = out_norm.stds, out_norm.means
    forcing_norm = exp_forcing_normalizer(exp).to(device) if forcing_names else None
    pin = device.type == "cuda"
    tgt_dtype = TARGET_DTYPES[cfg.targets_dtype]

    def pinned(t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory() if pin else t

    def ic_view(arr: np.ndarray) -> np.ndarray:
        """The (n_ic, T, H, W) view of a window variable."""
        return arr if n_ic > 1 else arr[None]

    timers = {"data_loading": 0.0, "run_on_batch": 0.0, "writer_and_aggregator": 0.0}
    t_start = time.time()
    rng = torch.Generator().manual_seed(cfg.seed)

    # the initial conditions, read before the producer thread starts: one
    # state per initial condition, repeated over the ensemble, the rows
    # IC-major [(ic0, e0..eE), (ic1, e0..eE), ...]
    t0 = time.time()
    inits = []
    for s in windows.start_indices:
        init = windows._read(s, 1, in_names)
        inits.append(np.stack([init[n][0] for n in in_names], axis=-1))
    x_norm = in_norm.normalize(to_device(torch.from_numpy(np.stack(inits)), device))
    x_norm = torch.repeat_interleave(x_norm, E, dim=0)
    timers["data_loading"] += time.time() - t0

    src_n = source.n_timesteps
    upload_cache = UploadCache(cfg.upload_cache_entries)

    def wkey(start_step: int, n_steps: int):
        if cfg.n_repeats <= 1:
            return None  # no window repeats: keep the cache free
        return tuple((s + start_step) % src_n for s in windows.start_indices) + (n_steps,)

    def host_rows(stream):
        """On the producer thread: the window's rows that the card does not
        hold yet, stacked, cast and pinned: the targets (n_ic, T, H, W, C) in
        the targets dtype, the forcings (n_ic, T+1, H, W, F), the prescribed
        target and the mask frames (n_ic, T+1, H, W). A row the upload cache
        holds stays there, so a row skipped here is found in the cache. With
        host copies on, the targets as read ("tgt_host") for every window."""
        for start_step, data in stream:
            n_steps = min(cfg.forward_steps_in_memory, cfg.n_forward_steps - start_step)
            key = wkey(start_step, n_steps)
            rows = {}
            upload = aggregator is not None and (key is None or ("tgt", key) not in upload_cache)
            if upload or to_host:
                tgt = np.stack([ic_view(data[n])[:, 1:n_steps + 1] for n in out_names], axis=-1)
                if upload:
                    rows["tgt"] = pinned(torch.from_numpy(tgt).to(tgt_dtype))
                if to_host:
                    rows["tgt_host"] = tgt
            if key is None or ("cond", key) not in upload_cache:
                if forcing_names:
                    rows["forcing"] = pinned(torch.from_numpy(
                        np.stack([ic_view(data[n]) for n in forcing_names], axis=-1)))
                if prescribed_name and mask_name:
                    for k, n in (("prescribed", prescribed_name), ("mask", mask_name)):
                        rows[k] = pinned(torch.from_numpy(ic_view(data[n])))
            yield start_step, rows

    it = prefetched(host_rows(iter(windows)), depth=2)
    n_done = 0
    window_wall = []  # (n_steps, wall seconds) of each window
    pending = []  # denormalized predictions awaiting the aggregator and the writer
    host_copies = HostCopies()

    def video_targets(tgt: np.ndarray) -> np.ndarray:
        """The targets the video records: the uploaded ones, in the targets
        dtype, as the JAX aggregator's video gets them."""
        if tgt_dtype == torch.float32:
            return tgt
        return torch.from_numpy(tgt).to(tgt_dtype).float().numpy()

    def drain(item):
        preds, w_tgt, w_start, ticket, tgt_host = item
        preds_host = HostCopies.wait(ticket)[0] if ticket is not None else None
        for ic in range(n_ic):
            rows = slice(ic * E, (ic + 1) * E)
            if aggregator is not None:
                p = preds if n_ic == 1 else preds[rows]
                host = (preds_host[rows], video_targets(tgt_host[ic])) if video else None
                aggregator.record_batch(p, w_tgt[ic], start_step=w_start, host=host)
            if writer is not None:
                writer.append(preds_host[rows], tgt_host[ic])

    while True:
        t_win = time.time()
        try:
            start_step, rows = next(it)
        except StopIteration:
            break
        timers["data_loading"] += time.time() - t_win

        t0 = time.time()
        n_steps = min(cfg.forward_steps_in_memory, cfg.n_forward_steps - start_step)
        key = wkey(start_step, n_steps)
        tgt_dev = None
        if aggregator is not None:
            tgt_dev = upload_cache.get(("tgt", key)) if key is not None else None
            if tgt_dev is None:
                tgt_dev = to_device(rows["tgt"], device)
                if key is not None:
                    upload_cache.put(("tgt", key), tgt_dev)
        cached = upload_cache.get(("cond", key)) if key is not None else None
        if cached is not None:
            forcing_rows, tgt_rows, mask_rows = cached
        else:
            forcing_rows = tgt_rows = mask_rows = None
            if forcing_names:
                forcing_rows = torch.repeat_interleave(
                    forcing_norm.normalize(to_device(rows["forcing"], device)), E, dim=0)
            if prescribed_name and mask_name:
                ch = out_names.index(prescribed_name)
                t_raw = to_device(rows["prescribed"], device)
                tgt_rows = torch.repeat_interleave((t_raw - out_means[ch]) / out_stds[ch], E,
                                                   dim=0)
                # the (B, T+1, H, W) mask frames: each emitted step is
                # prescribed with the mask at its own time
                mask_rows = torch.repeat_interleave(to_device(rows["mask"], device), E, dim=0)
            if key is not None:
                upload_cache.put(("cond", key), (forcing_rows, tgt_rows, mask_rows))

        B_tot = n_ic * E
        chunk = cfg.ensemble_in_memory or B_tot
        new_states, pred_parts = [], []
        for s0 in range(0, B_tot, chunk):
            sl = slice(s0, min(s0 + chunk, B_tot))
            xc, pc = stepper.run_window(
                x_norm[sl],
                forcing_rows[sl] if forcing_rows is not None else None,
                tgt_rows[sl] if tgt_rows is not None else None,
                mask_rows[sl] if mask_rows is not None else None,
                _next_window_generator(rng), n_steps, apply_inputs_noise=(start_step == 0))
            new_states.append(xc)
            pred_parts.append(pc)
        x_norm = torch.cat(new_states) if len(new_states) > 1 else new_states[0]
        preds_norm = torch.cat(pred_parts) if len(pred_parts) > 1 else pred_parts[0]
        if consume:
            denorm = _denorm_cast(preds_norm, out_stds, out_means)
            # queued behind the window: the drain waits for it a window later
            ticket = host_copies.copy([denorm]) if to_host else None
            pending.append((denorm, tgt_dev, start_step, ticket, rows.get("tgt_host")))
        else:
            # nothing reads the predictions: only the carried state matters
            _synchronize(device)
        timers["run_on_batch"] += time.time() - t0

        t0 = time.time()
        # the previous window's reductions, queued behind this window, and
        # its host copies, handed on once this window is launched
        while len(pending) > 1:
            drain(pending.pop(0))
        timers["writer_and_aggregator"] += time.time() - t0
        n_done += n_steps
        window_wall.append((n_steps, time.time() - t_win))
        if verbose:
            el = time.time() - t_start
            print(f"[rollout] steps {n_done}/{cfg.n_forward_steps} "
                  f"({n_done / el:.2f} steps/s)", flush=True)

    t0 = time.time()
    for item in pending:
        drain(item)
    # end-synced: the duration covers the device's completion of every
    # window and reduction, not only their launch
    _synchronize(device)
    timers["writer_and_aggregator"] += time.time() - t0

    duration = time.time() - t_start
    if upload_cache.skips and verbose:
        print(f"[run_inference] upload cache overflow: {upload_cache.skips} window uploads "
              f"exceeded upload_cache_entries={upload_cache.cap} and were uploaded again each "
              "cycle; align the source's n_timesteps to the window or raise "
              "upload_cache_entries.",
              flush=True)
    # steady rate: everything after the first window (which carries the
    # first reads and uploads), against the end-synced duration
    if len(window_wall) > 1:
        w0_steps, w0_wall = window_wall[0]
        steady_sps = (n_done - w0_steps) * n_ic * E / max(duration - w0_wall, 1e-9)
    else:
        steady_sps = float("nan")
    return {
        "n_forward_steps": n_done,
        "duration_s": duration,
        "total_steps_per_second": n_done * n_ic * E / duration,
        "steady_steps_per_second": steady_sps,
        "upload_cache_skips": upload_cache.skips,
        **{f"time/{k}": v for k, v in timers.items()},
    }


def run_dataset_inference(predictions_path: str, source: TimeSeriesSource, out_names,
                          area_weights: torch.Tensor, n_forward_steps: Optional[int] = None,
                          aggregator=None, device=None) -> Dict[str, float]:
    """Re-score saved predictions against the dataset: reads the
    ``(E, T, H, W)`` variables of a predictions file (``PredictionWriter``'s
    layout), at most ``n_forward_steps`` of them, against the source's
    frames from 1 on, and returns the aggregator's logs. The reductions run
    on ``device``: the CUDA card unless the caller names another (without a
    card it raises)."""
    from ..data import hdf5
    from ..evaluation.aggregators import InferenceAggregator

    if aggregator is None:
        aggregator = InferenceAggregator(list(out_names), area_weights)
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")

    def stacked(arrays):
        """(..., C) on the device: the variables stacked there, not on the
        host, where a last-axis stack is a strided copy."""
        return torch.stack([to_device(torch.from_numpy(np.ascontiguousarray(a)), device)
                            for a in arrays], dim=-1)

    video = getattr(aggregator, "video", None) is not None
    with hdf5.File(predictions_path) as f:
        T = f[out_names[0]].shape[1]
        n = min(T, n_forward_steps) if n_forward_steps else T
        # [:, :n] decodes only the chunks of the first n steps
        arrays = [f[v][:, :n] for v in out_names]
    preds = stacked(arrays)  # (E, n, H, W, C)
    targets_raw = source.read_window(1, n, list(out_names))
    # the video records the host arrays, stacked on the host only for it
    host = (np.stack(arrays, -1), np.stack([targets_raw[v] for v in out_names], -1)) \
        if video else None
    del arrays
    aggregator.record_batch(preds, stacked(targets_raw[v] for v in out_names), start_step=0,
                            host=host)
    return aggregator.get_logs()


def exp_forcing_normalizer(exp):
    if getattr(exp, "forcing_normalizer", None) is not None:
        return exp.forcing_normalizer
    raise ValueError("experiment has no forcing normalizer but forcings requested")
