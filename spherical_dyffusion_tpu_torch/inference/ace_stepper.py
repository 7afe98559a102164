"""ACE single-step stepper: pack -> model -> unpack -> denormalize -> corrector
-> ocean -> normalize, step after step, and its windowed rollout driver.

Counterpart of ``spherical_dyffusion_tpu/inference/ace_stepper.py``. JAX runs
a window as one ``lax.scan``; here it is a Python loop of device operations,
and nothing in a window reads from the card: the per-step losses stay a
tensor, the forcings are refreshed from the window's data on the card, and
the physics' constants (area weights, ak and bk, normalization statistics)
are put on the stepper's device when it is built.

``run_ace_inference`` is the rollout driver. As the port's DYffusion loop
(``inference/loop.py``, whose wrap-around reader ``wrapped_pieces`` and
``UploadCache`` it shares) it reads the next window on a producer thread,
stacks it into one pinned buffer, uploads it with ``non_blocking=True``,
keeps up to ``UPLOAD_CACHE_ENTRIES`` uploaded windows keyed as JAX's
(``(t0 % n_timesteps, length)``), carries the normalized state across
windows on the card, and
synchronizes once, at the end: its ``time/run_on_batch`` measures launching,
and ``loss_last_window`` is read after that synchronization. CUDA events
recorded between windows give each window's seconds on the device
(``window_seconds``) and the steady rate of the windows after the first.
With a writer (``inference/writers.py``), or the aggregator's video, each
window's scored predictions and targets are copied to the host into reused
pinned buffers behind the window (``utils/device.py:HostCopies``) and
handed on one window later, once the next window is launched: the drain
waits on the copy's event, not on the card's queue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.coords import SigmaCoordinates
from ..data.datamodule import prefetched
from ..data.normalization import StandardNormalizer
from ..training.losses import get_loss_fn
from ..utils.device import HostCopies, read_back, to_device
from .corrector import CorrectorConfig
from .derived_variables import compute_derived_quantities
from .loop import UploadCache, _synchronize, wrapped_pieces
from .ocean import OceanConfig

__all__ = ["SingleStepStepperConfig", "SingleStepStepper", "SteppedData",
           "run_ace_inference", "ace_scored_names"]


@dataclasses.dataclass
class SteppedData:
    """One window's result. ``final_input_norm`` is the normalized
    input-side state after the last step: the next window's initial
    condition in a chained rollout."""

    metrics: Dict[str, torch.Tensor]
    gen_data: Dict[str, torch.Tensor]
    target_data: Dict[str, torch.Tensor]
    gen_data_norm: Dict[str, torch.Tensor]
    target_data_norm: Dict[str, torch.Tensor]
    final_input_norm: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SingleStepStepperConfig:
    in_names: Sequence[str]
    out_names: Sequence[str]
    loss: str = "l2"
    corrector: Optional[CorrectorConfig] = None
    ocean: Optional[OceanConfig] = None

    @property
    def forcing_names(self) -> List[str]:
        return [n for n in self.in_names if n not in self.out_names]

    @property
    def all_names(self) -> List[str]:
        extra = list(self.ocean.names) if self.ocean is not None else []
        return list(dict.fromkeys(list(self.in_names) + list(self.out_names) + extra))


class SingleStepStepper:
    """The ACE autoregressive stepper over a one-step model.

    ``model_fn(x_norm) -> preds_norm`` maps the packed normalized input
    (B, H, W, C_in) to packed normalized outputs (B, H, W, C_out). The
    stepper runs on ``device`` (the area weights' device when None), where
    it keeps the normalizer (over ``cfg.all_names``), the area weights and
    ak and bk. ``module`` is the network that ``model_fn`` runs, where there
    is one (the loaders set it; ``run_inference``'s ``params_dtype`` rounds
    its weights)."""

    def __init__(self, cfg: SingleStepStepperConfig,
                 model_fn: Callable[[torch.Tensor], torch.Tensor],
                 normalizer: StandardNormalizer, area_weights: torch.Tensor,
                 sigma: Optional[SigmaCoordinates] = None, device=None,
                 module: Optional[nn.Module] = None):
        self.device = torch.device(device) if device is not None else area_weights.device
        self.cfg = cfg
        self.model_fn = model_fn
        self.module = module
        self.normalizer = normalizer.to(self.device)
        self.area = to_device(torch.as_tensor(area_weights, dtype=torch.float32), self.device)
        self.sigma = sigma
        if sigma is not None:
            sigma.tensors(self.device)
        self.corrector = (cfg.corrector.build(self.area, sigma)
                          if cfg.corrector is not None else None)
        self.ocean = cfg.ocean.build(cfg.in_names, cfg.out_names) if cfg.ocean else None
        self.loss_fn = get_loss_fn(cfg.loss)
        self._in_norm = self.normalizer.subset(list(cfg.in_names)).to(self.device)
        self._out_norm = self.normalizer.subset(list(cfg.out_names)).to(self.device)
        in_names = list(cfg.in_names)
        # each forcing's statistics as 0-d views on the device
        self._forcing_stats = {n: (self._in_norm.means[in_names.index(n)],
                                   self._in_norm.stds[in_names.index(n)])
                               for n in cfg.forcing_names}

    def _on_device(self, data: Dict[str, object]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in data.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[k] = to_device(t.to(torch.float32), self.device)
        return out

    @torch.inference_mode()
    def run_on_batch(self, data: Dict[str, object], n_forward_steps: int,
                     initial_state_norm: Optional[torch.Tensor] = None,
                     lean: bool = False) -> SteppedData:
        """``data``: {name: (B, T+1, H, W)} raw fields covering the rollout
        (tensors or arrays, moved to the stepper's device as float32).

        ``initial_state_norm``: the normalized (B, H, W, C_in) state to start
        from instead of ``data[:, 0]``: a chained rollout's hand-off.
        ``lean``: return only ``gen_data``, the total loss and the hand-off
        state (the rollout driver derives targets from its own data)."""
        cfg = self.cfg
        data = self._on_device(data)
        in_names, out_names = list(cfg.in_names), list(cfg.out_names)
        in_norm, out_norm = self._in_norm, self._out_norm
        out_idx = {n: i for i, n in enumerate(out_names)}

        if initial_state_norm is None:
            x = in_norm.normalize(torch.stack([data[n][:, 0] for n in in_names], dim=-1))
        else:
            x = initial_state_norm
        gen_norms, step_losses = [], []
        for t in range(n_forward_steps):
            cur_raw = {n: v[:, t] for n, v in data.items()}
            next_raw = {n: v[:, t + 1] for n, v in data.items()}
            preds_norm = self.model_fn(x)
            gen_raw_packed = out_norm.denormalize(preds_norm)
            gen_raw = {n: gen_raw_packed[..., i] for i, n in enumerate(out_names)}
            if self.corrector is not None:
                gen_raw = self.corrector(cur_raw, gen_raw)
            if self.ocean is not None:
                gen_raw = self.ocean(next_raw, cur_raw, gen_raw)
            gen_norm = out_norm.normalize(torch.stack([gen_raw[n] for n in out_names], dim=-1))
            # next input: the predicted channels, and the forcings refreshed
            # from the data
            cols = []
            for n in in_names:
                if n in out_idx:
                    cols.append(gen_norm[..., out_idx[n]])
                else:
                    mu, sd = self._forcing_stats[n]
                    cols.append((next_raw[n] - mu) / sd)
            x = torch.stack(cols, dim=-1)
            target_norm = out_norm.normalize(torch.stack([next_raw[n] for n in out_names],
                                                         dim=-1))
            step_losses.append(self.loss_fn(gen_norm, target_norm))
            gen_norms.append(gen_norm)
        losses = torch.stack(step_losses)
        gen_norm_seq = torch.stack(gen_norms, dim=1)  # (B, T, H, W, C_out)
        gen_raw_seq = out_norm.denormalize(gen_norm_seq)
        # the initial state leads the emitted fields
        init_out_raw = torch.stack([data[n][:, 0] for n in out_names], dim=-1)
        gen_raw_full = torch.cat([init_out_raw[:, None], gen_raw_seq], dim=1)
        gen_data = {n: gen_raw_full[..., i] for i, n in enumerate(out_names)}
        if lean:
            return SteppedData(metrics={"loss": torch.sum(losses)}, gen_data=gen_data,
                               target_data={}, gen_data_norm={}, target_data_norm={},
                               final_input_norm=x)
        gen_norm_full = torch.cat([out_norm.normalize(init_out_raw)[:, None], gen_norm_seq],
                                  dim=1)
        n1 = n_forward_steps + 1
        tgt_raw = {n: data[n][:, :n1] for n in out_names}
        tgt_norm = {n: (data[n][:, :n1] - out_norm.means[i]) / out_norm.stds[i]
                    for i, n in enumerate(out_names)}
        metrics = {"loss": torch.sum(losses),
                   **{f"loss_step_{i}": losses[i] for i in range(n_forward_steps)}}
        return SteppedData(
            metrics=metrics, gen_data=gen_data, target_data=tgt_raw,
            gen_data_norm={n: gen_norm_full[..., i] for i, n in enumerate(out_names)},
            target_data_norm=tgt_norm, final_input_norm=x)

    def get_state(self) -> dict:
        """The serializable state: config, normalizer, area and sigma."""
        return {
            "config": dataclasses.asdict(self.cfg),
            "normalizer": self.normalizer.get_state(),
            "area": self.area.cpu().tolist(),
            "sigma_coordinates": self.sigma.as_dict() if self.sigma else None,
        }


def _derived_names(names: Sequence[str], spatial_shape, sigma: SigmaCoordinates) -> List[str]:
    """The registered diagnostics computable from ``names``, found on
    ``device="meta"`` tensors of shape (1, 2, H, W): no device work, no data
    read."""
    dummy = {n: torch.empty((1, 2) + tuple(spatial_shape), device="meta") for n in names}
    aug = compute_derived_quantities(dummy, sigma)
    return sorted(k for k in aug if k not in names)


def ace_scored_names(stepper: SingleStepStepper, source, derived: bool = False) -> List[str]:
    """The variables ``run_ace_inference`` scores: the prognostics, plus with
    ``derived=True`` every registered diagnostic computable from the
    stepper's fields. Build the aggregator from this list."""
    names = list(stepper.cfg.out_names)
    if not derived:
        return names
    return names + _derived_names(list(stepper.cfg.all_names), source.spatial_shape,
                                  stepper.sigma)


@torch.inference_mode()
def run_ace_inference(stepper: SingleStepStepper, source, n_forward_steps: int,
                      forward_steps_in_memory: int = 50, n_repeats: int = 1,
                      aggregator=None, writer=None, derived: bool = False,
                      verbose: bool = True,
                      on_window: Optional[Callable[[int, SteppedData], None]] = None
                      ) -> Dict[str, object]:
    """The windowed ACE rollout over ``source`` (a ``TimeSeriesSource``
    covering ``stepper.cfg.all_names``; ``n_repeats`` loops it). Each
    window of ``forward_steps_in_memory`` steps is one ``run_on_batch`` call
    from the previous window's final state. With ``aggregator``, the
    generated fields and the targets of every window, with ``derived`` also
    every computable registered diagnostic (it needs ``stepper.sigma``), are
    recorded, in the order of ``ace_scored_names``. ``writer`` gets the
    prognostic part of each window's predictions (1, n, H, W, C) and targets
    (n, H, W, C) on the host, as in JAX: derived fields extend the
    aggregator's names, not the writer's. ``on_window(start,
    out)``, if given, receives each window's lean ``SteppedData`` once it is
    launched (nothing of it has been read on the host).

    Returns the summary: ``n_forward_steps``, the end-synced ``duration_s``,
    ``total_steps_per_second``, ``steady_steps_per_second`` (the windows
    after the first over their seconds on the device; nan with one window),
    ``window_seconds`` (each window's, from the device's events; the host
    clock on the CPU), ``loss_last_window``, ``upload_cache_skips`` and the
    ``time/*`` host splits."""
    names = list(stepper.cfg.all_names)
    out_names = list(stepper.cfg.out_names)
    device = stepper.device
    cuda = device.type == "cuda"
    n_src = source.n_timesteps
    if n_forward_steps + 1 > n_src * max(1, n_repeats):
        raise ValueError(f"rollout needs {n_forward_steps + 1} frames; source has {n_src} x "
                         f"n_repeats={n_repeats}")
    if derived and stepper.sigma is None:
        raise ValueError("derived=True requires stepper.sigma (the vertical coordinate of "
                         "the diagnostics)")
    scored = ace_scored_names(stepper, source, derived=derived)
    upload_cache = UploadCache()
    n_prog = len(out_names)  # the prognostic names lead the scored ones
    video = getattr(aggregator, "video", None) is not None
    to_host = writer is not None or video
    host_copies = HostCopies()
    pending = []  # scored windows awaiting their host copies

    def windows():
        start = 0
        while start < n_forward_steps:
            n = min(forward_steps_in_memory, n_forward_steps - start)
            yield start, n
            start += n

    def host_windows():
        """On the producer thread: each window's frames (N, 1, n+1, H, W),
        read with wrap-around into one pinned buffer; None for a window the
        upload cache holds."""
        for start, n in windows():
            if (start % n_src, n + 1) in upload_cache:
                yield start, n, None
                continue
            buf = torch.empty((len(names), 1, n + 1) + tuple(source.spatial_shape),
                              dtype=torch.float32, pin_memory=cuda)
            view = buf.numpy()
            for got, piece in wrapped_pieces(source, start, n + 1, names):
                for i, nm in enumerate(names):
                    view[i, 0, got:got + len(piece[nm])] = piece[nm]
            yield start, n, buf

    def score_pack(gen_data, data):
        """(preds (B, n, H, W, C), targets (n, H, W, C)) over the scored
        names; the targets keep the batch axis through the diagnostics,
        which difference time on axis 1."""
        gen_d = {nm: gen_data[nm][:, 1:] for nm in out_names}
        tgt_d = {nm: data[nm][:, 1:] for nm in names}
        if derived:
            gen_d = compute_derived_quantities(
                {**gen_d, **{nm: data[nm][:, 1:] for nm in names if nm not in out_names}},
                stepper.sigma)
            tgt_d = compute_derived_quantities(tgt_d, stepper.sigma)
        preds = torch.stack([gen_d[nm] for nm in scored], dim=-1)
        tgts = torch.stack([tgt_d[nm][0] for nm in scored], dim=-1)
        return preds, tgts

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def drain(item):
        preds, tgts, start, ticket = item
        host = HostCopies.wait(ticket) if ticket is not None else None
        if aggregator is not None:
            aggregator.record_batch(preds, tgts, start_step=start, host=host if video else None)
        if writer is not None:
            writer.append(host[0][..., :n_prog], host[1][..., :n_prog])

    timers = {"data_loading": 0.0, "run_on_batch": 0.0, "writer_and_aggregator": 0.0}
    t_start = time.time()
    x_norm, last = None, None
    marks = [mark()]
    steps = []
    for start, n, buf in prefetched(host_windows(), depth=2):
        t0 = time.time()
        key = (start % n_src, n + 1)
        dev = upload_cache.get(key)
        if dev is None:
            dev = to_device(buf, device)
            upload_cache.put(key, dev)
        data = {nm: dev[i] for i, nm in enumerate(names)}
        timers["data_loading"] += time.time() - t0

        t0 = time.time()
        out = stepper.run_on_batch(data, n, initial_state_norm=x_norm, lean=True)
        x_norm = out.final_input_norm
        timers["run_on_batch"] += time.time() - t0

        t0 = time.time()
        if aggregator is not None or writer is not None:
            preds, tgts = score_pack(out.gen_data, data)
            ticket = None
            if to_host:
                keep = slice(None) if video else slice(0, n_prog)
                ticket = host_copies.copy([preds[..., keep], tgts[..., keep]])
            pending.append((preds, tgts, start, ticket))
        # with host copies, the previous window's, once this one is queued
        while len(pending) > (1 if to_host else 0):
            drain(pending.pop(0))
        timers["writer_and_aggregator"] += time.time() - t0
        if on_window is not None:
            on_window(start, out)
        last = out
        marks.append(mark())
        steps.append(n)
        if verbose:
            done = start + n
            print(f"[ace-rollout] steps {done}/{n_forward_steps} "
                  f"({done / max(time.time() - t_start, 1e-9):.2f} steps/s)", flush=True)

    # end-synced: the duration covers the device's completion of every window
    t0 = time.time()
    for item in pending:
        drain(item)
    _synchronize(device)
    timers["writer_and_aggregator"] += time.time() - t0
    duration = time.time() - t_start
    loss = float(read_back([last.metrics["loss"]])[0]) if last is not None else float("nan")
    window_s = [(a.elapsed_time(b) / 1e3 if cuda else b - a) for a, b in zip(marks, marks[1:])]
    steady = (sum(steps[1:]) / sum(window_s[1:]) if len(steps) > 1 else float("nan"))
    return {
        "n_forward_steps": float(n_forward_steps),
        "duration_s": duration,
        "total_steps_per_second": n_forward_steps / duration,
        "steady_steps_per_second": steady,
        "window_seconds": window_s,
        "loss_last_window": loss,
        "upload_cache_skips": upload_cache.skips,
        **{f"time/{k}": v for k, v in timers.items()},
    }
