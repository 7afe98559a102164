"""Profiling and introspection utilities.

Counterpart of ``spherical_dyffusion_tpu/utils/profiling.py``, with the same
output keys: named accumulating wall-clock timers (``time/<name>`` and
``time/<name>_mean``), a timing scope, a profiler trace scope (here
``torch.profiler``, writing a Chrome trace where JAX writes an XLA trace)
and the card's memory statistics (here ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info``).

The timers measure wall time on the host, as JAX's do: work queued on the
card and not yet finished when a scope closes is not in its time. A caller
that wants the card's work counted passes ``sync=True`` to ``Timers`` or
``timing_scope``, which then waits for the card at the scope's start and
end.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["Timers", "timing_scope", "trace_scope", "device_memory_stats",
           "print_device_memory"]


def _sync(device=None) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


class Timers:
    """Named accumulating wall-clock timers. With ``sync=True`` each scope
    waits for the card before reading the clock at its start and end."""

    def __init__(self, sync: bool = False):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            _sync()
        t0 = time.time()
        try:
            yield
        finally:
            if self.sync:
                _sync()
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        out = {}
        for k, v in self.totals.items():
            out[f"time/{k}"] = v
            out[f"time/{k}_mean"] = v / max(self.counts[k], 1)
        return out


@contextlib.contextmanager
def timing_scope(name: str, verbose: bool = True, logger=None, step: Optional[int] = None,
                 sync: bool = False):
    """Print (``verbose``) and log (``logger.log({"time/<name>": s})``) the
    wall seconds of a block; ``sync=True`` waits for the card at its start
    and end."""
    if sync:
        _sync()
    t0 = time.time()
    try:
        yield
    finally:
        if sync:
            _sync()
        dt = time.time() - t0
        if verbose:
            print(f"[timing] {name}: {dt:.3f}s", flush=True)
        if logger is not None:
            logger.log({f"time/{name}": dt}, step=step)


@contextlib.contextmanager
def trace_scope(log_dir: str):
    """A ``torch.profiler`` session over the block (host and, where the
    card is present, CUDA activity), exported as a Chrome trace to
    ``log_dir/trace.json`` (Perfetto and chrome://tracing read it). Yields
    the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in GB: ``bytes_in_use_gb`` and
    ``peak_bytes_in_use_gb`` (the caching allocator's allocated bytes, now
    and at their peak) and ``bytes_limit_gb`` (the card's total memory).
    ``{}`` where there is no card, as JAX returns ``{}`` for a backend
    without statistics."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    gb = 1024 ** 3
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / gb,
        "peak_bytes_in_use_gb": stats.get("allocated_bytes.all.peak", 0) / gb,
        "bytes_limit_gb": total / gb,
    }


def print_device_memory(prefix: str = "", device=None):
    stats = device_memory_stats(device)
    if stats:
        print(
            f"{prefix}HBM: {stats['bytes_in_use_gb']:.2f} GB in use "
            f"(peak {stats['peak_bytes_in_use_gb']:.2f} / "
            f"limit {stats['bytes_limit_gb']:.2f})",
            flush=True,
        )
