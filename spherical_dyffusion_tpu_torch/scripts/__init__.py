"""The skill studies of the JAX package's ``scripts/``, on the port.

``skill_proof`` trains the two-stage DYffusion pipeline on the synthetic
spherical systems and scores it, ``ace_skill`` trains and rolls out the
ACE-style single-step forecaster per spectral config, and ``skill_report``
gathers their runs into one report. Each runs as ``python -m
spherical_dyffusion_tpu_torch.scripts.<name>``, on the CUDA card unless
``--platform=cpu`` is given, and writes under ``results/torch_*``.
``rollout_10yr`` (the JAX package's 10-year product rollout; ``--device``)
and ``mesh_paper_window`` (the paper window split over a data x h x w mesh,
each rank's memory and seconds; ``--device``, ``--backend``) write there
too.
"""

from __future__ import annotations

import statistics
import time
from typing import List, Optional

import torch

from ..interface import resolve_device

__all__ = ["device_for", "StepClock"]


def device_for(platform: Optional[str]) -> torch.device:
    """The device of ``--platform``: the CUDA card when it is absent (or
    "cuda"/"gpu"), the CPU for "cpu". Raises without a card rather than run
    on the CPU."""
    if str(platform or "cuda").lower() != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --platform=cpu to run on the CPU")
    return resolve_device({"platform": platform})


class StepClock:
    """A ``mark`` for ``Trainer.fit_in_memory``: it stamps the end of each
    step (a CUDA event on the card, which reads nothing back; the host clock
    on the CPU), so that ``step_ms`` can give the median time between
    consecutive steps once the fit has ended. The epoch's read and any
    validation fall between two steps of the thousands, so the median leaves
    them out."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stamps: List = []

    def __call__(self, part: str) -> None:
        if part != "optimizer":
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())

    def step_ms(self, warmup: int = 2) -> Optional[float]:
        """The median ms between consecutive steps after ``warmup`` steps
        (None with fewer than two left)."""
        s = self.stamps[warmup:]
        if len(s) < 2:
            return None
        if self.cuda:
            s[-1].synchronize()
            gaps = [a.elapsed_time(b) for a, b in zip(s, s[1:])]
        else:
            gaps = [(b - a) * 1e3 for a, b in zip(s, s[1:])]
        return statistics.median(gaps)
