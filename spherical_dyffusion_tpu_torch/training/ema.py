"""Exponential moving average of a network's parameters.

Counterpart of ``spherical_dyffusion_tpu/training/ema.py`` (``EmaState``,
``ema_init``, ``ema_update``): the decay warms up as
``min(decay, (1 + n) / (10 + n))`` with n the number of updates so far, this
one included. The average is a ``state_dict`` of float32 tensors on the
parameters' device (copies, never the parameters themselves), so it loads
into the network as it is, and feeds ``DYffusionStepper(ema_params=...)``.
The count is a Python integer, so an update reads nothing from the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

__all__ = ["EMA"]


class EMA:
    """The moving average of ``model``'s parameters, updated in place."""

    def __init__(self, model: nn.Module, decay: float = 0.9999,
                 params: Optional[Dict[str, torch.Tensor]] = None, count: int = 0):
        """Starts from a copy of the parameters (JAX's ``ema_init``), or from
        ``params`` (a ``state_dict``, e.g. a checkpoint's) after ``count``
        updates."""
        self.decay = decay
        ref = dict(model.named_parameters())
        self.names = list(ref)
        src = params if params is not None else ref
        self.params = {n: src[n].detach().to(ref[n].device, torch.float32, copy=True)
                       for n in self.names}
        self.count = int(count)

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        """``ema = ema * d + (1 - d) * params``, d the warmed-up decay."""
        self.count += 1
        d = min(self.decay, (1.0 + self.count) / (10.0 + self.count))
        ema = [self.params[n] for n in self.names]
        new = dict(model.named_parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [new[n].detach().float() for n in self.names], alpha=1.0 - d)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.params)
