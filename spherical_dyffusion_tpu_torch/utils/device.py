"""Host-to-device copies that do not wait for the card."""

from __future__ import annotations

import torch

__all__ = ["to_device"]


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``. A host tensor bound for the card goes through
    pinned memory with ``non_blocking=True``: the copy is queued on the
    current stream, ahead of every kernel that reads it, and the host does
    not wait for the work queued before it, as a copy from pageable memory
    would."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
