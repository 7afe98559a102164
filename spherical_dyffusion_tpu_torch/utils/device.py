"""Copies between the host and the card, and where each waits for the card."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["to_device", "read_back"]


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``. A host tensor bound for the card goes through
    pinned memory with ``non_blocking=True``: the copy is queued on the
    current stream, ahead of every kernel that reads it, and the host does
    not wait for the work queued before it, as a copy from pageable memory
    would. A tensor that is already pinned is not copied again on the host."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def read_back(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``tensors`` (any shapes, one device) as float64 numpy arrays of their
    shapes, through one read: gathered into one tensor and copied to the
    host at once. On the card that copy waits for everything queued before
    it, so it belongs at an epoch's end and never inside a step."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    values = flat.cpu().numpy()
    out, start = [], 0
    for t in tensors:
        out.append(values[start:start + t.numel()].reshape(tuple(t.shape)))
        start += t.numel()
    return out
