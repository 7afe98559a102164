"""Copies between the host and the card, and where each waits for the card."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["to_device", "read_back", "HostCopies"]


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


class HostCopies:
    """Copies of fields from the card to the host that the host does not
    wait for when it queues them.

    ``copy`` queues each tensor's copy, with ``non_blocking=True``, into a
    pinned host buffer, its last (channel) axis first, so that one channel
    is one contiguous block on the host (the writers append a variable at a
    time), and records a CUDA event after them; ``wait`` waits on that event
    alone and returns the copies as float32 numpy arrays in the tensors' own
    axis order (a bf16 tensor crosses at its own width and is widened on the
    host). The buffers are pinned once, at the first copy, and reused: two
    sets of them, taken in turn, because the rollout loops drain a window
    exactly one window later, so window k+1 is copied while window k's
    arrays are still being read, and window k+2 may reuse window k's
    buffers. An array from ``wait`` therefore holds its values until the
    copy two calls later is queued. Tensors on the CPU are handed back as
    they are."""

    def __init__(self):
        self._bufs: List[List[torch.Tensor]] = []
        self._next = 0

    def copy(self, tensors: Sequence[torch.Tensor]):
        tensors = [t.detach() for t in tensors]
        if tensors[0].device.type != "cuda":
            return None, tensors
        if not self._bufs or any(b.numel() < t.numel() or b.dtype != t.dtype
                                 for b, t in zip(self._bufs[0], tensors)):
            self._bufs = [[torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
                           for t in tensors] for _ in range(2)]
        bufs = self._bufs[self._next]
        self._next = 1 - self._next
        outs = []
        for b, t in zip(bufs, tensors):
            first = t.movedim(-1, 0)
            dst = b[:t.numel()].view(first.shape)
            dst.copy_(first.contiguous(), non_blocking=True)
            outs.append(dst.movedim(0, -1))
        event = torch.cuda.Event()
        event.record()
        return event, outs

    @staticmethod
    def wait(ticket) -> List[np.ndarray]:
        event, outs = ticket
        if event is not None:
            event.synchronize()
        return [t.float().numpy() for t in outs]
