"""Training criteria, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/training/losses.py``: ``lp_loss``,
``get_loss_fn``, ``area_weighted_mse`` and ``global_mean_loss``, channels
last. ``conservation_loss`` and ``weighted_sum_loss`` belong to the ACE
family and are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..evaluation.metrics import weighted_mean

__all__ = ["lp_loss", "get_loss_fn", "area_weighted_mse", "global_mean_loss"]

Criterion = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def lp_loss(pred: torch.Tensor, target: torch.Tensor, p: int = 2,
            relative: bool = True) -> torch.Tensor:
    """Relative or absolute Lp norm of each sample's error, averaged over
    the batch."""
    B = pred.shape[0]
    diff = torch.linalg.vector_norm((pred - target).reshape(B, -1), ord=p, dim=1)
    if relative:
        return torch.mean(diff / torch.linalg.vector_norm(target.reshape(B, -1), ord=p, dim=1))
    return torch.mean(diff)


def get_loss_fn(name: str) -> Criterion:
    """Name -> criterion: l1 (mae), l2 (mse), l1_rel, l2_rel."""
    name = name.lower()
    if name in ("l1", "mae"):
        return lambda p, t: torch.mean(torch.abs(p - t))
    if name in ("l2", "mse"):
        return lambda p, t: torch.mean((p - t) ** 2)
    if name == "l1_rel":
        return lambda p, t: lp_loss(p, t, p=1, relative=True)
    if name == "l2_rel":
        return lambda p, t: lp_loss(p, t, p=2, relative=True)
    raise ValueError(f"Unknown loss {name!r}")


def area_weighted_mse(weights: torch.Tensor) -> Criterion:
    """Latitude-weighted MSE; weights (H, W), inputs (..., H, W, C)."""

    def fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return weighted_mean((pred - target) ** 2, weights[..., None].to(pred.device), dim=())

    return fn


def global_mean_loss(weights: torch.Tensor, base: Optional[Criterion] = None) -> Criterion:
    """``base`` (MSE by default) on the area-weighted global mean of each
    channel; weights (H, W), inputs (..., H, W, C)."""
    base = base or (lambda p, t: torch.mean((p - t) ** 2))

    def fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        w = weights[..., None].to(pred.device)
        return base(weighted_mean(pred, w, dim=(-3, -2)), weighted_mean(target, w, dim=(-3, -2)))

    return fn
