"""Training criteria, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/training/losses.py``: ``lp_loss``,
``get_loss_fn``, ``area_weighted_mse`` and ``global_mean_loss``, channels
last, and the ACE family's ``conservation_loss`` (on named fields with a
time axis) and ``weighted_sum_loss``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..evaluation.metrics import weighted_mean
from ..inference.climate_data import ClimateData

__all__ = ["lp_loss", "get_loss_fn", "area_weighted_mse", "global_mean_loss",
           "conservation_loss", "weighted_sum_loss"]

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


def conservation_loss(area_weights: torch.Tensor, sigma,
                      dry_air_penalty: float = 1.0) -> Callable[[Dict[str, torch.Tensor]],
                                                                torch.Tensor]:
    """Dry-air non-conservation penalty: the mean over the trajectory of
    |d/dt global_mean(dry-air surface pressure)| between consecutive steps,
    on a dict of named fields (B, T, H, W), the ACE stepper's view."""
    def fn(gen_data: Dict[str, torch.Tensor]) -> torch.Tensor:
        dry_air = ClimateData(gen_data).surface_pressure_due_to_dry_air(sigma)
        gm = weighted_mean(dry_air, area_weights.to(dry_air.device), dim=(-2, -1))  # (B, T)
        return dry_air_penalty * torch.mean(torch.abs(torch.diff(gm, dim=-1)))

    return fn


def weighted_sum_loss(losses: Mapping[str, Criterion], weights: Mapping[str, float]) -> Criterion:
    """The weighted sum of named criteria (weight 1 where none is given)."""

    def fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for name, loss in losses.items():
            total = total + weights.get(name, 1.0) * loss(pred, target)
        return total

    return fn
