"""Area-weighted probabilistic evaluation metrics, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/evaluation/metrics.py``: plain
functions on tensors, channels-last, the ensemble axis (where present) axis
0. They run on the tensors' device and return tensors, so a caller that
reduces on the card moves only the small results to the host.

``crps_ensemble`` sums the spread term over member pairs in a loop instead of
building the (E, E, ...) difference tensor: at ensemble 4 and a 96-step
window of 180 x 360 x 35 that tensor would take 13.9 GB in float32. The value
is the same; only the summation order differs. The physics constants and
the vertical metrics of the ACE family (``vertical_integral``,
``surface_pressure_due_to_dry_air``) keep the JAX package's rounding points.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np
import torch

Dimension = Union[int, Iterable[int]]

GRAVITY = 9.80665  # m/s^2
TIMESTEP_SECONDS = 21600.0  # 6 h
LATENT_HEAT_OF_VAPORIZATION = 2.5e6  # J/kg

__all__ = [
    "GRAVITY",
    "TIMESTEP_SECONDS",
    "LATENT_HEAT_OF_VAPORIZATION",
    "spherical_area_weights",
    "weighted_mean",
    "weighted_std",
    "weighted_mean_bias",
    "mean_squared_error",
    "root_mean_squared_error",
    "ensemble_spread",
    "spread_skill_ratio",
    "crps_ensemble",
    "gradient_magnitude",
    "weighted_mean_gradient_magnitude",
    "gradient_magnitude_percent_diff",
    "rmse_of_time_mean",
    "time_and_global_mean_bias",
    "vertical_integral",
    "surface_pressure_due_to_dry_air",
]


def _dims(x: torch.Tensor, dim: Dimension):
    """JAX's ``axis`` argument: () means every axis."""
    if isinstance(dim, int):
        return (dim,)
    dim = tuple(dim)
    return dim if dim else tuple(range(x.dim()))


def spherical_area_weights(lats: np.ndarray, num_lon: int) -> torch.Tensor:
    """cos(lat) cell-area weights (H, num_lon), normalized to sum 1, float32."""
    lats = torch.as_tensor(np.asarray(lats), dtype=torch.float32)
    w = torch.cos(torch.deg2rad(lats))[:, None] * torch.ones((1, num_lon), dtype=torch.float32)
    return w / torch.sum(w)


def weighted_mean(x: torch.Tensor, weights: Optional[torch.Tensor] = None,
                  dim: Dimension = (), keepdims: bool = False) -> torch.Tensor:
    axes = _dims(x, dim)
    if weights is None:
        return torch.mean(x, dim=axes, keepdim=keepdims)
    wb = torch.broadcast_to(weights, x.shape)
    return torch.sum(x * weights, dim=axes, keepdim=keepdims) / torch.sum(
        wb, dim=axes, keepdim=keepdims)


def weighted_std(x: torch.Tensor, weights: Optional[torch.Tensor] = None,
                 dim: Dimension = ()) -> torch.Tensor:
    mean = weighted_mean(x, weights, dim, keepdims=True)
    return torch.sqrt(weighted_mean((x - mean) ** 2, weights, dim))


def weighted_mean_bias(truth: torch.Tensor, predicted: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       dim: Dimension = ()) -> torch.Tensor:
    return weighted_mean(predicted - truth, weights, dim)


def mean_squared_error(truth: torch.Tensor, predicted: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       dim: Dimension = ()) -> torch.Tensor:
    return weighted_mean((predicted - truth) ** 2, weights, dim)


def root_mean_squared_error(truth: torch.Tensor, predicted: torch.Tensor,
                            weights: Optional[torch.Tensor] = None,
                            dim: Dimension = ()) -> torch.Tensor:
    return torch.sqrt(mean_squared_error(truth, predicted, weights, dim))


def ensemble_spread(predicted: torch.Tensor, weights: Optional[torch.Tensor] = None,
                    dim: Dimension = ()) -> torch.Tensor:
    """sqrt of the weighted-mean ensemble variance (ddof 1); ensemble axis 0."""
    var = torch.var(predicted, dim=0, correction=1)
    return torch.sqrt(weighted_mean(var, weights, dim))


def spread_skill_ratio(truth: torch.Tensor, predicted: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       dim: Dimension = ()) -> torch.Tensor:
    """Spread over the RMSE of the ensemble mean, the spread scaled by
    sqrt((M + 1) / M) for the small ensemble."""
    n = predicted.shape[0]
    spread = ensemble_spread(predicted, weights, dim) * ((n + 1) / n) ** 0.5
    skill = root_mean_squared_error(truth, torch.mean(predicted, dim=0), weights, dim)
    return spread / skill


def crps_ensemble(truth: torch.Tensor, predicted: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, dim: Dimension = (),
                  reduction: str = "mean") -> torch.Tensor:
    """Fair ensemble CRPS (Zamo and Naveau 2018): E|X - y| - 1/2 E|X - X'|,
    the spread term averaged over the M(M-1) ordered pairs. Ensemble axis 0
    of ``predicted``; ``truth`` has none. Each unordered pair is summed once
    and counted twice."""
    if reduction not in ("mean", "none"):
        raise ValueError(f"Unknown reduction {reduction!r}")
    n = predicted.shape[0]
    skill = torch.mean(torch.abs(predicted - truth[None]), dim=0)
    pair_sum = torch.zeros_like(skill)
    for i in range(n):
        for j in range(i + 1, n):
            pair_sum += torch.abs(predicted[i] - predicted[j])
    crps = skill - 0.5 * (2.0 * pair_sum) / (n * (n - 1))
    if reduction == "none":
        return crps
    return weighted_mean(crps, weights, dim)


def _gradient(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Central differences with one-sided first-order edges (x[1] - x[0] and
    x[-1] - x[-2]); ``torch.gradient`` divides its edges by another rule."""
    n = x.shape[axis]
    inner = (x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)) / 2.0
    first = x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)
    return torch.cat([first, inner, last], dim=axis)


def gradient_magnitude(x: torch.Tensor, dim: Dimension = ()) -> torch.Tensor:
    """sqrt of the summed squared gradients along ``dim`` (axes of length 1
    skipped)."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = tuple(d for d in dims if x.shape[d] > 1)
    grads = [_gradient(x, d) for d in dims]
    if not grads:
        return torch.zeros_like(x)
    return torch.sqrt(sum(g ** 2 for g in grads))


def weighted_mean_gradient_magnitude(x: torch.Tensor, weights: Optional[torch.Tensor] = None,
                                     dim: Dimension = ()) -> torch.Tensor:
    return weighted_mean(gradient_magnitude(x, dim), weights, dim)


def gradient_magnitude_percent_diff(truth: torch.Tensor, predicted: torch.Tensor,
                                    weights: Optional[torch.Tensor] = None,
                                    dim: Dimension = (),
                                    is_ensemble_prediction: bool = False) -> torch.Tensor:
    t = weighted_mean_gradient_magnitude(truth, weights, dim)
    if is_ensemble_prediction:
        p = torch.mean(torch.stack([weighted_mean_gradient_magnitude(m, weights, dim)
                                    for m in predicted]), dim=0)
    else:
        p = weighted_mean_gradient_magnitude(predicted, weights, dim)
    return 100.0 * (p - t) / t


def rmse_of_time_mean(truth: torch.Tensor, predicted: torch.Tensor,
                      weights: Optional[torch.Tensor] = None, time_dim: int = 0,
                      spatial_dims: Dimension = (-2, -1)) -> torch.Tensor:
    """RMSE of the time-averaged fields."""
    return root_mean_squared_error(torch.mean(truth, dim=time_dim),
                                   torch.mean(predicted, dim=time_dim), weights, spatial_dims)


def time_and_global_mean_bias(truth: torch.Tensor, predicted: torch.Tensor,
                              weights: Optional[torch.Tensor] = None, time_dim: int = 0,
                              spatial_dims: Dimension = (-2, -1)) -> torch.Tensor:
    """Bias of the global- and time-mean."""
    return weighted_mean(torch.mean(predicted - truth, dim=time_dim), weights, spatial_dims)


def vertical_integral(integrand: torch.Tensor, surface_pressure: torch.Tensor,
                      ak: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    """(1/g) * sum_k dp_k x_k with dp = diff(ak + ps * bk); integrand
    (..., K), ps (...), ak and bk (K+1,) on the integrand's device."""
    p_interface = ak + surface_pressure[..., None] * bk  # (..., K+1)
    dp = torch.diff(p_interface, dim=-1)
    return torch.sum(dp * integrand, dim=-1) / GRAVITY


def surface_pressure_due_to_dry_air(specific_total_water: torch.Tensor,
                                    surface_pressure: torch.Tensor, ak: torch.Tensor,
                                    bk: torch.Tensor) -> torch.Tensor:
    """ps - g * TWP, the total water path TWP from ``vertical_integral``."""
    twp = vertical_integral(specific_total_water, surface_pressure, ak, bk)
    return surface_pressure - GRAVITY * twp
