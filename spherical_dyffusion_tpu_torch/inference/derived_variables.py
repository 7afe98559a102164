"""Registry of derived physics diagnostics computed on denormalized rollouts.

Counterpart of ``spherical_dyffusion_tpu/inference/derived_variables.py``:
a registry of functions (ClimateData, SigmaCoordinates) -> tensor, applied to
generated and target data alike, time on axis 1 ((..., time, H, W)). A
diagnostic whose inputs are missing is skipped. On ``device="meta"``
tensors the registry computes shapes only, which is how the ACE rollout
finds the computable names without device work or data reads.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, MutableMapping

import torch

from ..data.coords import SigmaCoordinates
from ..evaluation.metrics import TIMESTEP_SECONDS
from .climate_data import ClimateData

__all__ = ["register", "compute_derived_quantities", "DERIVED_VARIABLE_REGISTRY"]

DERIVED_VARIABLE_REGISTRY: MutableMapping[str, Callable] = {}


def register(func: Callable) -> Callable:
    label = func.__name__
    if label in DERIVED_VARIABLE_REGISTRY:
        raise ValueError(f"{label} already registered")
    DERIVED_VARIABLE_REGISTRY[label] = func
    return func


@register
def surface_pressure_due_to_dry_air(data: ClimateData, sigma: SigmaCoordinates):
    return data.surface_pressure_due_to_dry_air(sigma)


@register
def total_water_path(data: ClimateData, sigma: SigmaCoordinates):
    return data.total_water_path(sigma)


@register
def total_water_path_budget_residual(data: ClimateData, sigma: SigmaCoordinates):
    twp = data.total_water_path(sigma)
    tendency = (twp[:, 1:] - twp[:, :-1]) / TIMESTEP_SECONDS
    residual = tendency - (
        data.evaporation_rate[:, 1:]
        - data.precipitation_rate[:, 1:]
        + data.tendency_of_total_water_path_due_to_advection[:, 1:]
    )
    # no budget residual on the initial step
    return torch.cat([torch.zeros_like(twp[:, :1]), residual], dim=1)


def compute_derived_quantities(
        data: Dict[str, torch.Tensor], sigma: SigmaCoordinates,
        registry: MutableMapping[str, Callable] = DERIVED_VARIABLE_REGISTRY,
) -> Dict[str, torch.Tensor]:
    """``data`` with every computable registered diagnostic added."""
    out = dict(data)
    for label, func in registry.items():
        if label in out:
            raise ValueError(f"variable {label} already exists")
        try:
            out[label] = func(ClimateData(out), sigma)
        except KeyError as e:
            logging.debug(f"Could not compute {label}: missing {e}")
    return out
