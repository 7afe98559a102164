"""Physics-constraint correctors applied after each ACE forecast step, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/inference/corrector.py``:

* dry-air conservation by a globally constant surface-pressure offset:
    ps_new = (dry_air_target + sum_k ak_diff * wat_k) / (1 - sum_k bk_diff * wat_k);
* a zero global mean of the moisture advection tendency;
* moisture-budget closure by rescaling precipitation or evaporation and,
  for the ``advection_and_*`` terms, recomputing the advective tendency as
  the budget's residual.

Every operation runs on the fields' device; ak and bk are rounded to
float32 before they are differenced, as in JAX (real hybrid levels reach
thousands of Pa, where differencing in float64 first can give other float32
bits).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ..data.coords import SigmaCoordinates
from ..evaluation import metrics as M
from .climate_data import ClimateData

__all__ = ["CorrectorConfig", "Corrector", "DENSITY_OF_WATER", "SPECIFIC_HEAT_OF_WATER"]

DENSITY_OF_WATER = 1000.0  # kg/m^3
SPECIFIC_HEAT_OF_WATER = 4000.0  # J/kg/K (SHiELD slab-ocean values)
MOISTURE_BUDGET_TERMS = (None, "precipitation", "evaporation",
                         "advection_and_precipitation", "advection_and_evaporation")


@dataclasses.dataclass(frozen=True)
class CorrectorConfig:
    conserve_dry_air: bool = False
    zero_global_mean_moisture_advection: bool = False
    moisture_budget_correction: Optional[str] = None  # one of MOISTURE_BUDGET_TERMS

    def __post_init__(self):
        if self.moisture_budget_correction not in MOISTURE_BUDGET_TERMS:
            raise ValueError(self.moisture_budget_correction)

    def build(self, area: torch.Tensor, sigma: SigmaCoordinates) -> "Corrector":
        return Corrector(self, area, sigma)


class Corrector:
    """``corrector(input_data, gen_data) -> gen_data`` corrected; ``area``
    (H, W) on the fields' device."""

    def __init__(self, config: CorrectorConfig, area: torch.Tensor, sigma: SigmaCoordinates):
        self.cfg = config
        self.area = area
        self.sigma = sigma

    def __call__(self, input_data: Mapping[str, torch.Tensor],
                 gen_data: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.cfg.conserve_dry_air:
            gen_data = _force_conserve_dry_air(input_data, gen_data, self.area, self.sigma)
        if self.cfg.zero_global_mean_moisture_advection:
            gen_data = _force_zero_global_mean_moisture_advection(gen_data, self.area)
        if self.cfg.moisture_budget_correction is not None:
            gen_data = _force_conserve_moisture(input_data, gen_data, self.area, self.sigma,
                                                self.cfg.moisture_budget_correction)
        return dict(gen_data)


def _force_conserve_dry_air(input_data, gen_data, area, sigma) -> Dict[str, torch.Tensor]:
    inp = ClimateData(input_data)
    gen = ClimateData(gen_data)
    gen_dry_air = gen.surface_pressure_due_to_dry_air(sigma)
    global_gen = M.weighted_mean(gen_dry_air, area, dim=(-2, -1))
    global_target = M.weighted_mean(inp.surface_pressure_due_to_dry_air(sigma), area,
                                    dim=(-2, -1))
    error = global_gen - global_target
    new_dry_air = gen_dry_air - error[..., None, None]
    wat = gen.specific_total_water
    ak, bk = sigma.tensors(wat.device)
    ak_diff, bk_diff = torch.diff(ak), torch.diff(bk)
    new_ps = (new_dry_air + torch.sum(ak_diff * wat, -1)) / (1.0 - torch.sum(bk_diff * wat, -1))
    gen.surface_pressure = new_ps
    return gen.data


def _force_zero_global_mean_moisture_advection(gen_data, area) -> Dict[str, torch.Tensor]:
    gen = ClimateData(gen_data)
    adv = gen.tendency_of_total_water_path_due_to_advection
    mean_adv = M.weighted_mean(adv, area, dim=(-2, -1))
    gen.tendency_of_total_water_path_due_to_advection = adv - mean_adv[..., None, None]
    return gen.data


def _force_conserve_moisture(input_data, gen_data, area, sigma, terms) -> Dict[str, torch.Tensor]:
    inp = ClimateData(input_data)
    gen = ClimateData(gen_data)
    twp_tendency = (gen.total_water_path(sigma) - inp.total_water_path(sigma)) \
        / M.TIMESTEP_SECONDS
    twp_mean = M.weighted_mean(twp_tendency, area, dim=(-2, -1))
    evap_mean = M.weighted_mean(gen.evaporation_rate, area, dim=(-2, -1))
    precip_mean = M.weighted_mean(gen.precipitation_rate, area, dim=(-2, -1))
    if terms.endswith("precipitation"):
        new_precip_mean = evap_mean - twp_mean
        gen.precipitation_rate = (
            gen.precipitation_rate * (new_precip_mean / precip_mean)[..., None, None])
    elif terms.endswith("evaporation"):
        new_evap_mean = twp_mean + precip_mean
        gen.evaporation_rate = gen.evaporation_rate * (new_evap_mean / evap_mean)[..., None, None]
    if terms.startswith("advection"):
        gen.tendency_of_total_water_path_due_to_advection = twp_tendency - (
            gen.evaporation_rate - gen.precipitation_rate)
    return gen.data
