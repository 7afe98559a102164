"""Sea-surface boundary condition of the ACE stepper: prescribed SST or a slab ocean.

Counterpart of ``spherical_dyffusion_tpu/inference/ocean.py``: either
overwrite the surface temperature with the target's in the ocean region, or
integrate a slab mixed-layer tendency (F_net + Q_flux) / (rho * depth * c_p)
over one step and prescribe the result. The region is where the ocean
fraction rounds to 1 (``torch.round`` rounds half to even, as
``jnp.round``); ``interpolate`` blends by the fraction instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..evaluation.metrics import TIMESTEP_SECONDS
from .climate_data import ClimateData
from .corrector import DENSITY_OF_WATER, SPECIFIC_HEAT_OF_WATER

__all__ = ["OceanConfig", "SlabOceanConfig", "Ocean", "mixed_layer_temperature_tendency"]


@dataclasses.dataclass(frozen=True)
class SlabOceanConfig:
    mixed_layer_depth_name: str
    q_flux_name: str

    @property
    def names(self) -> List[str]:
        return [self.mixed_layer_depth_name, self.q_flux_name]


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    surface_temperature_name: str
    ocean_fraction_name: str
    interpolate: bool = False
    slab: Optional[SlabOceanConfig] = None

    def build(self, in_names, out_names) -> "Ocean":
        if self.surface_temperature_name not in in_names or \
           self.surface_temperature_name not in out_names:
            raise ValueError(
                f"{self.surface_temperature_name!r} must be in in_names and out_names")
        return Ocean(self)

    @property
    def names(self) -> List[str]:
        names = [self.surface_temperature_name, self.ocean_fraction_name]
        if self.slab is not None:
            names.extend(self.slab.names)
        return list(dict.fromkeys(names))


def mixed_layer_temperature_tendency(
        f_net: torch.Tensor, q_flux: torch.Tensor, depth: torch.Tensor,
        density: float = DENSITY_OF_WATER,
        specific_heat: float = SPECIFIC_HEAT_OF_WATER) -> torch.Tensor:
    """K/s."""
    return (f_net + q_flux) / (density * depth * specific_heat)


class Ocean:
    def __init__(self, config: OceanConfig):
        self.cfg = config
        self.type = "prescribed" if config.slab is None else "slab"

    @property
    def target_names(self) -> List[str]:
        if self.type == "prescribed":
            return [self.cfg.surface_temperature_name, self.cfg.ocean_fraction_name]
        return [self.cfg.ocean_fraction_name, self.cfg.slab.mixed_layer_depth_name,
                self.cfg.slab.q_flux_name]

    def __call__(self, target_data: Dict[str, torch.Tensor], input_data: Dict[str, torch.Tensor],
                 gen_data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        name = self.cfg.surface_temperature_name
        if self.type == "prescribed":
            next_temp = target_data[name]
        else:
            tendency = mixed_layer_temperature_tendency(
                ClimateData(gen_data).net_surface_energy_flux_without_frozen_precip,
                target_data[self.cfg.slab.q_flux_name],
                target_data[self.cfg.slab.mixed_layer_depth_name])
            next_temp = input_data[name] + tendency * TIMESTEP_SECONDS
        mask = target_data[self.cfg.ocean_fraction_name]
        gen = dict(gen_data)
        if self.cfg.interpolate:
            gen[name] = mask * next_temp + (1.0 - mask) * gen[name]
        else:
            region = torch.round(mask).to(torch.int32) == 1
            gen[name] = torch.where(region, next_temp, gen[name])
        return gen
