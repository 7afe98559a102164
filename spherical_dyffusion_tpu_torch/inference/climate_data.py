"""Named-field accessor over dict climate data, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/inference/climate_data.py``: a thin
view over a dict of (..., H, W) tensors that stacks vertically resolved
variables (``specific_total_water_{k}``) into (..., K) tensors by prefix and
natural sort, and exposes the physical accessors the ACE corrector, ocean
and diagnostics read (evaporation rate from the latent heat flux, the net
surface energy flux, the vertical integrals). A setter writes back under the
name the data already holds. The vertical integrals take ak and bk rounded
to float32 on the data's device (``SigmaCoordinates.tensors``), as the JAX
package casts them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Union

import torch

from ..data.coords import SigmaCoordinates
from ..evaluation import metrics as M

__all__ = ["ClimateData", "CLIMATE_FIELD_NAME_PREFIXES", "natural_sort"]

CLIMATE_FIELD_NAME_PREFIXES: Dict[str, List[str]] = {
    "specific_total_water": ["specific_total_water_"],
    "surface_pressure": ["PRESsfc", "PS"],
    "tendency_of_total_water_path_due_to_advection": [
        "tendency_of_total_water_path_due_to_advection"
    ],
    "latent_heat_flux": ["LHTFLsfc", "LHFLX"],
    "sensible_heat_flux": ["SHTFLsfc"],
    "precipitation_rate": ["PRATEsfc", "surface_precipitation_rate"],
    "sfc_down_sw_radiative_flux": ["DSWRFsfc"],
    "sfc_up_sw_radiative_flux": ["USWRFsfc"],
    "sfc_down_lw_radiative_flux": ["DLWRFsfc"],
    "sfc_up_lw_radiative_flux": ["ULWRFsfc"],
}


def natural_sort(names: List[str]) -> List[str]:
    def convert(t: str) -> Union[str, int]:
        return int(t) if t.isdigit() else t.lower()

    return sorted(names, key=lambda s: [convert(c) for c in re.split(r"([0-9]+)", s)])


class ClimateData:
    def __init__(self, data: Mapping[str, torch.Tensor],
                 prefixes: Mapping[str, List[str]] = CLIMATE_FIELD_NAME_PREFIXES):
        self._data = dict(data)
        self._prefixes = prefixes

    @property
    def data(self) -> Dict[str, torch.Tensor]:
        return self._data

    def _get(self, name: str) -> torch.Tensor:
        for p in self._prefixes[name]:
            if p in self._data:
                return self._data[p]
        raise KeyError(name)

    def _set(self, name: str, value: torch.Tensor) -> None:
        for p in self._prefixes[name]:
            if p in self._data:
                self._data[p] = value
                return
        raise KeyError(name)

    def _extract_levels(self, prefixes: List[str]) -> torch.Tensor:
        for prefix in prefixes:
            names = natural_sort([n for n in self._data if n.startswith(prefix)])
            if names:
                return torch.stack([self._data[n] for n in names], dim=-1)
        raise KeyError(prefixes)

    @property
    def specific_total_water(self) -> torch.Tensor:
        return self._extract_levels(self._prefixes["specific_total_water"])

    @property
    def surface_pressure(self) -> torch.Tensor:
        return self._get("surface_pressure")

    @surface_pressure.setter
    def surface_pressure(self, v: torch.Tensor):
        self._set("surface_pressure", v)

    def surface_pressure_due_to_dry_air(self, sigma: SigmaCoordinates) -> torch.Tensor:
        ps = self.surface_pressure
        return M.surface_pressure_due_to_dry_air(self.specific_total_water, ps,
                                                 *sigma.tensors(ps.device))

    def total_water_path(self, sigma: SigmaCoordinates) -> torch.Tensor:
        ps = self.surface_pressure
        return M.vertical_integral(self.specific_total_water, ps, *sigma.tensors(ps.device))

    @property
    def precipitation_rate(self) -> torch.Tensor:
        return self._get("precipitation_rate")

    @precipitation_rate.setter
    def precipitation_rate(self, v: torch.Tensor):
        self._set("precipitation_rate", v)

    @property
    def latent_heat_flux(self) -> torch.Tensor:
        return self._get("latent_heat_flux")

    @property
    def evaporation_rate(self) -> torch.Tensor:
        """kg m-2 s-1, from the latent heat flux."""
        return self._get("latent_heat_flux") / M.LATENT_HEAT_OF_VAPORIZATION

    @evaporation_rate.setter
    def evaporation_rate(self, v: torch.Tensor):
        self._set("latent_heat_flux", v * M.LATENT_HEAT_OF_VAPORIZATION)

    @property
    def tendency_of_total_water_path_due_to_advection(self) -> torch.Tensor:
        return self._get("tendency_of_total_water_path_due_to_advection")

    @tendency_of_total_water_path_due_to_advection.setter
    def tendency_of_total_water_path_due_to_advection(self, v: torch.Tensor):
        self._set("tendency_of_total_water_path_due_to_advection", v)

    @property
    def net_surface_energy_flux_without_frozen_precip(self) -> torch.Tensor:
        """DLW - ULW + DSW - USW - LHF - SHF."""
        return (
            self._get("sfc_down_lw_radiative_flux")
            - self._get("sfc_up_lw_radiative_flux")
            + self._get("sfc_down_sw_radiative_flux")
            - self._get("sfc_up_sw_radiative_flux")
            - self._get("latent_heat_flux")
            - self._get("sensible_heat_flux")
        )
