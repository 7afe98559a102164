"""Variable metadata tables: long names and units for FV3GFS fields.

A copy of ``spherical_dyffusion_tpu/utils/naming.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_port_writers.py`` pins the
copy to the original, name by name): the ``long_name`` and ``units``
attributes of the files that ``inference/writers.py`` writes.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

__all__ = ["variable_metadata", "long_name", "units"]

_BASE: Dict[str, Tuple[str, str]] = {
    "PRESsfc": ("surface pressure", "Pa"),
    "surface_temperature": ("surface (skin) temperature", "K"),
    "air_temperature": ("air temperature (level {k})", "K"),
    "specific_total_water": ("specific total water (level {k})", "kg/kg"),
    "eastward_wind": ("eastward wind (level {k})", "m/s"),
    "northward_wind": ("northward wind (level {k})", "m/s"),
    "DSWRFtoa": ("downward shortwave radiative flux at TOA", "W/m**2"),
    "USWRFtoa": ("upward shortwave radiative flux at TOA", "W/m**2"),
    "DSWRFsfc": ("downward shortwave radiative flux at surface", "W/m**2"),
    "USWRFsfc": ("upward shortwave radiative flux at surface", "W/m**2"),
    "DLWRFsfc": ("downward longwave radiative flux at surface", "W/m**2"),
    "ULWRFsfc": ("upward longwave radiative flux at surface", "W/m**2"),
    "ULWRFtoa": ("upward longwave radiative flux at TOA", "W/m**2"),
    "LHTFLsfc": ("latent heat flux at surface", "W/m**2"),
    "SHTFLsfc": ("sensible heat flux at surface", "W/m**2"),
    "PRATEsfc": ("surface precipitation rate", "kg/m**2/s"),
    "HGTsfc": ("surface geopotential height", "m"),
    "ocean_fraction": ("ocean fraction of grid cell", "1"),
    "land_fraction": ("land fraction of grid cell", "1"),
    "sea_ice_fraction": ("sea-ice fraction of grid cell", "1"),
    "GRAUPELsfc": ("surface graupel rate", "kg/m**2/s"),
    "ICEsfc": ("surface ice rate", "kg/m**2/s"),
    "SNOWsfc": ("surface snow rate", "kg/m**2/s"),
    "tendency_of_total_water_path_due_to_advection": (
        "tendency of total water path due to advection", "kg/m**2/s"),
    "total_water_path": ("total water path", "kg/m**2"),
    "surface_pressure_due_to_dry_air": ("surface pressure due to dry air", "Pa"),
    "total_water_path_budget_residual": ("total water path budget residual", "kg/m**2/s"),
}

_LEVEL_RE = re.compile(r"^(.*)_(\d+)$")


def variable_metadata(name: str) -> Tuple[str, str]:
    """(long_name, units) for a variable, resolving vertical-level suffixes."""
    if name in _BASE:
        ln, u = _BASE[name]
        return ln.replace(" (level {k})", ""), u
    m = _LEVEL_RE.match(name)
    if m and m.group(1) in _BASE:
        ln, u = _BASE[m.group(1)]
        return ln.format(k=m.group(2)), u
    return name.replace("_", " "), ""


def long_name(name: str) -> str:
    return variable_metadata(name)[0]


def units(name: str) -> str:
    return variable_metadata(name)[1]
