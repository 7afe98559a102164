"""Coordinate metadata: hybrid sigma-pressure levels and lat-lon grids.

Counterpart of ``spherical_dyffusion_tpu/data/coords.py`` as far as the
sources return it: ``SigmaCoordinates`` and ``HorizontalCoordinates``, numpy
arrays as in the JAX package; ``HorizontalCoordinates.area_weights`` gives a
float32 CPU tensor, which the aggregators move to their tensors' device.
``VariableMetadata`` holds a variable's units and long name.
``GridMetadata`` bundles the grid for the datamodules. ``SigmaCoordinates.tensors``
gives ak and bk as float32 tensors on a device, made once there, so that the
ACE physics, which reads them every step, copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..evaluation.metrics import spherical_area_weights
from ..utils.device import to_device

__all__ = ["SigmaCoordinates", "HorizontalCoordinates", "VariableMetadata", "GridMetadata"]


@dataclasses.dataclass(frozen=True)
class SigmaCoordinates:
    """Hybrid sigma-pressure vertical coordinate: p_interface = ak + ps * bk."""

    ak: np.ndarray  # (K+1,)
    bk: np.ndarray  # (K+1,)
    _on: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def coords(self) -> Dict[str, np.ndarray]:
        return {"ak": self.ak, "bk": self.bk}

    @property
    def num_levels(self) -> int:
        return len(self.ak) - 1

    def as_dict(self) -> dict:
        return {"ak": np.asarray(self.ak).tolist(), "bk": np.asarray(self.bk).tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "SigmaCoordinates":
        return cls(np.asarray(d["ak"], np.float64), np.asarray(d["bk"], np.float64))

    def tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ak, bk) rounded to float32, as the JAX package casts them before
        use, on ``device``; made at the first call for a device and kept."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:  # the key of the tensors' device
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(
                to_device(torch.as_tensor(np.asarray(a), dtype=torch.float32), device)
                for a in (self.ak, self.bk))
        return self._on[key]


@dataclasses.dataclass(frozen=True)
class HorizontalCoordinates:
    """Cell-center latitudes and longitudes of a regular grid (degrees)."""

    lat: np.ndarray  # (H,)
    lon: np.ndarray  # (W,)

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.lat), len(self.lon))

    def area_weights(self) -> torch.Tensor:
        return spherical_area_weights(self.lat, len(self.lon))

    @classmethod
    def regular(cls, nlat: int = 180, nlon: int = 360) -> "HorizontalCoordinates":
        """1-degree FV3GFS-style cell-centered grid (lat descending from N)."""
        lat = 90.0 - (np.arange(nlat) + 0.5) * (180.0 / nlat)
        lon = (np.arange(nlon) + 0.5) * (360.0 / nlon)
        return cls(lat, lon)


@dataclasses.dataclass(frozen=True)
class VariableMetadata:
    units: str = ""
    long_name: str = ""


@dataclasses.dataclass(frozen=True)
class GridMetadata:
    """The grid a datamodule's batches lie on."""

    horizontal: HorizontalCoordinates
    sigma: Optional[SigmaCoordinates] = None
