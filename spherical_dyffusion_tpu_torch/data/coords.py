"""Coordinate metadata: hybrid sigma-pressure levels and lat-lon grids.

Counterpart of ``spherical_dyffusion_tpu/data/coords.py`` as far as the
sources return it: ``SigmaCoordinates`` and ``HorizontalCoordinates``, numpy
arrays as in the JAX package; ``HorizontalCoordinates.area_weights`` gives a
float32 CPU tensor, which the aggregators move to their tensors' device.
``GridMetadata`` bundles them for the datamodules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..evaluation.metrics import spherical_area_weights

__all__ = ["SigmaCoordinates", "HorizontalCoordinates", "GridMetadata"]


@dataclasses.dataclass(frozen=True)
class SigmaCoordinates:
    """Hybrid sigma-pressure vertical coordinate: p_interface = ak + ps * bk."""

    ak: np.ndarray  # (K+1,)
    bk: np.ndarray  # (K+1,)


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
class GridMetadata:
    """The grid a datamodule's batches lie on."""

    horizontal: HorizontalCoordinates
    sigma: Optional[SigmaCoordinates] = None
