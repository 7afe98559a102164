"""Wind-vector coordinate conversions on the sphere.

Counterpart of ``spherical_dyffusion_tpu/utils/winds.py`` in torch: (u, v)
horizontal wind components to earth-centred cartesian (x, y, z) components,
and (lon, lat) to and from the unit sphere's (x, y, z). x points at (lat 0,
lon 0), y at (lat 0, lon 90E), z at the north pole; lon and lat in degrees;
u is the eastward and v the northward component. The functions take tensors
on any device (numpy arrays are converted) and compute in their dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = [
    "u_v_to_x_y_z_wind",
    "normalize_vector",
    "lon_lat_to_xyz",
    "xyz_to_lon_lat",
]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def u_v_to_x_y_z_wind(u, v, lat, lon) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, v) -> cartesian (wx, wy, wz): u times the local east unit vector
    (-sin lon, cos lon, 0) plus v times the local north unit vector
    (-sin lat cos lon, -sin lat sin lon, cos lat)."""
    u, v = _t(u), _t(v)
    lat, lon = torch.deg2rad(_t(lat)), torch.deg2rad(_t(lon))
    wx = -u * torch.sin(lon) - v * torch.sin(lat) * torch.cos(lon)
    wy = u * torch.cos(lon) - v * torch.sin(lat) * torch.sin(lon)
    wz = v * torch.cos(lat)
    return wx, wy, wz


def normalize_vector(*components) -> torch.Tensor:
    """The vector of the given per-axis components divided by its norm,
    stacked along a new leading axis."""
    stacked = torch.stack([_t(c) for c in components])
    norm = torch.sqrt(torch.sum(stacked ** 2, dim=0))
    return stacked / norm


def lon_lat_to_xyz(lon, lat) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lon, lat) in degrees -> unit-sphere (x, y, z)."""
    lat, lon = torch.deg2rad(_t(lat)), torch.deg2rad(_t(lon))
    x = torch.cos(lat) * torch.cos(lon)
    y = torch.cos(lat) * torch.sin(lon)
    z = torch.sin(lat)
    xyz = normalize_vector(x, y, z)
    return xyz[0], xyz[1], xyz[2]


def xyz_to_lon_lat(x, y, z) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-sphere (x, y, z) -> (lon, lat) in degrees, lon in [0, 360).
    Points on the polar axis (|x| + |y| < 1e-10) get lon 0."""
    xyz = normalize_vector(x, y, z)
    x, y, z = xyz[0], xyz[1], xyz[2]
    on_axis = torch.abs(x) + torch.abs(y) < 1.0e-10
    lon = torch.where(on_axis, torch.zeros_like(x), torch.atan2(y, x))
    lon = torch.where(lon < 0.0, lon + 2 * math.pi, lon)
    lat = torch.asin(torch.clamp(z, -1.0, 1.0))
    return torch.rad2deg(lon), torch.rad2deg(lat)
