"""Minimal netCDF-4 reading over ``data/hdf5.py`` (no h5py).

Counterpart of ``spherical_dyffusion_tpu/data/netcdf.py``, with its names
and semantics: ``NetCDFFile`` lists the variables of a file (not the
phony dimension scales netCDF adds for dimensions without a variable),
reads their dimension names, shapes, values (whole or a slice of the
leading axis, with the CF ``_FillValue``, ``scale_factor`` and
``add_offset`` applied as the JAX module applies them) and attributes;
``read_scalar_dataset`` reads a file of scalar variables (the
``centering.nc`` / ``scaling.nc`` statistics files) into ``{name: float}``.
The values have h5py's types, so the promotions of ``read`` are the JAX
module's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from . import hdf5

__all__ = ["NetCDFFile", "read_scalar_dataset"]


_PHONY = "This is a netCDF dimension but not a netCDF variable"


@dataclasses.dataclass
class NetCDFFile:
    """Lazy reader over a netCDF-4 (HDF5) file."""

    path: str

    def __post_init__(self):
        self._f = hdf5.File(self.path)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _is_dim_only(self, name: str) -> bool:
        ds = self._f[name]
        return ds.attrs.get("NAME", b"").startswith(_PHONY.encode()) if "NAME" in ds.attrs else False

    @property
    def variables(self) -> List[str]:
        return [k for k in self._f.keys() if not self._is_dim_only(k)]

    def dims_of(self, name: str) -> tuple:
        """Dimension names of a variable, from the HDF5 dimension scales: a
        dimension's label, else the path of its first attached scale, else
        ``dim_<i>`` (h5py's ``ds.dims``)."""
        ds = self._f[name]
        labels = ds.attrs["DIMENSION_LABELS"] if "DIMENSION_LABELS" in ds.attrs else None
        scales = ds.attrs["DIMENSION_LIST"] if "DIMENSION_LIST" in ds.attrs else None
        out = []
        for i in range(len(ds.shape)):
            label = labels[i] if labels is not None else ""
            attached = scales[i] if scales is not None else ()
            out.append(label or (self._f.deref(attached[0]).name.lstrip("/") if len(attached)
                                 else f"dim_{i}"))
        return tuple(out)

    def shape(self, name: str) -> tuple:
        return self._f[name].shape

    def read(self, name: str, sl: Optional[slice] = None) -> np.ndarray:
        ds = self._f[name]
        data = ds[sl] if sl is not None else ds[()]
        # CF scale/offset and missing values, where present
        attrs = ds.attrs
        fill = attrs.get("_FillValue", None)
        data = np.asarray(data)
        if fill is not None and data.dtype.kind == "f":
            fill = np.ravel(np.asarray(fill))[0]
            if not np.isnan(fill):
                data = np.where(data == fill, np.nan, data).reshape(data.shape)
        scale = attrs.get("scale_factor", None)
        offset = attrs.get("add_offset", None)
        if scale is not None or offset is not None:
            data = data * (scale if scale is not None else 1.0) + (
                offset if offset is not None else 0.0
            )
        return data

    def attr(self, name: str, attr: str, default: Any = None) -> Any:
        return self._f[name].attrs.get(attr, default)


def read_scalar_dataset(path: str) -> Dict[str, float]:
    """Read a file of scalar variables (the data_statistics centering/scaling
    files) into {name: float}."""
    out: Dict[str, float] = {}
    with NetCDFFile(path) as f:
        for name in f.variables:
            arr = np.asarray(f.read(name))
            if arr.ndim == 0:
                out[name] = float(arr)
    return out
