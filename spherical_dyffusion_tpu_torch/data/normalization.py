"""Standard (z-score) normalization over packed channel vectors.

Counterpart of ``spherical_dyffusion_tpu/data/normalization.py``: built from
in-memory statistics (``from_dicts``) or, by ``get_normalizer``, from the
``centering.nc`` / ``scaling.nc`` statistics files. ``subset`` selects the channels of
another name list, as the rollout does for its output normalizer; ``to``
moves the statistics to the device once, so that ``normalize`` does not
copy them at every call. ``normalize_dict`` and ``denormalize_dict`` act on
named fields, and ``get_state`` / ``from_state`` are the JAX package's
serializable form ({"means": {name: float}, "stds": {name: float}}).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import torch

from ..utils.device import to_device
from .netcdf import read_scalar_dataset

__all__ = ["StandardNormalizer", "get_normalizer"]


@dataclasses.dataclass(frozen=True)
class StandardNormalizer:
    """Per-channel z-score normalizer aligned with a Packer's channel order."""

    means: torch.Tensor  # (C,)
    stds: torch.Tensor  # (C,)
    names: tuple = None

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.means.to(x.device)) / self.stds.to(x.device)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.stds.to(x.device) + self.means.to(x.device)

    def normalize_dict(self, d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        idx = {n: i for i, n in enumerate(self.names)}
        return {k: (v - self.means[idx[k]].to(v.device)) / self.stds[idx[k]].to(v.device)
                for k, v in d.items()}

    def denormalize_dict(self, d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        idx = {n: i for i, n in enumerate(self.names)}
        return {k: v * self.stds[idx[k]].to(v.device) + self.means[idx[k]].to(v.device)
                for k, v in d.items()}

    def get_state(self) -> dict:
        means, stds = self.means.tolist(), self.stds.tolist()
        return {"means": dict(zip(self.names, means)), "stds": dict(zip(self.names, stds))}

    @classmethod
    def from_state(cls, state: dict) -> "StandardNormalizer":
        names = tuple(state["means"].keys())
        return cls.from_dicts(state["means"], state["stds"], names)

    def to(self, device) -> "StandardNormalizer":
        return dataclasses.replace(self, means=to_device(self.means, device),
                                   stds=to_device(self.stds, device))

    def subset(self, names: Sequence[str]) -> "StandardNormalizer":
        idx = {n: i for i, n in enumerate(self.names)}
        sel = torch.tensor([idx[n] for n in names], dtype=torch.long)
        return StandardNormalizer(means=self.means[sel], stds=self.stds[sel], names=tuple(names))

    @classmethod
    def from_dicts(cls, means: Mapping[str, float], stds: Mapping[str, float],
                   names: Sequence[str]) -> "StandardNormalizer":
        return cls(means=torch.tensor([means[n] for n in names], dtype=torch.float32),
                   stds=torch.tensor([stds[n] for n in names], dtype=torch.float32),
                   names=tuple(names))


def get_normalizer(global_means_path: str, global_stds_path: str,
                   names: Sequence[str]) -> StandardNormalizer:
    """A normalizer over ``names`` from the centering.nc / scaling.nc
    statistics files of the reference's ``data_statistics/``; raises
    ``KeyError`` naming the variables either file lacks."""
    means = read_scalar_dataset(global_means_path)
    stds = read_scalar_dataset(global_stds_path)
    missing = [n for n in names if n not in means or n not in stds]
    if missing:
        raise KeyError(f"Variables missing from normalization stats: {missing}")
    return StandardNormalizer.from_dicts(means, stds, names)
