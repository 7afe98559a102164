"""Sharded checkpoints on ``torch.distributed.checkpoint``.

Counterpart of ``spherical_dyffusion_tpu/utils/orbax_ckpt.py``, with its
API: ``save_orbax(path, state, config)``, ``restore_orbax(path, template)``
returning ``(payload, config)``, and ``OrbaxCheckpointManager(directory,
max_to_keep)`` with ``save``, ``restore`` and ``all_steps``. The payload is
JAX's: ``params`` and ``ema_params`` (``state_dict``s; ``ema_params`` None
without an EMA) and ``step``. The default checkpoint stays the single file
of ``interface.py``; this is the format for runs whose state is sharded.

Where JAX uses Orbax, the port uses PyTorch's distributed checkpoint (DCP):
each rank writes its shards and a restore reads them into the template's
tensors, which may live on the card or be sharded over a process group, as
Orbax restores onto a mesh. It also works in one process without a process
group. The on-disk format is DCP's: a directory that Orbax wrote (JAX's
``save_orbax``) cannot be read without tensorstore, and ``restore_orbax``
raises on it, saying so.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

__all__ = ["save_orbax", "restore_orbax", "OrbaxCheckpointManager"]

_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding")


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _payload(state) -> Dict[str, Any]:
    """The JAX payload of a port ``TrainState`` (``model``, ``ema``,
    ``step``) or of a mapping that already holds ``params``,
    ``ema_params`` and ``step``."""
    if isinstance(state, Mapping):
        return {"params": dict(state["params"]), "ema_params": state.get("ema_params"),
                "step": int(state["step"])}
    ema = getattr(state, "ema", None)
    return {"params": dict(state.model.state_dict()),
            "ema_params": dict(ema.state_dict()) if ema is not None else None,
            "step": int(state.step)}


def _flat(payload: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out = {f"params.{k}": v for k, v in payload["params"].items()}
    if payload.get("ema_params") is not None:
        out.update({f"ema_params.{k}": v for k, v in payload["ema_params"].items()})
    step = payload["step"]
    out["step"] = step if isinstance(step, torch.Tensor) else torch.tensor(int(step))
    return out


def _unflat(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    params = {k[len("params."):]: v for k, v in flat.items() if k.startswith("params.")}
    ema = {k[len("ema_params."):]: v for k, v in flat.items() if k.startswith("ema_params.")}
    return {"params": params, "ema_params": ema or None, "step": int(flat["step"])}


def _quiet(fn, *args, **kwargs):
    """DCP warns that it assumes one process when no group is initialized;
    that is the intended use here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*torch.distributed is disabled.*")
        return fn(*args, **kwargs)


def _is_writer() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_orbax(path: str, state, config: Optional[Dict[str, Any]] = None) -> None:
    """Save ``state``'s params, EMA params and step to the directory
    ``path`` (replacing a DCP checkpoint there), and ``config`` beside them
    as ``config.json``."""
    path = os.path.abspath(path)
    if _is_writer() and os.path.isdir(path):
        if os.path.exists(os.path.join(path, ".metadata")):
            shutil.rmtree(path)
        elif os.listdir(path):
            raise FileExistsError(f"{path} exists and is not a checkpoint; not overwriting it")
    flat = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(_payload(state)).items()}
    _quiet(_dcp().save, flat, checkpoint_id=path)
    if config is not None and _is_writer():
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)


def _check_dcp(path: str) -> None:
    if os.path.exists(os.path.join(path, ".metadata")):
        return
    if os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                   for m in _ORBAX_MARKERS):
        raise ValueError(f"{path} is an Orbax checkpoint (the JAX package's save_orbax); "
                         "reading it needs tensorstore, which the port does not use. Restore "
                         "it with the JAX package, or convert it to the port's checkpoint")
    raise FileNotFoundError(f"no checkpoint (DCP .metadata) at {path}")


def restore_orbax(path: str, template=None) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """Restore the payload from ``path``: into ``template``'s tensors (a
    payload of the same entries, or a ``TrainState``; on their devices, in
    their dtypes, in place) or, without one, as CPU tensors of the stored
    shapes and dtypes. Returns ``(payload, config or None)``."""
    dcp = _dcp()
    path = os.path.abspath(path)
    _check_dcp(path)
    if template is None:
        meta = dcp.FileSystemReader(path).read_metadata()
        flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in meta.state_dict_metadata.items()}
    else:
        flat = _flat(_payload(template))
        if not isinstance(flat["step"], torch.Tensor):
            flat["step"] = torch.tensor(int(flat["step"]))
    _quiet(dcp.load, flat, checkpoint_id=path)
    config = None
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return _unflat(flat), config


class OrbaxCheckpointManager:
    """Rolling checkpoints under ``directory``, one sub-directory per step,
    the ``max_to_keep`` latest kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state) -> None:
        save_orbax(self._path(step), state)
        if _is_writer():
            for old in self.all_steps[:-self.max_to_keep] if self.max_to_keep else []:
                shutil.rmtree(self._path(old))

    def restore(self, step: Optional[int] = None, template=None) -> Dict[str, Any]:
        steps = self.all_steps
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {self.directory}")
            step = steps[-1]
        return restore_orbax(self._path(step), template)[0]

    @property
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self._path(int(n)),
                                                                     ".metadata")))
