"""Experiment tracking: local metric logging with an optional wandb mirror.

Counterpart of ``spherical_dyffusion_tpu/utils/loggers.py``. The record is
a local JSONL file (one metric dict per line, with step and time). A
config's ``logger.wandb`` section adds ``WandbLogger``, which mirrors the
metrics, files and code snapshot to a wandb-protocol server through the
native client (``utils/wandb_client.py:NativeWandbRun``) when
``WANDB_BASE_URL`` names one, and does nothing otherwise. It never imports
the wandb SDK (JAX's uses the SDK where it is installed).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = ["JsonlLogger", "WandbLogger", "MultiLogger", "make_logger", "run_name_from_config"]


class JsonlLogger:
    """Appends one JSON object per log call to <dir>/metrics.jsonl."""

    def __init__(self, out_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a")

    def log_hyperparams(self, config: Dict[str, Any]):
        with open(os.path.join(os.path.dirname(self.path), "config.json"), "w") as f:
            json.dump(config, f, indent=1, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        row = {"_step": step, "_time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, dict):
                row[k] = v
                continue
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def finish(self):
        self._f.close()


class WandbLogger:
    """The wandb mirror over the native client, active when
    ``WANDB_BASE_URL`` names a server (the entity from ``entity``, else
    ``WANDB_ENTITY``, else "local"); a no-op otherwise, and when the run
    cannot be created there (printed). Uploads after the start are
    best-effort (``NativeWandbRun``)."""

    def __init__(self, project: str, name: Optional[str] = None,
                 entity: Optional[str] = None):
        self._native = None
        if os.environ.get("WANDB_BASE_URL"):
            from .wandb_client import NativeWandbRun

            try:
                self._native = NativeWandbRun(
                    entity or os.environ.get("WANDB_ENTITY", "local"), project, name or "run")
            except Exception as e:
                print(f"[wandb-mirror] native run init failed (disabled): {e}")

    def log_hyperparams(self, config: Dict[str, Any]):
        if self._native is not None:
            self._native.update_config(config)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if self._native is not None:
            self._native.log(metrics, step=step)

    def save_file(self, path: str, name: Optional[str] = None):
        """Upload a file into the run's files (the SDK's ``wandb.save``)."""
        if self._native is not None:
            self._native.save(path, name=name)

    def log_code(self, root: str):
        """A snapshot of the source tree into the run's files."""
        if self._native is not None:
            self._native.log_code(root)

    def finish(self):
        if self._native is not None:
            self._native.finish()


class MultiLogger:
    def __init__(self, loggers: List[Any]):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_hyperparams(self, config):
        for lg in self.loggers:
            lg.log_hyperparams(config)

    def log(self, metrics, step=None):
        for lg in self.loggers:
            lg.log(metrics, step=step)

    def save_file(self, path, name=None):
        for lg in self.loggers:
            if hasattr(lg, "save_file"):
                lg.save_file(path, name=name)

    def log_code(self, root):
        for lg in self.loggers:
            if hasattr(lg, "log_code"):
                lg.log_code(root)

    def finish(self):
        for lg in self.loggers:
            lg.finish()


def make_logger(cfg: Dict[str, Any], out_dir: str = "logs"):
    """Loggers from a config's ``logger:`` section: the JSONL file under
    ``out_dir/<run name>``, and with ``logger.wandb`` the wandb mirror
    (project ``logger.wandb.project``)."""
    log_cfg = cfg.get("logger", {}) or {}
    name = cfg.get("name") or run_name_from_config(cfg)
    loggers: List[Any] = [JsonlLogger(os.path.join(out_dir, name))]
    if log_cfg.get("wandb"):
        w = log_cfg["wandb"] or {}
        loggers.append(WandbLogger(project=w.get("project", "spherical-dyffusion-tpu"),
                                   name=name))
    return MultiLogger(loggers)


def run_name_from_config(cfg: Dict[str, Any]) -> str:
    """Compact descriptive run name (the JAX package's rule)."""
    parts = []
    exp = cfg.get("experiment", "exp")
    parts.append({"interpolation": "Ipol", "dyffusion": "DY",
                  "simultaneous": "MH"}.get(exp, exp))
    dm = cfg.get("datamodule", {})
    if dm.get("kind") == "fv3gfs":
        parts.append("FV3GFS")
    if dm.get("horizon"):
        parts.append(f"h{dm['horizon']}")
    m = cfg.get("model", {})
    kind = m.get("kind", "sfno").upper()
    dims = m.get("embed_dim") or m.get("dim")
    parts.append(f"{kind}{dims}" if dims else kind)
    if m.get("num_layers"):
        parts.append(f"L{m['num_layers']}")
    if cfg.get("seed") is not None:
        parts.append(f"seed{cfg['seed']}")
    return "-".join(str(p) for p in parts)
