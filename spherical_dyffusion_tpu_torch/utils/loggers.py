"""Experiment tracking: local metric logging.

Counterpart of ``spherical_dyffusion_tpu/utils/loggers.py`` without its
wandb mirror: the record is a local JSONL file (one metric dict per line,
with step and time). A config's ``logger.wandb`` section raises
``NotImplementedError`` (ROADMAP Queue 1 item 8, the network clients).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = ["JsonlLogger", "MultiLogger", "make_logger", "run_name_from_config"]


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


class MultiLogger:
    def __init__(self, loggers: List[Any]):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_hyperparams(self, config):
        for lg in self.loggers:
            lg.log_hyperparams(config)

    def log(self, metrics, step=None):
        for lg in self.loggers:
            lg.log(metrics, step=step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()


def make_logger(cfg: Dict[str, Any], out_dir: str = "logs"):
    """Loggers from a config's ``logger:`` section: the JSONL file under
    ``out_dir/<run name>``."""
    log_cfg = cfg.get("logger", {}) or {}
    if log_cfg.get("wandb"):
        raise NotImplementedError("logger.wandb: the wandb mirror is not ported (ROADMAP "
                                  "Queue 1 item 8, the network clients); remove the section")
    name = cfg.get("name") or run_name_from_config(cfg)
    return MultiLogger([JsonlLogger(os.path.join(out_dir, name))])


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
