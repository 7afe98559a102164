"""Local experiment-tracking query API.

A copy of ``spherical_dyffusion_tpu/utils/runs_api.py`` (numpy and json
only; the port imports nothing of the JAX package): runs, their configs and
metric histories, read from the ``config.json`` and ``metrics.jsonl`` files
that ``utils/loggers.py:JsonlLogger`` writes under a log directory.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Run", "RunsApi"]


@dataclasses.dataclass
class Run:
    """One logged run: its config and metric history."""

    name: str
    path: str

    @property
    def config(self) -> Dict[str, Any]:
        p = os.path.join(self.path, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def history(self, keys: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
        p = os.path.join(self.path, "metrics.jsonl")
        rows = []
        if os.path.exists(p):
            with open(p) as f:
                for line in f:
                    row = json.loads(line)
                    if keys is None or any(k in row for k in keys):
                        rows.append(row)
        return rows

    def metric_array(self, key: str) -> np.ndarray:
        """(step, value) pairs for one metric (reference metric-history arrays)."""
        rows = [(r.get("_step"), r[key]) for r in self.history([key]) if key in r]
        return np.asarray(rows, dtype=np.float64) if rows else np.zeros((0, 2))

    def summary(self) -> Dict[str, float]:
        """Last logged value per metric key."""
        out: Dict[str, float] = {}
        for row in self.history():
            for k, v in row.items():
                if not k.startswith("_") and isinstance(v, (int, float)):
                    out[k] = v
        return out

    def best(self, key: str, mode: str = "min") -> Optional[float]:
        arr = self.metric_array(key)
        if arr.size == 0:
            return None
        return float(arr[:, 1].min() if mode == "min" else arr[:, 1].max())

    def checkpoint_path(self, ckpt_dir: str = "checkpoints") -> Optional[str]:
        cand = os.path.join(ckpt_dir, f"{self.name}_last.ckpt")
        return cand if os.path.exists(cand) else None


class RunsApi:
    """Query runs under a log directory (reference get_runs/filter DSL)."""

    def __init__(self, log_dir: str = "logs"):
        self.log_dir = log_dir

    def runs(self, name_filter: Optional[str] = None,
             config_filters: Optional[Dict[str, Any]] = None) -> List[Run]:
        out = []
        for d in sorted(glob.glob(os.path.join(self.log_dir, "*"))):
            if not os.path.isdir(d):
                continue
            run = Run(name=os.path.basename(d), path=d)
            if name_filter and name_filter not in run.name:
                continue
            if config_filters:
                cfg = run.config
                if not all(_lookup(cfg, k) == v for k, v in config_filters.items()):
                    continue
            out.append(run)
        return out

    def get_run(self, name: str) -> Optional[Run]:
        d = os.path.join(self.log_dir, name)
        return Run(name=name, path=d) if os.path.isdir(d) else None

    def best_run(self, metric: str, mode: str = "min",
                 **filters) -> Optional[Run]:
        """The run with the best value of a metric (ckpt-selection parity with
        the reference's best-ckpt queries)."""
        best, best_v = None, None
        for run in self.runs(**filters):
            v = run.best(metric, mode)
            if v is None:
                continue
            if best_v is None or (v < best_v if mode == "min" else v > best_v):
                best, best_v = run, v
        return best


def _lookup(cfg: Dict[str, Any], dotted: str):
    node: Any = cfg
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node
