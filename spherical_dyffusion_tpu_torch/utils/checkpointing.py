"""Checkpoint path resolution.

Counterpart of ``resolve_checkpoint_path`` and ``find_checkpoint_in_dir`` of
``spherical_dyffusion_tpu/utils/checkpointing.py``: local files, and
directories searched for their newest ``*.ckpt``. The network channels
(``hf:`` HuggingFace Hub, ``wandb:`` run restore) are not ported: they raise
``NotImplementedError`` (ROADMAP Queue 1 item 8, the network clients).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

__all__ = ["resolve_checkpoint_path", "find_checkpoint_in_dir"]

HF_PREFIX = "hf:"
WANDB_PREFIX = "wandb:"


def resolve_checkpoint_path(path: str) -> str:
    """A checkpoint spec -> a local file path: the file itself, or the
    newest ``*.ckpt`` under a directory."""
    for prefix, what in ((HF_PREFIX, "HuggingFace Hub"), (WANDB_PREFIX, "wandb")):
        if path.startswith(prefix):
            raise NotImplementedError(
                f"{path!r}: {what} checkpoints are not ported (ROADMAP Queue 1 item 8, the "
                "network clients); pass a local file")
    if os.path.isdir(path):
        found = find_checkpoint_in_dir(path)
        if found is None:
            raise FileNotFoundError(f"No *.ckpt under {path}")
        return found
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def find_checkpoint_in_dir(d: str, pattern: str = "*.ckpt") -> Optional[str]:
    """The most recently modified file matching ``pattern`` under ``d``."""
    cands = sorted(glob.glob(os.path.join(d, "**", pattern), recursive=True),
                   key=os.path.getmtime)
    return cands[-1] if cands else None
