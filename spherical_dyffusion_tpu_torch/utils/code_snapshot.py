"""Run code snapshots.

Counterpart of ``spherical_dyffusion_tpu/utils/code_snapshot.py`` (copied:
the port imports nothing of the JAX package). The snapshot is one
deterministic tar.gz of the package's source files, written beside a run's
checkpoints (``Trainer._save_epoch``), as the reference's ``log_code`` leg
keeps the source of every run. The port's kernels (``.cu``, ``.cuh``) and
its JSON configs are part of its source, as the YAML is the JAX package's,
so they ride too; the kernels' build directory (``build/``, the compiled
library) does not.

Deterministic: gzip mtime 0, tar members with mtime 0, uid and gid 0, empty
owner names, and a sorted walk, so that identical source trees give
byte-identical archives.
"""

from __future__ import annotations

import gzip
import io
import os
import tarfile
from typing import Optional, Sequence

__all__ = ["snapshot_code"]

_EXTS = (".py", ".yaml", ".yml", ".cpp", ".h", ".md", ".cu", ".cuh", ".json")
_EXCLUDE_DIRS = {"__pycache__", ".git", ".jax_cache", "checkpoints", "logs",
                 "results", "wandb", "build"}


def _iter_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _EXCLUDE_DIRS
                             and not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(_EXTS):
                yield os.path.join(dirpath, fn)


def snapshot_code(out_path: str, roots: Optional[Sequence[str]] = None) -> str:
    """Write a deterministic tar.gz of the source files under ``roots``
    (default: the ``spherical_dyffusion_tpu_torch`` package) to
    ``out_path``; returns ``out_path``."""
    if roots is None:
        roots = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as raw:
        with gzip.GzipFile(fileobj=raw, filename="", mode="wb", mtime=0) as gz, \
                tarfile.open(fileobj=gz, mode="w") as tar:
            for root in roots:
                root = os.path.abspath(root)
                base = os.path.basename(root.rstrip(os.sep))
                for path in _iter_files(root):
                    arcname = os.path.join(base, os.path.relpath(path, root))
                    with open(path, "rb") as f:
                        data = f.read()
                    info = tarfile.TarInfo(arcname)
                    info.size = len(data)
                    info.mtime = 0
                    info.uid = info.gid = 0
                    info.uname = info.gname = ""
                    tar.addfile(info, io.BytesIO(data))
    return out_path
