"""ctypes binding of the host-side packer (``csrc/packer.cpp``).

The port's counterpart of ``spherical_dyffusion_tpu/utils/native.py``. The
library is built at first use with ``g++ -O3 -march=native -shared -fPIC
-pthread`` into ``spherical_dyffusion_tpu_torch/build/`` (listed in
``.gitignore``) under a name keyed on the source's hash, the machine and the
host CPU's feature flags, so that a binary built for another CPU is never
loaded. A build goes to a temporary name first and is renamed into place, so
processes that build at once never load a half-written file. It is host
C++, kept apart from the ``nvcc`` build of ``csrc/*.cu``
(``ops/_cuda.py``).

Unlike the JAX package's binding, which falls back to numpy when the library
cannot be built, this one raises: a data path that silently changes its
arithmetic is not the one that was measured. ``data/datasets.py``'s numpy
``pack_normalize`` is the plain version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["build_library", "pack_normalize"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "packer.cpp"
_BUILD = _PKG / "build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
_LIB = None


def _cpu_key() -> str:
    """A hash of the host CPU's feature flags (``-march=native`` compiles
    for them)."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:
        flags = platform.processor()
    return hashlib.sha256(flags.encode()).hexdigest()[:8]


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"libsdt_packer.{digest}.{platform.machine()}.{_cpu_key()}.so"


def build_library(force: bool = False) -> str:
    """Compile ``csrc/packer.cpp`` (unless a build for this source and CPU
    exists) and return the library's path; raises if ``g++`` fails or is
    missing."""
    so = _so_path()
    if so.exists() and not force:
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=so.name + ".", suffix=".tmp", dir=so.parent)
    os.close(fd)
    try:
        try:
            res = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                                 capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("the native packer needs g++, which was not found") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(so)


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library())
        pp = ctypes.POINTER(ctypes.c_float)
        lib.pack_normalize.argtypes = [ctypes.POINTER(pp), pp, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, pp, pp, ctypes.c_int]
        lib.pack_normalize.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def pack_normalize(arrays: Sequence[np.ndarray], means: Optional[np.ndarray] = None,
                   stds: Optional[np.ndarray] = None, n_threads: int = 0) -> np.ndarray:
    """Per-variable (T, H, W) arrays -> channels-last (T, H, W, C) float32,
    z-scored per channel as ``(x - mean) * (1 / std)`` when ``means`` and
    ``stds`` are given, by the native threaded kernel (``n_threads``: at
    most 8 by default)."""
    arrays = [np.ascontiguousarray(a, np.float32) for a in arrays]
    shape = arrays[0].shape
    if any(a.shape != shape for a in arrays):
        raise ValueError(f"pack_normalize: arrays of shapes {[a.shape for a in arrays]}")
    lib = _load()
    T, hw, C = shape[0], int(np.prod(shape[1:])), len(arrays)
    dst = np.empty(shape + (C,), np.float32)
    pp = ctypes.POINTER(ctypes.c_float)
    src_ptrs = (pp * C)(*[a.ctypes.data_as(pp) for a in arrays])
    mean_ptr = std_ptr = None
    if means is not None:
        means = np.ascontiguousarray(means, np.float32)
        inv = np.ascontiguousarray(np.float32(1.0) / np.asarray(stds, np.float32), np.float32)
        mean_ptr, std_ptr = means.ctypes.data_as(pp), inv.ctypes.data_as(pp)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.pack_normalize(src_ptrs, dst.ctypes.data_as(pp), T, hw, C, mean_ptr, std_ptr, n_threads)
    return dst
