"""Build and load the port's hand-written CUDA kernels.

Every ``.cu`` file under ``spherical_dyffusion_tpu_torch/csrc/`` is compiled by
its own ``nvcc`` process, all started together (the ``.cuh`` headers there are
included by them), and the objects are linked
into one shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``. No PyTorch header is involved, so the build takes seconds, not
minutes. The library lands in
``spherical_dyffusion_tpu_torch/build/<hash of the sources and headers>/`` (listed in
``.gitignore``) and is built at first use; a finished build is reused by later
calls in the same checkout. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["library", "build_info", "check", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ROW_MAP = [_I] * 5  # K2/K3's dropout row map (csrc/fused_mlp.cu, RowMap)
_SIGNATURES = {
    "sdt_dhconv_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sdt_dhconv_weight_image": [_P, _P, _I, _I, _I, _I, _P],
    "sdt_dhconv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sdt_fused_mlp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      ctypes.c_ulonglong, _I] + _ROW_MAP + [_P],
    "sdt_fused_block_tail": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, ctypes.c_ulonglong, _I] + _ROW_MAP + [_P],
    "sdt_fused_mlp_tc": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_ulonglong, _I] + _ROW_MAP + [_P],
    "sdt_weight_image": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sdt_fused_rank": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_state: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _build() -> dict:
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    # the headers too: an edited header must not reuse a stale library
    for src in sorted(sources + list(_CSRC.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_ARCH + _FLAGS).encode())
    out_dir = _BUILD / digest.hexdigest()[:16]
    lib = out_dir / "libsdt_kernels.so"
    log = out_dir / "ptxas.txt"
    nvcc = _nvcc()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "cached": True, "nvcc": nvcc,
                "ptxas": log.read_text() if log.exists() else ""}
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build into a temporary directory and rename the library: concurrent
    # first uses never load a half-written one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", "-o", str(Path(tmp) / (src.stem + ".o")),
                   str(src)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        outputs = [(src, proc.communicate()[0], proc.returncode) for src, proc in procs]
        text = "".join(f"== {src.name}\n{out}" for src, out, _ in outputs)
        failed = [src.name for src, _, code in outputs if code != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{text}")
        so = Path(tmp) / "libsdt_kernels.so"
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(so),
                               *(str(Path(tmp) / (src.stem + ".o")) for src in sources)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking the kernels failed ({proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(so, lib)
    seconds = time.perf_counter() - t0
    log.write_text(text)
    return {"path": str(lib), "seconds": seconds, "cached": False, "nvcc": nvcc,
            "ptxas": text}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    if "lib" not in _state:
        info = _build()
        lib = ctypes.CDLL(info["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state["info"] = info
        _state["lib"] = lib
    return _state["lib"]


def build_info() -> dict:
    """Path, wall seconds, cache hit, the ``nvcc`` used and the ``-Xptxas -v``
    output of the build."""
    library()
    return dict(_state["info"])


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a failed launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {code}")


def stream_ptr(device: torch.device) -> int:
    """The current stream of ``device`` (a CUDA tensor's device, which has
    an index), through torch's raw getter, what its own generated kernels
    use (torch >= 2.0, CUDA builds): a tenth of the host time of building a
    ``torch.cuda.Stream``, which at small shapes is a call's time."""
    return torch._C._cuda_getCurrentRawStream(device.index)
