"""K4: the CP rank pipeline's spectral middle as a hand-written CUDA kernel.

Counterpart of the Pallas prototype ``scripts/proto_fused_rank.py``
(``fused_kernel``, called through ``make_fused``), which fuses the three
spectral stages of the CP rank pipeline (``models/sfno.py``'s
``rank_pipeline`` branch in the JAX package) for each azimuthal order m:

    t[l, m, c] = sum_h A[h, l, m] xf[h, m, c]      Legendre analysis
    s[l, m, :] = [p C[l] | i p C[l]],  p = S_r + i S_i   per-l CP scale
    y[h, m, c] = sum_l S[h, l, m] s[l, m, c]        Legendre synthesis

so the ``(l, m, 2R, 2)`` intermediates never reach device memory. The kernel
is ``csrc/fused_rank.cu``; its source note says what bounds it on the H100
and how it is tiled. ``fused_rank`` launches it for CUDA tensors and counts
the launch in ``fused_rank.launches``; for CPU tensors it computes the plain
version, ``fused_rank_plain``. There is no fallback: a CUDA tensor that the
kernel cannot take raises. In bf16 and in float16 both products run on the
tensor cores (one instance of the kernel for each type); in float32 the
kernel stays on the CUDA cores, for the float32 checks.

The Legendre triangle: A[m] and S[m] vanish for l < m. The transforms
record once (``kernel_layout=True``, ``ops/sht.py``'s ``legendre_l_first``),
per m, the first l at which their matrix is non-zero; the model passes the
smaller of the two records as ``l_first``, and the kernel runs both products
only from there (rounded down to 16). Rows of t below it are
exactly zero and meet zero columns of S, so the skip changes no sum; for
matrices without such zeros ``l_first`` is 0 and nothing is skipped.

Layout is the port's, not the prototype's: xf and y are
``(B, h, m, 2R, 2)`` (the DFT stage's output and the inverse DFT's input,
channels ``[x@Ar | x@Ai]`` with a trailing (re, im) axis), the matrices are
``(m, h, l)`` in the matmul dtype (made once per model by the transforms,
``kernel_layout=True``), C is the float32 CP factor ``(l, R, 2)``.

The synthesis has its own row count: S_t may hold ``h_out`` rows of the
synthesis matrix, ``(m, h_out, l)``, and y is then ``(B, h_out, m, 2R, 2)``.
On a grid split over latitudes (``models/sfno.py``) a rank runs the whole
analysis over every latitude's xf and synthesizes only its block's rows.

Rounding points are the model path's under ``sht_matmul_dtype`` =
``spectral_io_dtype`` = bfloat16 (float16 alike): products of bf16 operands
summed in float32; t rounded to bf16 (the SHT's ``_emit``), the scale
computed in float32 from it and rounded to bf16 (the inverse SHT's operand
rounding), y rounded to bf16 (the inverse SHT's ``_emit``). In float32
nothing is rounded. Kernel and plain version then differ only in the order
of sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .contractions import cp_spectral_scale_stacked
from .fused_mlp import refuse_grad
from .matmul import einsum

__all__ = ["fused_rank", "fused_rank_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_rank_plain(xf: torch.Tensor, A_t: torch.Tensor, S_t: torch.Tensor,
                     C: torch.Tensor) -> torch.Tensor:
    """The three stages as torch products with K4's rounding points:
    xf ``(B, h, m, 2R, 2)``, A_t ``(m, h, l)`` and S_t ``(m, h_out, l)`` in
    one dtype (float32, bf16 or float16), C ``(l, R, 2)`` ->
    ``(B, h_out, m, 2R, 2)`` in that dtype."""
    dtype = xf.dtype
    t = einsum("bhmcr,mhl->blmcr", xf, A_t, dtype).to(dtype)
    s = cp_spectral_scale_stacked(t, C).to(dtype)
    return einsum("blmcr,mhl->bhmcr", s, S_t, dtype).to(dtype)


def fused_rank(xf: torch.Tensor, A_t: torch.Tensor, S_t: torch.Tensor,
               C: torch.Tensor, l_first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused Legendre analysis, CP scale and Legendre synthesis; arguments
    and result as ``fused_rank_plain``. ``l_first`` ``(m,)`` int32: per m, an
    l before which A_t[m] and S_t[m] are zero (the transforms' record);
    without it nothing is skipped. Forward only: raises under autograd
    (``refuse_grad``)."""
    refuse_grad("fused_rank", xf, A_t, S_t, C)
    if xf.device.type == "cpu":
        return fused_rank_plain(xf, A_t, S_t, C)
    if xf.device.type != "cuda":
        raise ValueError(f"fused_rank: unsupported device {xf.device}")
    if xf.dtype not in _DTYPE_CODES or A_t.dtype != xf.dtype or S_t.dtype != xf.dtype \
            or C.dtype != torch.float32:
        raise TypeError(f"fused_rank: xf, A_t and S_t in one dtype (float32, bfloat16 or "
                        f"float16) and C float32 required, got {xf.dtype}, {A_t.dtype}, "
                        f"{S_t.dtype}, {C.dtype}")
    if any(t.device != xf.device for t in (A_t, S_t, C)):
        raise ValueError("fused_rank: all operands must lie on xf's device")
    if xf.dim() != 5 or xf.shape[-1] != 2 or xf.shape[-2] % 2 or A_t.dim() != 3 \
            or S_t.dim() != 3 or S_t.shape[::2] != A_t.shape[::2] or S_t.shape[1] < 1 \
            or C.dim() != 3 or C.shape[-1] != 2:
        raise ValueError(f"fused_rank: bad shapes xf {tuple(xf.shape)}, A_t "
                         f"{tuple(A_t.shape)}, S_t {tuple(S_t.shape)}, C {tuple(C.shape)}")
    B, H, M, R2 = xf.shape[:4]
    R = R2 // 2
    L = A_t.shape[2]
    if A_t.shape[:2] != (M, H) or C.shape[:2] != (L, R):
        raise ValueError(f"fused_rank: A_t {tuple(A_t.shape)} and C {tuple(C.shape)} do "
                         f"not match xf {tuple(xf.shape)}")
    if L > 192 or M > 65535 or B > 65535:
        raise ValueError(f"fused_rank: l = {L} > 192, m = {M} or B = {B} beyond the grid")
    if not all(t.is_contiguous() for t in (xf, A_t, S_t, C)):
        raise ValueError("fused_rank: operands must be contiguous")
    if l_first is None:
        l_first = torch.zeros(M, dtype=torch.int32, device=xf.device)
    if l_first.shape != (M,) or l_first.dtype != torch.int32 or l_first.device != xf.device:
        raise ValueError(f"fused_rank: l_first must be int32 ({M},) on xf's device, got "
                         f"{l_first.dtype} {tuple(l_first.shape)}")
    H_out = S_t.shape[1]
    y = xf.new_empty((B, H_out) + tuple(xf.shape[2:]))
    lib = _cuda.library()
    _cuda.check(lib.sdt_fused_rank(xf.data_ptr(), A_t.data_ptr(), S_t.data_ptr(), C.data_ptr(),
                                   l_first.contiguous().data_ptr(), y.data_ptr(), B, H, H_out,
                                   M, L, R, _DTYPE_CODES[xf.dtype], _cuda.stream_ptr(xf.device)),
                "fused_rank")
    fused_rank.launches += 1
    return y


fused_rank.launches = 0
