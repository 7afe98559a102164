"""Spectral-weight contractions of the SFNO filter, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/ops/contractions.py`` for the dense,
non-separable Driscoll-Healy contraction (``contract_dhconv``, which on the
stacked layout is also the JAX package's ``contract_dhconv_stacked4``, and
the ``contract`` dispatch) and for the CP-factorized filter: the
spectral-space ``contract_dhconv_cp`` and the three stages of the rank
pipeline (``cp_spatial_project``, ``cp_spectral_scale_stacked``,
``cp_spatial_expand``). Spectral tensors use the stacked real layout
``(..., l, m, c, 2)`` of ``ops/sht.py``; weights keep the JAX package's
layouts (``(c_in, c_out, l, 2)``; CP factors ``A (c_in, R, 2)``,
``B (c_out, R, 2)``, ``C (l, R, 2)``), so weights carry over as they are.

``matmul_dtype`` rounds both operands of each product and keeps the float32
sums, and ``out_dtype`` rounds a stage's output, at the JAX package's
rounding points (``ops/matmul.py``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from .matmul import einsum, emit

__all__ = ["contract_dhconv", "contract", "contract_dhconv_cp", "cp_spatial_project",
           "cp_spectral_scale_stacked", "cp_spatial_expand"]


def contract_dhconv(x: torch.Tensor, w: torch.Tensor,
                    matmul_dtype: Optional[torch.dtype] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Driscoll-Healy conv: x ``(..., l, m, ci, 2)``, w ``(ci, co, l, 2)`` ->
    ``(..., l, m, co, 2)``, as four real batched products over l:
    ``yr = xr wr - xi wi`` and ``yi = xr wi + xi wr``.

    In float32 this is also the plain version of the K1 kernel
    (``ops/pallas_contractions.py:dhconv``)."""
    xr, xi = x[..., 0], x[..., 1]
    wr, wi = w[..., 0], w[..., 1]

    def mm(a, b):
        return einsum("...lmi,iol->...lmo", a, b, matmul_dtype)

    yr = mm(xr, wr) - mm(xi, wi)
    yi = mm(xr, wi) + mm(xi, wr)
    return emit(torch.stack([yr, yi], dim=-1), out_dtype)


def contract(x: torch.Tensor, w: torch.Tensor, use_pallas: bool = False,
             matmul_dtype: Optional[torch.dtype] = None,
             out_dtype: Optional[torch.dtype] = None,
             image: Optional[torch.Tensor] = None,
             image_t: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Dispatch of the dense dhconv contraction. ``use_pallas`` routes it
    through the hand-written kernel K1 (the JAX package's flag name: there it
    selects the Pallas kernel), which, like the Pallas kernel, computes in
    float32 whatever the matmul dtype and is differentiable; ``image`` is w's
    K1 weight image, made once by the caller, and ``image_t`` gives the
    backward's (``ops/pallas_contractions.py:dhconv``)."""
    if use_pallas:
        from .pallas_contractions import dhconv

        return emit(dhconv(x, w, image, image_t), out_dtype)
    return contract_dhconv(x, w, matmul_dtype, out_dtype)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def contract_dhconv_cp(x: torch.Tensor, factors: Mapping[str, torch.Tensor],
                       matmul_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """CP-factorized Driscoll-Healy contraction in spectral space:
    ``weight[ci, co, l] = sum_r A[ci, r] B[co, r] C[l, r]`` (complex), so
    ``y = ((x @ A) * C[l]) @ B^T``. x ``(..., l, m, ci, 2)`` ->
    ``(..., l, m, co, 2)`` float32; ``factors`` holds "A", "B" and "C"."""
    A, B, C = factors["A"], factors["B"], factors["C"]

    def mm(a, b, sub="...lmi,ir->...lmr"):
        return einsum(sub, a, b, matmul_dtype)

    xr, xi = x[..., 0], x[..., 1]
    pr = mm(xr, A[..., 0]) - mm(xi, A[..., 1])
    pi = mm(xr, A[..., 1]) + mm(xi, A[..., 0])
    sr, si = _cmul(pr, pi, C[..., 0][:, None, :].float(), C[..., 1][:, None, :].float())
    Bt_r, Bt_i = B[..., 0].T, B[..., 1].T
    yr = mm(sr, Bt_r, "...lmr,ro->...lmo") - mm(si, Bt_i, "...lmr,ro->...lmo")
    yi = mm(sr, Bt_i, "...lmr,ro->...lmo") + mm(si, Bt_r, "...lmr,ro->...lmo")
    return torch.stack([yr, yi], dim=-1)


def cp_spatial_project(x: torch.Tensor, A: torch.Tensor,
                       matmul_dtype: Optional[torch.dtype] = None,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rank pipeline stage 1: the CP input projection in grid space,
    ``SHT(x) @ A = SHT(x @ Ar) + i SHT(x @ Ai)``. x ``(..., h, w, ci)``,
    A ``(ci, R, 2)`` -> ``(..., h, w, 2R)`` with channels
    ``[x @ Ar | x @ Ai]``."""
    A2 = torch.cat([A[..., 0], A[..., 1]], dim=-1)
    return emit(einsum("...hwc,cr->...hwr", x, A2, matmul_dtype), out_dtype)


def cp_spectral_scale_stacked(zs: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Rank pipeline stage 2: the per-l complex scale on the stacked layout.

    zs ``(..., l, m, 2R, 2)``: the SHT of ``cp_spatial_project``'s output,
    channels ``[SHT(x@Ar) | SHT(x@Ai)]``; the rank spectrum is
    ``p = S_r + i S_i``. Returns ``s = p * C[l]`` as the stacked pair
    ``[s | i s]`` ``(..., l, m, 2R, 2)`` float32, which lets the output
    projection B move after the (real-linear) inverse transform. Computed in
    float32 whatever zs's dtype; C ``(l, R, 2)``."""
    R = zs.shape[-2] // 2
    zs = zs.float()
    Sr, Si = zs[..., :R, :], zs[..., R:, :]
    p_re = Sr[..., 0] - Si[..., 1]
    p_im = Sr[..., 1] + Si[..., 0]
    Cr = C[..., 0][:, None, :].float()
    Ci = C[..., 1][:, None, :].float()
    s_re, s_im = _cmul(p_re, p_im, Cr, Ci)
    return torch.cat([torch.stack([s_re, s_im], dim=-1), torch.stack([-s_im, s_re], dim=-1)],
                     dim=-2)


def cp_spatial_expand(g: torch.Tensor, B: torch.Tensor,
                      matmul_dtype: Optional[torch.dtype] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rank pipeline stage 3: the output projection in grid space. g
    ``(..., h, w, 2R)``: the inverse SHT of the scaled pair, channels
    ``[G | H]``; B ``(co, R, 2)``. ``out_o = sum_r Br[o, r] G_r + Bi[o, r] H_r``,
    one real product -> ``(..., h, w, co)``."""
    W2 = torch.cat([B[..., 0], B[..., 1]], dim=-1).T
    return emit(einsum("...hwr,ro->...hwo", g, W2, matmul_dtype), out_dtype)
