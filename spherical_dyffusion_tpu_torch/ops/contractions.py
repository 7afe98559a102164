"""Spectral-weight contractions of the SFNO filter, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/ops/contractions.py``, function for
function:

- the Driscoll-Healy contraction ``contract_dhconv`` (per-l channel mixing;
  on the stacked layout it is also the JAX package's
  ``contract_dhconv_stacked4``), separable or not, and its merged
  single-product form ``contract_dhconv_stacked``;
- the per-(l, m) ``contract_diagonal``, separable or not;
- the CP-factorized filter: the spectral-space ``contract_dhconv_cp`` and
  the three stages of the rank pipeline (``cp_spatial_project``,
  ``cp_spectral_scale_stacked``, ``cp_spatial_expand``);
- the Tucker-factorized filter: the spectral-space
  ``contract_dhconv_tucker`` and the rank pipeline's per-l mix
  (``tucker_rank_kernel``, ``tucker_spectral_mix_stacked``);
- the tensor-train filter ``contract_dhconv_tt``;
- the ``contract`` dispatch, which takes K1 for a dense dhconv filter that
  is not separable and the plain functions for every other operator.

Spectral tensors use the stacked real layout ``(..., l, m, c, 2)`` of
``ops/sht.py``, and complex products are written as real products on the
pairs (no complex dtype). Weights keep the JAX package's layouts (dense
``(c_in[, c_out], l[, m], 2)``; CP and Tucker factors ``A (c_in, R, 2)``,
``B (c_out, R, 2)``, ``C (l, R, 2)``, Tucker's ``core (R, R, R, 2)``; TT's
``G1 (c_in, R, 2)``, ``G2 (R, c_out, R, 2)``, ``G3 (R, l, 2)``), so weights
carry over as they are.

``matmul_dtype`` rounds both operands of each product and keeps the float32
sums, and ``out_dtype`` rounds a stage's output, at the JAX package's
rounding points (``ops/matmul.py``).

On a grid split over a process mesh (``models/sfno.py``) a rank holds a
shard of the channels. The factorized contractions then take the rank's
rows of their input and output factors and a ``reduce`` that sums their
rank-space projection over the ranks; the rank pipeline's stages take an
``order`` of the 2R rank channels that keeps each re/im pair on one rank,
and Tucker's per-l mix a ``reduce`` that sums and scatters its output. The JAX package's spectral-space Tucker
and TT contractions compute in complex64 whatever the matmul dtype, and so
do these, in float32 pairs. Its separable products are elementwise; here
they take the operands rounded to the matmul dtype and multiply in float32.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from .matmul import einsum, emit

Reduce = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["complex_einsum", "pair_order", "contract_dhconv", "contract_dhconv_stacked", "contract_diagonal",
           "contract", "contract_dhconv_cp", "cp_spatial_project", "cp_spectral_scale_stacked",
           "cp_spatial_expand", "tucker_rank_kernel", "tucker_spectral_mix_stacked",
           "contract_dhconv_tucker", "contract_dhconv_tt"]


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def complex_einsum(eq: str, ar, ai, br, bi, matmul_dtype=None):
    """The complex product ``einsum(eq, a, b)`` of ``a = ar + i ai`` and
    ``b = br + i bi``, as four real products (``ops/matmul.py:einsum``):
    ``(re, im)``, float32."""
    def mm(a, b):
        return einsum(eq, a, b, matmul_dtype)

    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def _separable(x: torch.Tensor, w: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """Elementwise complex product of x ``(..., l, m, c, 2)`` with w broadcast
    to ``(l, m, c, 2)``, the operands rounded to the matmul dtype."""
    if matmul_dtype is not None:
        x, w = x.to(matmul_dtype), w.to(matmul_dtype)
    x, w = x.float(), w.float()
    yr, yi = _cmul(x[..., 0], x[..., 1], w[..., 0], w[..., 1])
    return torch.stack([yr, yi], dim=-1)


def contract_dhconv(x: torch.Tensor, w: torch.Tensor,
                    matmul_dtype: Optional[torch.dtype] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    separable: bool = False) -> torch.Tensor:
    """Driscoll-Healy conv: x ``(..., l, m, ci, 2)``, w ``(ci, co, l, 2)`` ->
    ``(..., l, m, co, 2)``, as four real batched products over l:
    ``yr = xr wr - xi wi`` and ``yi = xr wi + xi wr``. ``separable``: w
    ``(c, l, 2)`` scales each channel per l (an elementwise product,
    broadcast over m).

    In float32 this is also the plain version of the K1 kernel
    (``ops/pallas_contractions.py:dhconv``)."""
    if separable:
        return emit(_separable(x, w.permute(1, 0, 2)[:, None], matmul_dtype), out_dtype)
    yr, yi = complex_einsum("...lmi,iol->...lmo", x[..., 0], x[..., 1], w[..., 0], w[..., 1],
                            matmul_dtype)
    return emit(torch.stack([yr, yi], dim=-1), out_dtype)


def contract_dhconv_stacked(x: torch.Tensor, w: torch.Tensor,
                            matmul_dtype: Optional[torch.dtype] = None,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The merged form of ``contract_dhconv`` (``merged_dhconv``): the four
    real products as ONE batched product over l with the real/imaginary axes
    of both operands as free axes (M = m x 2, K = ci, N = co x 2), then the
    complex combine. x ``(..., l, m, ci, 2)``, w ``(ci, co, l, 2)``."""
    p = einsum("...lmir,iolq->...lmroq", x, w, matmul_dtype)
    yr = p[..., 0, :, 0] - p[..., 1, :, 1]
    yi = p[..., 0, :, 1] + p[..., 1, :, 0]
    return emit(torch.stack([yr, yi], dim=-1), out_dtype)


def contract_diagonal(x: torch.Tensor, w: torch.Tensor,
                      matmul_dtype: Optional[torch.dtype] = None,
                      separable: bool = False) -> torch.Tensor:
    """Per-(l, m) weights: x ``(..., l, m, ci, 2)``, w ``(ci, co, l, m, 2)``
    -> ``(..., l, m, co, 2)`` float32; ``separable``: w ``(c, l, m, 2)``,
    elementwise."""
    if separable:
        return _separable(x, w.permute(1, 2, 0, 3), matmul_dtype)
    yr, yi = complex_einsum("...lmi,iolm->...lmo", x[..., 0], x[..., 1], w[..., 0], w[..., 1],
                            matmul_dtype)
    return torch.stack([yr, yi], dim=-1)


def contract(x: torch.Tensor, w: torch.Tensor, use_pallas: bool = False,
             matmul_dtype: Optional[torch.dtype] = None,
             out_dtype: Optional[torch.dtype] = None,
             image: Optional[torch.Tensor] = None,
             image_t: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
             operator_type: str = "dhconv", separable: bool = False) -> torch.Tensor:
    """Dispatch of the dense contraction. ``use_pallas`` routes a dhconv
    filter that is not separable through the hand-written kernel K1 (the JAX
    package's flag name: there it selects the Pallas kernel), which, like
    the Pallas kernel, computes in float32 whatever the matmul dtype and is
    differentiable; ``image`` is w's K1 weight image, made once by the
    caller, and ``image_t`` gives the backward's
    (``ops/pallas_contractions.py:dhconv``). Every other operator takes its
    plain function, as in the JAX package."""
    if use_pallas and operator_type == "dhconv" and not separable:
        from .pallas_contractions import dhconv

        return emit(dhconv(x, w, image, image_t), out_dtype)
    if operator_type == "dhconv":
        return contract_dhconv(x, w, matmul_dtype, out_dtype, separable)
    if operator_type == "diagonal":
        return emit(contract_diagonal(x, w, matmul_dtype, separable), out_dtype)
    raise ValueError(f"Unsupported operator_type {operator_type!r}")


def _reduced(reduce: Optional[Reduce], re: torch.Tensor, im: torch.Tensor):
    """``(re, im)`` of a rank-space projection, summed by ``reduce`` (over
    ``(2, ...)``, the pair stacked first) where one is given."""
    if reduce is None:
        return re, im
    return reduce(torch.stack([re, im])).unbind(0)


def contract_dhconv_cp(x: torch.Tensor, factors: Mapping[str, torch.Tensor],
                       matmul_dtype: Optional[torch.dtype] = None,
                       reduce: Optional[Reduce] = None) -> torch.Tensor:
    """CP-factorized Driscoll-Healy contraction in spectral space:
    ``weight[ci, co, l] = sum_r A[ci, r] B[co, r] C[l, r]`` (complex), so
    ``y = ((x @ A) * C[l]) @ B^T``. x ``(..., l, m, ci, 2)`` ->
    ``(..., l, m, co, 2)`` float32; ``factors`` holds "A", "B" and "C".
    ``reduce`` sums ``x @ A`` (float32) over the ranks that hold the other
    rows of x's channels and of A, before it is scaled and rounded."""
    A, B, C = factors["A"], factors["B"], factors["C"]

    def mm(a, b, sub="...lmi,ir->...lmr"):
        return einsum(sub, a, b, matmul_dtype)

    xr, xi = x[..., 0], x[..., 1]
    pr = mm(xr, A[..., 0]) - mm(xi, A[..., 1])
    pi = mm(xr, A[..., 1]) + mm(xi, A[..., 0])
    pr, pi = _reduced(reduce, pr, pi)
    sr, si = _cmul(pr, pi, C[..., 0][:, None, :].float(), C[..., 1][:, None, :].float())
    Bt_r, Bt_i = B[..., 0].T, B[..., 1].T
    yr = mm(sr, Bt_r, "...lmr,ro->...lmo") - mm(si, Bt_i, "...lmr,ro->...lmo")
    yi = mm(sr, Bt_i, "...lmr,ro->...lmo") + mm(si, Bt_r, "...lmr,ro->...lmo")
    return torch.stack([yr, yi], dim=-1)


def pair_order(R: int, shards: int) -> torch.Tensor:
    """The order of the 2R rank channels ``[x@Ar | x@Ai]`` that cuts into
    ``shards`` contiguous chunks, chunk k ``[x@Ar_k | x@Ai_k]`` for the k-th
    run of R / shards ranks: each re/im pair on one shard, in the layout of
    a pipeline of R / shards ranks."""
    if R % shards:
        raise ValueError(f"rank {R} does not split over {shards} shards")
    k = R // shards
    return torch.arange(2 * R).view(2, shards, k).transpose(0, 1).reshape(-1)


def cp_spatial_project(x: torch.Tensor, A: torch.Tensor,
                       matmul_dtype: Optional[torch.dtype] = None,
                       out_dtype: Optional[torch.dtype] = None,
                       order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank pipeline stage 1: the CP input projection in grid space,
    ``SHT(x) @ A = SHT(x @ Ar) + i SHT(x @ Ai)``. x ``(..., h, w, ci)``,
    A ``(ci, R, 2)`` -> ``(..., h, w, 2R)`` with channels
    ``[x @ Ar | x @ Ai]``, or those channels in ``order`` (``pair_order``:
    the projection's columns permuted, so each channel is the same sum)."""
    A2 = torch.cat([A[..., 0], A[..., 1]], dim=-1)
    if order is not None:
        A2 = A2[:, order.to(A2.device)]
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
                      out_dtype: Optional[torch.dtype] = None,
                      order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank pipeline stage 3: the output projection in grid space. g
    ``(..., h, w, 2R)``: the inverse SHT of the scaled pair, channels
    ``[G | H]`` (or those channels in ``order``, as ``cp_spatial_project``
    made them: the rows of the projection permuted alike); B ``(co, R, 2)``.
    ``out_o = sum_r Br[o, r] G_r + Bi[o, r] H_r``, one real product ->
    ``(..., h, w, co)``."""
    W2 = torch.cat([B[..., 0], B[..., 1]], dim=-1).T
    if order is not None:
        W2 = W2[order.to(W2.device)]
    return emit(einsum("...hwr,ro->...hwo", g, W2, matmul_dtype), out_dtype)


def tucker_rank_kernel(core: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The Tucker rank pipeline's per-l mixing kernel,
    ``K[l, p, q] = sum_r core[p, q, r] C[l, r]`` (complex): core
    ``(R, R, R, 2)``, C ``(l, R, 2)`` -> ``(l, R, R, 2)`` float32."""
    kr, ki = complex_einsum("pqr,lr->lpq", core[..., 0].float(), core[..., 1].float(),
                            C[..., 0].float(), C[..., 1].float())
    return torch.stack([kr, ki], dim=-1)


def tucker_spectral_mix_stacked(zs: torch.Tensor, K: torch.Tensor,
                                matmul_dtype: Optional[torch.dtype] = None,
                                out_dtype: Optional[torch.dtype] = None,
                                reduce: Optional[Reduce] = None) -> torch.Tensor:
    """The Tucker rank pipeline's stage 2: the per-l complex R -> R mix
    ``q = p @ K[l]`` of the rank spectrum ``p = S_r + i S_i``, returned as
    the stacked pair ``[q | i q]`` ``(..., l, m, 2R, 2)`` (the structure of
    ``cp_spectral_scale_stacked``). zs ``(..., l, m, 2R, 2)`` as the
    transform emitted it: p is formed in zs's dtype, as the JAX package
    forms it, then rounded with K to the matmul dtype for the product.
    On a shard of p (K's rows of those ranks, ``(l, R/n, R, 2)``),
    ``reduce`` sums the float32 partial of q ``(..., l, m, R, 2)`` over the
    shards and keeps this shard's ranks of it, before the emit."""
    R = zs.shape[-2] // 2
    Sr, Si = zs[..., :R, :], zs[..., R:, :]
    p_re = Sr[..., 0] - Si[..., 1]
    p_im = Sr[..., 1] + Si[..., 0]
    q_re, q_im = complex_einsum("...lmp,lpq->...lmq", p_re, p_im, K[..., 0], K[..., 1],
                                matmul_dtype)
    if reduce is not None:
        q_re, q_im = reduce(torch.stack([q_re, q_im], dim=-1)).unbind(-1)
    return emit(torch.cat([torch.stack([q_re, q_im], dim=-1),
                           torch.stack([-q_im, q_re], dim=-1)], dim=-2), out_dtype)


def contract_dhconv_tucker(x: torch.Tensor, factors: Mapping[str, torch.Tensor],
                           reduce: Optional[Reduce] = None) -> torch.Tensor:
    """Tucker-factorized Driscoll-Healy contraction in spectral space,
    ``W[i, o, l] = sum G[p, q, r] A[i, p] B[o, q] C[l, r]`` (complex), as
    project -> per-l core mix -> expand. x ``(..., l, m, ci, 2)`` ->
    ``(..., l, m, co, 2)`` float32; ``factors`` holds "A", "B", "C" and
    "core"; ``reduce`` sums the projection ``x @ A`` over the ranks that
    hold the other rows of x's channels and of A."""
    A, B = factors["A"].float(), factors["B"].float()
    K = tucker_rank_kernel(factors["core"], factors["C"])
    pr, pi = complex_einsum("...lmi,ip->...lmp", x[..., 0].float(), x[..., 1].float(),
                            A[..., 0], A[..., 1])
    pr, pi = _reduced(reduce, pr, pi)
    qr, qi = complex_einsum("...lmp,lpq->...lmq", pr, pi, K[..., 0], K[..., 1])
    yr, yi = complex_einsum("...lmq,oq->...lmo", qr, qi, B[..., 0], B[..., 1])
    return torch.stack([yr, yi], dim=-1)


def contract_dhconv_tt(x: torch.Tensor, factors: Mapping[str, torch.Tensor],
                       reduce: Optional[Reduce] = None) -> torch.Tensor:
    """Tensor-train-factorized Driscoll-Healy contraction,
    ``W[i, o, l] = sum_{a b} G1[i, a] G2[a, o, b] G3[b, l]`` (complex), in
    the JAX package's order: its middle product holds a
    ``(..., l, m, co, R)`` pair. x ``(..., l, m, ci, 2)`` ->
    ``(..., l, m, co, 2)`` float32; ``factors`` holds "G1", "G2" and "G3";
    ``reduce`` sums the projection ``x @ G1`` over the ranks that hold the
    other rows of x's channels and of G1."""
    G1, G2, G3 = (factors[k].float() for k in ("G1", "G2", "G3"))
    pr, pi = complex_einsum("...lmi,ia->...lma", x[..., 0].float(), x[..., 1].float(),
                            G1[..., 0], G1[..., 1])
    pr, pi = _reduced(reduce, pr, pi)
    qr, qi = complex_einsum("...lma,aob->...lmob", pr, pi, G2[..., 0], G2[..., 1])
    del pr, pi
    yr, yi = complex_einsum("...lmob,bl->...lmo", qr, qi, G3[..., 0], G3[..., 1])
    return torch.stack([yr, yi], dim=-1)
