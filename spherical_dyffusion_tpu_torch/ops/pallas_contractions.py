"""K1: the dhconv spectral contraction as a hand-written CUDA kernel.

Counterpart of ``spherical_dyffusion_tpu/ops/pallas_contractions.py``
(``dhconv_pallas``, its Pallas forward ``_pallas_forward`` and its custom VJP
``_dhconv_rr_fwd``/``_dhconv_rr_bwd``). The kernel is ``csrc/dhconv.cu``: the
complex product as one real GEMM over K = 2 CI on the TF32 tensor cores, with
each operand split into two TF32 parts (3xTF32) so that the result keeps
float32 accuracy; its source note says what bounds it on the H100 and how it
is tiled. ``dhconv`` launches it for CUDA tensors and counts the launch in
``dhconv.launches``; for CPU tensors it computes the plain version,
``contract_dhconv`` (the same four real products in ``torch.einsum``). There
is no fallback: a CUDA tensor that the kernel cannot take raises.

Layout: x is the interleaved ``(..., L, M, CI, 2)`` float32 layout of
``ops/sht.py`` (what ``torch.view_as_real`` gives for complex64); the output
is ``(..., L, M, CO, 2)`` float32 in the same layout. The weight keeps the
model's ``(CI, CO, L, 2)`` layout; the kernel reads it as an image made once
per weight version (``dhconv_weight_image``): per l, per tile of 128 co and
chunk of 16 ci, the K-major tile ``(co, (ci, re/im))`` in the 128-byte
swizzle that the tensor cores read, split into its TF32 hi and lo parts
(twice the weight's bytes). ``WeightImageCache`` holds the image beside the
weight and makes it again when the weight changes.

Differentiable, as the JAX function is: under autograd ``dhconv`` runs
``DhconvFunction``, whose backward is JAX's ``_dhconv_rr_bwd``. The input
gradient ``dx = g conj(W)^T`` is the forward's product shape, so on the card
it is K1 itself (counted in ``dhconv.launches``, and apart in
``dhconv.dx_launches``) over the image of the conjugate transpose
(``dhconv_weight_image(w, conj_t=True)``). The weight gradient ``dW =
sum_{b,m} conj(x)^T g`` (JAX's two einsums a part, left to XLA) is a kernel
of its own in the same source, ``dhconv_wgrad_tc_kernel``: the same 3xTF32
products, x and g staged through registers into the K-major tiles, 128 co
a block (64 where CO <= 64), the result written in the weight's layout by
clusters of four l. ``dhconv_weight_grad`` launches it for CUDA tensors and
counts the call in ``dhconv_weight_grad.launches``; for CPU tensors it
computes the plain version, ``dhconv_weight_grad_plain`` (one float32
``torch.bmm`` with TF32 off whatever the process's setting). Its plan,
``wgrad_plan``, takes each l's (b, m) rows as one sequence in chunks of
``WGRAD_K`` and, where the tiles alone leave SMs idle, splits the chunks
over blocks; the splits after the first write float32 partials that a
second kernel adds in split order (no atomics: the same bits on every
call). The tensor cores round each accumulation toward zero, so over a long
sum a block adds its accumulators every ``promote``
chunks into a float32 tile of its workspace (the source's note).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from . import _cuda
from .contractions import contract_dhconv

__all__ = ["dhconv", "dhconv_plain", "DhconvFunction", "dhconv_weight_grad",
           "dhconv_weight_grad_plain", "dhconv_weight_image", "dhconv_weight_image_plain",
           "conj_transpose", "split_tf32", "WeightImageCache", "IMAGE_CO", "IMAGE_CI",
           "WGRAD_K", "WgradPlan", "wgrad_plan"]

dhconv_plain = contract_dhconv

IMAGE_CO = 128  # co per column tile of the image: the kernel's N
IMAGE_CI = 16   # ci per chunk: K = 32 floats, one 128-byte row
WGRAD_K = 16         # (b, m) rows per chunk of dW's kernel: K' = 32 floats
WGRAD_CI = 64        # ci per block: wgmma's M
WGRAD_CLUSTER = 4    # consecutive l per cluster
WGRAD_SMS = 132      # an H100's SMs: a split grid gives each at least one block
WGRAD_TARGET = 198   # blocks a split grid aims at: 3/4 of two blocks on each SM
WGRAD_MIN_SPLIT = 16  # chunks below which a call is not split (its reduction costs more)
WGRAD_MIN_CHUNKS = 2  # chunks a split keeps at least
WGRAD_SUM_BUDGET = 576  # chunks x promote: bounds dW's accumulation error


class WgradPlan(NamedTuple):
    """How ``dhconv_wgrad_tc_kernel`` takes a call: ``chunks`` of
    ``WGRAD_K`` (b, m) rows per l, cut into ``splits`` of ``per_split``
    chunks (the last may have fewer), a block summing at most ``promote``
    chunks in the tensor cores before it promotes (where ``per_split`` is
    larger), ``co_tile`` co a block (128, or 64 where CO <= 64), ``tiles``
    (ci, co) tiles per l, ``blocks`` in the grid and ``workspace`` float32s:
    the split partials, then the promotion tiles."""

    chunks: int
    splits: int
    per_split: int
    promote: int
    co_tile: int
    tiles: int
    blocks: int
    workspace: int


@functools.lru_cache(maxsize=64)
def wgrad_plan(B: int, L: int, M: int, CI: int, CO: int,
               splits: Optional[int] = None) -> WgradPlan:
    """The plan of dW's kernel for x ``(B, L, M, CI)`` and g ``(B, L, M,
    CO)``. Each l's B M rows are one sequence, in ``ceil(B M / WGRAD_K)``
    chunks. Where the tiles of all l are fewer than ``WGRAD_SMS`` blocks
    and there are at least ``WGRAD_MIN_SPLIT`` chunks, the chunks are cut
    into as many splits as keep the grid within ``WGRAD_TARGET`` blocks (at
    least ``WGRAD_SMS``); ``splits`` asks for a number instead (at most
    the chunks). Split 0 writes dW, the others ``(splits - 1)`` partials of
    dW's size. A block sums at most ``promote = WGRAD_SUM_BUDGET //
    chunks`` chunks in the tensor cores; a longer split promotes into its
    tile in the workspace after the partials. On an H100: at the main
    path's B = 1 (12 chunks, 1,440 blocks) one split and no workspace; at
    the skill studies' (16, 64, 65, 64) three splits of 22 chunks on 192
    blocks of 64 x 64, promoting every 8 (faster there than 1 or 9 splits:
    ``chip_smoke.py`` phase 22 (a)); the mini preset's 9 chunks unsplit."""
    if min(B, L, M, CI, CO) <= 0:
        raise ValueError(f"wgrad_plan: sizes must be positive, got B {B}, L {L}, M {M}, "
                         f"CI {CI}, CO {CO}")
    chunks = -(-B * M // WGRAD_K)
    co_tile = 64 if CO <= 64 else 128
    tiles = -(-CI // WGRAD_CI) * -(-CO // co_tile)
    promote = max(1, WGRAD_SUM_BUDGET // chunks)
    if splits is not None:
        if not 1 <= splits <= chunks:
            raise ValueError(f"wgrad_plan: {splits} splits of {chunks} chunks")
    elif tiles * L < WGRAD_SMS and chunks >= WGRAD_MIN_SPLIT:
        splits = max(WGRAD_TARGET // (tiles * L), -(-WGRAD_SMS // (tiles * L)))
        splits = min(splits, chunks // WGRAD_MIN_CHUNKS)
    else:
        splits = 1
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)  # no split left empty
    lc = -(-L // WGRAD_CLUSTER) * WGRAD_CLUSTER
    if lc > 65535 or splits > 65535 or B * M + WGRAD_K > 2 ** 31 - 1:
        raise ValueError(f"wgrad_plan: ({B}, {L}, {M}) exceeds the kernel's grid "
                         f"(L rounded to {lc}, {splits} splits, {B * M} rows)")
    blocks = tiles * lc * splits
    partials = (splits - 1) * CI * CO * L  # complex values
    workspace = 2 * partials
    if per_split > promote:  # one 64 x co_tile tile a block, 16-byte aligned
        workspace = 2 * (partials + (partials & 1)) + blocks * WGRAD_CI * co_tile * 2
    return WgradPlan(chunks=chunks, splits=splits, per_split=per_split, promote=promote,
                     co_tile=co_tile, tiles=tiles, blocks=blocks, workspace=workspace)


def split_tf32(a: torch.Tensor):
    """``(hi, lo)`` float32 with ``hi`` = a rounded to TF32 (to nearest, ties
    away from zero: half a TF32 ulp added to the bits, the 13 low bits
    cleared) and ``lo`` = ``a - hi`` (exact) rounded the same way: the split
    of K1's 3xTF32 products, bit for bit what the kernel computes."""

    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a.float())
    return hi, rna(a.float() - hi)


def conj_transpose(w: torch.Tensor) -> torch.Tensor:
    """``(CI, CO, L, 2)`` -> ``(CO, CI, L, 2)``: the weight of the backward
    product ``dx = g conj(W)^T``, the imaginary part negated."""
    return torch.stack([w[..., 0], -w[..., 1]], dim=-1).transpose(0, 1)


def _image_shape(CI: int, CO: int, L: int):
    return (L, -(-CO // IMAGE_CO), -(-CI // IMAGE_CI), 2, IMAGE_CO, 2 * IMAGE_CI)


def dhconv_weight_image_plain(w: torch.Tensor, conj_t: bool = False) -> torch.Tensor:
    """The K1 weight image of w ``(CI, CO, L, 2)``: a zero-padded permutation
    to ``(L, CO/128, CI/16, 128, 32)`` (co rows, (ci, re/im) pairs along K),
    each row's eight 16-byte chunks swizzled (storage chunk s holds logical
    chunk s ^ (row % 8)), then split by ``split_tf32``; returns
    ``(L, CO/128, CI/16, 2, 128, 32)`` float32, hi before lo. ``conj_t``:
    the image of ``conj_transpose(w)``, the backward's weight."""
    if conj_t:
        w = conj_transpose(w)
    CI, CO, L, _ = w.shape
    shape = _image_shape(CI, CO, L)
    nct, nch = shape[1], shape[2]
    wk = w.new_zeros((L, nct * IMAGE_CO, nch * IMAGE_CI, 2), dtype=torch.float32)
    wk[:, :CO, :CI] = w.float().permute(2, 1, 0, 3)
    t = wk.reshape(L, nct, IMAGE_CO, nch, 2 * IMAGE_CI).permute(0, 1, 3, 2, 4)
    n = torch.arange(IMAGE_CO, device=w.device)[:, None]
    chunk = torch.arange(8, device=w.device)[None, :] ^ (n % 8)
    idx = (chunk[:, :, None] * 4 + torch.arange(4, device=w.device)).reshape(IMAGE_CO, -1)
    t = torch.gather(t, -1, idx.expand(t.shape))
    hi, lo = split_tf32(t)
    return torch.stack([hi, lo], dim=3).contiguous()


def dhconv_weight_image(w: torch.Tensor, conj_t: bool = False) -> torch.Tensor:
    """The K1 weight image of w ``(CI, CO, L, 2)`` float32 (with ``conj_t``,
    of its conjugate transpose): built by one small kernel on the card
    (counted in ``dhconv_weight_image.launches``), by
    ``dhconv_weight_image_plain`` on the CPU."""
    if w.device.type == "cpu":
        return dhconv_weight_image_plain(w, conj_t)
    if w.device.type != "cuda":
        raise ValueError(f"dhconv_weight_image: unsupported device {w.device}")
    if w.dtype != torch.float32 or w.dim() != 4 or w.shape[-1] != 2 or not w.is_contiguous():
        raise ValueError(f"dhconv_weight_image: a contiguous float32 (CI, CO, L, 2) weight "
                         f"required, got {w.dtype} {tuple(w.shape)}")
    CI, CO, L, _ = w.shape
    if conj_t:  # the image of the (CO, CI) product, read from w as it lies
        CI, CO = CO, CI
    img = torch.empty(_image_shape(CI, CO, L), device=w.device, dtype=torch.float32)
    lib = _cuda.library()
    _cuda.check(lib.sdt_dhconv_weight_image(w.data_ptr(), img.data_ptr(), L, CI, CO,
                                            int(conj_t), _cuda.stream_ptr(w.device)),
                "dhconv_weight_image")
    dhconv_weight_image.launches += 1
    return img


dhconv_weight_image.launches = 0


class WeightImageCache:
    """The K1 weight image of one weight tensor (with ``conj_t``, the
    backward's image of its conjugate transpose), made on first use and made
    again whenever the weight changes: the key is the weight's device, data
    pointer, version counter and shape, so an in-place update
    (``load_state_dict``, an optimizer step) or a move to another device
    rebuilds it. Held, not registered, by the module that owns the weight:
    it is derived and never saved."""

    def __init__(self, conj_t: bool = False):
        self.conj_t = conj_t
        self.key = None
        self.image: Optional[torch.Tensor] = None

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        key = (w.device, w.data_ptr(), w._version, tuple(w.shape))
        if key != self.key:
            self.image = None  # free the old image before the new one is made
            self.image = dhconv_weight_image(w.detach(), self.conj_t)
            self.key = key
        return self.image


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"dhconv: unsupported device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"dhconv: float32 inputs required, got {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError("dhconv: x and w must lie on the same device")
    if x.dim() < 4 or x.shape[-1] != 2 or w.dim() != 4 or w.shape[-1] != 2:
        raise ValueError(f"dhconv: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    if w.shape[0] != x.shape[-2] or w.shape[2] != x.shape[-4]:
        raise ValueError(f"dhconv: w {tuple(w.shape)} does not match x {tuple(x.shape)}")


def _launch(x: torch.Tensor, image: torch.Tensor, CO: int) -> torch.Tensor:
    """K1 on x ``(..., L, M, CI, 2)`` through ``image``, the image of a
    ``(CI, CO, L, 2)`` weight: ``(..., L, M, CO, 2)``."""
    L, M, CI = x.shape[-4:-1]
    if not x.is_contiguous():
        raise ValueError("dhconv: x must be contiguous")
    lead = x.shape[:-4]
    B = x.numel() // (L * M * CI * 2)
    if B * L > 65535:
        raise ValueError(f"dhconv: batch x L = {B * L} exceeds the kernel grid (65535)")
    if image.shape != _image_shape(CI, CO, L) or image.dtype != torch.float32 \
            or image.device != x.device or not image.is_contiguous():
        raise ValueError(f"dhconv: image {image.dtype} {tuple(image.shape)} is not the "
                         f"weight image of a ({CI}, {CO}, {L}, 2) weight")
    y = torch.empty(lead + (L, M, CO, 2), device=x.device, dtype=torch.float32)
    if B == 0:
        return y
    lib = _cuda.library()
    _cuda.check(lib.sdt_dhconv_fwd(x.data_ptr(), image.data_ptr(), y.data_ptr(), B, L, M, CI,
                                   CO, _cuda.stream_ptr(x.device)), "dhconv")
    dhconv.launches += 1
    return y


def _forward(x: torch.Tensor, w: torch.Tensor, image: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return dhconv_plain(x, w)
    _check_operands(x, w)
    return _launch(x, dhconv_weight_image(w) if image is None else image, w.shape[1])


def dhconv_weight_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW = sum_{b,m} conj(x)^T g`` per l: x ``(..., L, M, CI, 2)``, g
    ``(..., L, M, CO, 2)`` -> ``(CI, CO, L, 2)`` in x's dtype. One real
    product per l, ``[xr xi]^T [gr gi]`` over K = B M, holds JAX's four
    (``dwr = xr^T gr + xi^T gi``, ``dwi = xr^T gi - xi^T gr``). A
    ``torch.bmm`` in full float32 whatever the process's matmul precision:
    TF32 is switched off for the product and the caller's setting put back
    after it."""
    L, M, CI = x.shape[-4:-1]
    CO = g.shape[-2]
    xk = x.reshape(-1, L, M * 2 * CI).transpose(0, 1).reshape(L, -1, 2 * CI)
    gk = g.reshape(-1, L, M * 2 * CO).transpose(0, 1).reshape(L, -1, 2 * CO)
    flags = torch.backends.cuda.matmul
    tf32 = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        p = torch.bmm(xk.transpose(1, 2), gk).view(L, CI, 2, CO, 2)
    finally:
        flags.allow_tf32 = tf32
    dwr = p[:, :, 0, :, 0] + p[:, :, 1, :, 1]
    dwi = p[:, :, 0, :, 1] - p[:, :, 1, :, 0]
    return torch.stack([dwr, dwi], dim=-1).permute(1, 2, 0, 3).contiguous()


def dhconv_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW = sum_{b,m} conj(x)^T g`` per l: x ``(..., L, M, CI, 2)``, g
    ``(..., L, M, CO, 2)`` float32 -> ``(CI, CO, L, 2)`` float32. On the
    card ``dhconv_wgrad_tc_kernel`` (3xTF32) over contiguous copies of x and
    g as ``wgrad_plan`` splits them, with the reduction kernel after it where
    there are several splits: one call, counted once in
    ``dhconv_weight_grad.launches``; on the CPU ``dhconv_weight_grad_plain``.
    A CUDA input the kernels do not take raises."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dhconv_weight_grad_plain(x, g)
        raise ValueError(f"dhconv_weight_grad: unsupported device {x.device}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"dhconv_weight_grad: float32 inputs required, got {x.dtype}, "
                        f"{g.dtype}")
    if g.get_device() != x.get_device():
        raise ValueError("dhconv_weight_grad: x and g must lie on the same device")
    if x.dim() < 4 or x.shape[-1] != 2 or g.dim() != x.dim() or g.shape[-1] != 2 \
            or g.shape[:-2] != x.shape[:-2]:
        raise ValueError(f"dhconv_weight_grad: bad shapes x {tuple(x.shape)}, "
                         f"g {tuple(g.shape)}")
    L, M, CI = x.shape[-4:-1]
    CO = g.shape[-2]
    B = x.numel() // (L * M * CI * 2)
    plan = wgrad_plan(B, L, M, CI, CO)
    # new_empty: float32 on x's device, at less host time than torch.empty
    dw = x.new_empty((CI, CO, L, 2))
    x, g = x.contiguous(), g.contiguous()
    ws = x.new_empty(plan.workspace) if plan.workspace else None
    lib = _cuda.library()
    _cuda.check(lib.sdt_dhconv_wgrad(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                     ws.data_ptr() if ws is not None else None, B, L, M, CI,
                                     CO, plan.per_split, plan.promote,
                                     _cuda.stream_ptr(x.device)),
                "dhconv_weight_grad")
    dhconv_weight_grad.launches += 1
    return dw


dhconv_weight_grad.launches = 0


class DhconvFunction(torch.autograd.Function):
    """K1 with the backward of JAX's custom VJP (``_dhconv_rr_bwd``):
    ``dx = g conj(W)^T`` (K1 over the conjugate-transposed image on the card,
    ``dhconv_plain`` on the CPU) and ``dW = dhconv_weight_grad(x, g)`` (its
    kernel on the card, the plain product on the CPU). It
    saves x and w, never an image, so torch's version check catches an
    in-place update of either between forward and backward. ``image``: w's
    forward image (made here if None); ``image_t``: a callable giving w's
    conjugate-transposed image (a ``WeightImageCache(conj_t=True)``, so that
    it is made once per weight version; made here if None)."""

    @staticmethod
    def forward(ctx, x, w, image, image_t):
        ctx.image_t = image_t
        ctx.save_for_backward(x, w)
        return _forward(x, w, image)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if g.device.type == "cpu":
                dx = dhconv_plain(g, conj_transpose(w))
            else:
                g = g.contiguous()
                img_t = (ctx.image_t(w) if ctx.image_t is not None
                         else dhconv_weight_image(w, conj_t=True))
                dx = _launch(g, img_t, w.shape[0])
                dhconv.dx_launches += 1
        if ctx.needs_input_grad[1]:
            dw = dhconv_weight_grad(x, g)
        return dx, dw, None, None


def dhconv(x: torch.Tensor, w: torch.Tensor, image: Optional[torch.Tensor] = None,
           image_t: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """x ``(..., L, M, CI, 2)``, w ``(CI, CO, L, 2)`` -> ``(..., L, M, CO, 2)``.

    ``image``: w's ``dhconv_weight_image``, made once by the caller (see
    ``WeightImageCache``); without it a CUDA call makes one for itself.
    Where autograd records (grad enabled and x or w requiring grad) the call
    goes through ``DhconvFunction`` with ``image_t`` for its backward;
    elsewhere (inference, a frozen network under ``torch.no_grad``) it
    records and saves nothing."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DhconvFunction.apply(x, w, image, image_t)
    return _forward(x, w, image)


dhconv.launches = 0
dhconv.dx_launches = 0  # of dhconv.launches, those that computed a backward's dx
