"""K2 and K3: the block MLP, and the block tail, as hand-written CUDA kernels.

K2 is the counterpart of ``spherical_dyffusion_tpu/ops/fused_mlp.py``
(``fused_mlp`` and its Pallas kernel ``_fused_mlp_2d``/``_kernel``):

    y = qdrop(qdrop(gelu(x @ W1 + b1)) @ W2 + b2) (+ residual)

with float32 accumulation, the hidden tensor rounded once to x's dtype between
the two products, and the output in ``promote(x, residual)``. K3 is the
counterpart of ``fused_block_tail`` in the same file (Pallas kernel
``_fused_tail_3d``/``_tail_kernel``): x is the pre-norm activation of B
samples, and each sample's rows first become ``x * A[b] + C[b]`` in float32,
rounded to x's dtype, before K2's arithmetic. A and C fold the instance
norm and the time scale-shift (``InstanceNorm2d(fold=True)``), so the
normalized tensor never reaches device memory.

Both kernels are ``csrc/fused_mlp.cu``, dispatched on x's type: bf16 or
float16 x goes to the tensor-core kernel's instance for that type
(``wgmma``; its weights arrive as the swizzled image of ``weight_image``, in
x's type), float32 x to the CUDA-core kernel; in each, K3 is K2's code with
the affine on. A 16-bit x takes a residual in float32, in its own type or
none; a float32 x one in float32, bf16 or none. The source note says what
bounds them on the H100 and how they are tiled. ``fused_mlp`` and
``fused_block_tail`` launch them for CUDA tensors and count the launches in
``fused_mlp.launches`` and ``fused_block_tail.launches``; for CPU tensors they
compute the plain versions, ``fused_mlp_plain`` and
``fused_block_tail_plain``. There is no fallback: a CUDA tensor that a kernel
cannot take raises.

Quantized dropout (``QuantizedDropout`` in the JAX package) keeps an element
iff its random byte is below ``t = round((1 - rate) * 256)`` and scales kept
values by ``256 / t``. The bytes come from Philox4x32-10 keyed by a 64-bit
seed, one call for 16 elements (``philox_layout``), where K3's row is the
flat row ``b * N + n``: ``philox_bits`` below computes exactly the kernels'
bytes, so the plain versions and the kernels drop the same elements, and K3
with ``A = 1, C = 0`` drops what K2 drops. The TPU's hardware PRNG cannot be
reproduced, so the port and the JAX package agree on the distribution of the
mask, not on its bits.

On a block of a grid split over a mesh (``block``, ``parallel/mesh.py``:
x is ``(B, Hl, Wl, C)`` at origin ``(h0, w0)`` of an ``(H, W)`` grid) a row
takes the bits of its pixel's row on the whole grid (``global_rows``):
local row ``b*Hl*Wl + i*Wl + j`` draws as row ``b*H*W + (h0+i)*W + (w0+j)``,
so the blocks of a sharded run drop exactly the elements of the one-process
run. On the whole grid that map is the identity, and the bits are the same.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import Block
from . import _cuda

__all__ = ["fused_mlp", "fused_mlp_plain", "fused_block_tail", "fused_block_tail_plain",
           "philox4x32", "philox_layout", "philox_bits", "global_rows", "quantized_dropout",
           "keep_threshold", "weight_image", "weight_image_plain", "refuse_grad"]

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF = (torch.bfloat16, torch.float16)  # the tensor-core kernel's types


def _mulhilo(a: int, b: torch.Tensor):
    """32 x 32 -> 64-bit product of a constant and an int64 tensor holding
    uint32 values, as (lo, hi) words; 16-bit halves keep int64 from
    overflowing."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a1 * b0 + a0 * b1
    low = a0 * b0 + ((mid & 0xFFFF) << 16)
    hi = a1 * b1 + (mid >> 16) + (low >> 32)
    return low & _MASK32, hi & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 values:
    ``counter`` four words, ``key`` two; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        lo0, hi0 = _mulhilo(_PHILOX_M[0], c0)
        lo1, hi1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def global_rows(rows: int, block: Optional[Block] = None, device=None) -> torch.Tensor:
    """The row whose dropout bits each of ``rows`` local rows takes, int64:
    the row itself, or on a ``block`` (rows the flattened ``(B, Hl, Wl)``
    leading axes of x) the row of the same pixel on the whole grid,
    ``b*H*W + (h0+i)*W + (w0+j)``."""
    r = torch.arange(rows, device=device, dtype=torch.int64)
    if block is None or block.whole:
        return r
    (Hl, Wl), (H, W) = block.local, block.shape
    b, rem = r // (Hl * Wl), r % (Hl * Wl)
    return b * (H * W) + (block.h0 + rem // Wl) * W + block.w0 + rem % Wl


def _map_args(block: Optional[Block]) -> list:
    """The kernels' row map (csrc/fused_mlp.cu, ``RowMap``): local rows per
    sample, local and global row width, global rows per sample and the
    origin's offset; all 0 for the identity."""
    if block is None or block.whole:
        return [0, 0, 0, 0, 0]
    (Hl, Wl), (H, W) = block.local, block.shape
    return [Hl * Wl, Wl, W, H * W, block.h0 * W + block.w0]


def _check_block(name: str, x: torch.Tensor, block: Optional[Block]) -> None:
    if block is not None and tuple(x.shape[-3:-1]) != tuple(block.local):
        raise ValueError(f"{name}: x {tuple(x.shape)} is not a (..., {block.local[0]}, "
                         f"{block.local[1]}, C) block")


def philox_layout(rows: int, cols: int, device=None, row_index: Optional[torch.Tensor] = None):
    """Where each element of a ``(rows, cols)`` grid takes its dropout byte:
    int64 tensors ``(c0, c1, byte)`` broadcastable to ``(rows, cols)``.
    Element (r, c) takes byte ``b = 4*((c % 32)//8) + 2*(c % 2) + (r % 16)//8``
    (byte ``b % 4`` from the low end of output word ``b // 4``) of the
    Philox4x32-10 call at counter ``(c0, c1, stream, 0)`` with
    ``c0 = (c // 32)*4 + (c % 8)//2`` and ``c1 = (r // 16)*8 + r % 8``. In each
    16-row by 32-column block the 16 elements of one counter are those that
    one thread holds in its ``wgmma`` accumulator fragment, so one call serves
    16 elements, and no byte serves two. ``row_index`` (int64, ``(rows,)``)
    gives each row the r it draws as (``global_rows``)."""
    row = (row_index if row_index is not None
           else torch.arange(rows, device=device, dtype=torch.int64))[:, None]
    col = torch.arange(cols, device=device, dtype=torch.int64)[None, :]
    c0 = (col // 32) * 4 + (col % 8) // 2
    c1 = (row // 16) * 8 + row % 8
    byte = 4 * ((col % 32) // 8) + 2 * (col % 2) + (row % 16) // 8
    return c0, c1, byte


def philox_bits(seed: int, rows: int, cols: int, stream: int, device=None,
                block: Optional[Block] = None) -> torch.Tensor:
    """The dropout byte of every (row, col) of a ``(rows, cols)`` grid, as
    int64 in [0, 256): the byte that ``philox_layout`` assigns it (at its
    ``global_rows`` row on a ``block``), of Philox4x32-10 keyed by
    ``(seed & 0xffffffff, seed >> 32)`` at counter ``(c0, c1, stream, 0)``.
    The CUDA kernels compute the same bytes (``philox4`` and the epilogues in
    ``csrc/fused_mlp.cu``). Each counter is evaluated once and its four words
    gathered."""
    c0, c1, byte = philox_layout(rows, cols, device, global_rows(rows, block, device))
    c1u, c1i = torch.unique(c1[:, 0], return_inverse=True)
    n0 = -(-cols // 32) * 4
    g0 = torch.arange(n0, device=device, dtype=torch.int64).expand(len(c1u), n0)
    g1 = c1u[:, None].expand(len(c1u), n0)
    zero = torch.zeros_like(g0)
    words = torch.stack(philox4x32((g0, g1, zero + stream, zero),
                                   (seed & _MASK32, (seed >> 32) & _MASK32)))
    return (words[byte // 4, c1i[:, None], c0] >> (8 * (byte % 4))) & 255


def keep_threshold(drop_rate: float) -> int:
    """``t`` of quantized dropout; 0 means dropout off. Raises where the
    rate quantizes to keep-nothing, as the JAX package's fused wrappers do
    (its ``QuantizedDropout`` module drops at the exact rate there, as
    ``models/modules.py`` does)."""
    t = int(round((1.0 - drop_rate) * 256)) if drop_rate > 0.0 else 256
    if t <= 0:
        raise ValueError(f"drop_rate {drop_rate} quantizes to keep-nothing")
    return 0 if t >= 256 else t


def quantized_dropout(x: torch.Tensor, t: int, seed: int, stream: int = 0,
                      block: Optional[Block] = None) -> torch.Tensor:
    """Quantized dropout over ``x`` viewed as rows of its last axis, with the
    bytes of ``philox_bits`` (on a ``block``: x ``(..., Hl, Wl, C)``, each
    row at its pixel's row of the whole grid); returns x unchanged for
    ``t == 0``. These are the kernels' bytes, for any width, reproduced by
    their plain versions."""
    if t == 0:
        return x
    _check_block("quantized_dropout", x, block)
    cols = x.shape[-1]
    bits = philox_bits(seed, x.numel() // cols, cols, stream, x.device, block)
    keep = bits.lt(t).reshape(x.shape)
    return torch.where(keep, x * (256.0 / t), torch.zeros((), dtype=x.dtype, device=x.device))


def _gelu(h: torch.Tensor, exact: bool) -> torch.Tensor:
    return F.gelu(h, approximate="none" if exact else "tanh")


def _dropout_args(name: str, drop_rate: float, seed: Optional[int]):
    t = keep_threshold(drop_rate)
    if t > 0 and seed is None:
        raise ValueError(f"{name}: drop_rate > 0 requires a seed")
    return t, int(seed or 0)


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, residual: Optional[torch.Tensor] = None,
                    seed: Optional[int] = None, *, drop_rate: float = 0.0,
                    exact_gelu: bool = False, block: Optional[Block] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with ``fused_mlp``'s
    signature: float32 accumulation, the hidden tensor rounded to x's dtype,
    the same Philox dropout bits (rows are x's leading axes flattened; on a
    ``block``, their pixels' rows of the whole grid)."""
    t, seed = _dropout_args("fused_mlp", drop_rate, seed)
    _check_block("fused_mlp", x, block)
    out_dtype = torch.promote_types(x.dtype, residual.dtype) if residual is not None else x.dtype
    h = x.float() @ w1.to(x.dtype).float() + b1.float()
    h = quantized_dropout(_gelu(h, exact_gelu), t, seed, stream=0, block=block)
    h = h.to(x.dtype).float()
    y = h @ w2.to(x.dtype).float() + b2.float()
    y = quantized_dropout(y, t, seed, stream=1, block=block)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _fold_rows(name: str, x: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """A or C, broadcastable as (B, 1, ..., 1, C), as float32 (B, C)."""
    B, C = x.shape[0], x.shape[-1]
    if affine.numel() != B * C:
        raise ValueError(f"{name}: affine of shape {tuple(affine.shape)} is not "
                         f"one ({B}, {C}) pair of x's batch and channels")
    return affine.float().reshape(B, C)


def fused_block_tail_plain(x: torch.Tensor, affine_a: torch.Tensor, affine_c: torch.Tensor,
                           w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, residual: Optional[torch.Tensor] = None,
                           seed: Optional[int] = None, *, drop_rate: float = 0.0,
                           exact_gelu: bool = False,
                           block: Optional[Block] = None) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch, with ``fused_block_tail``'s
    signature: ``x * A[b] + C[b]`` in float32 rounded to x's dtype, then
    ``fused_mlp_plain`` over the flattened rows (so the dropout rows are
    ``b * N + n``)."""
    _dropout_args("fused_block_tail", drop_rate, seed)
    B, C = x.shape[0], x.shape[-1]
    a = _fold_rows("fused_block_tail", x, affine_a)[:, None, :]
    c = _fold_rows("fused_block_tail", x, affine_c)[:, None, :]
    xn = (x.reshape(B, -1, C).float() * a + c).to(x.dtype).reshape(x.shape)
    return fused_mlp_plain(xn, w1, b1, w2, b2, residual, seed, drop_rate=drop_rate,
                           exact_gelu=exact_gelu, block=block)


_CHUNK = 64  # hidden units per chunk of the 16-bit kernel
_OUT = 256  # the 16-bit kernel's second product is this wide; C2 is padded to it


def _swizzled(rows: int):
    """(row, column) of each element of a ``rows`` x 64 block stored in
    ``wgmma``'s 128-byte-swizzle layout, in storage order: storage chunk s of
    row n holds the 8 columns of logical chunk ``s ^ (n % 8)``."""
    n = torch.arange(rows)[:, None, None]
    s = torch.arange(8)[None, :, None]
    e = torch.arange(8)[None, None, :]
    return n.expand(rows, 8, 8).reshape(-1), ((s ^ (n % 8)) * 8 + e).reshape(-1)


@functools.lru_cache(maxsize=8)
def _image_index(C: int, Hd: int, C2: int, device: str) -> torch.Tensor:
    """Source index of every element of ``weight_image``'s result in
    ``cat(w1.flatten(), w2.flatten(), [0])``; padding takes the final 0."""
    Cp, nch = -(-C // 64) * 64, -(-Hd // _CHUNK)
    zero = C * Hd + Hd * C2
    j = torch.arange(nch)[:, None, None]
    n, k = _swizzled(_CHUNK)  # W1 part: rows are hidden units, columns inputs
    u = j * _CHUNK + n
    kk = torch.arange(Cp // 64)[None, :, None] * 64 + k
    w1_idx = torch.where((kk < C) & (u < Hd), kk * Hd + u, zero).reshape(nch, -1)
    n2, k2 = _swizzled(_OUT)  # W2 part: rows are outputs, columns hidden units
    u2 = j[:, :, 0] * _CHUNK + k2
    w2_idx = torch.where((u2 < Hd) & (n2 < C2), C * Hd + u2 * C2 + n2, zero)
    return torch.cat((w1_idx, w2_idx), 1).to(device)


def weight_image_plain(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """W1 ``(C, Hd)`` and W2 ``(Hd, C2)`` repacked, zero-padded, in the
    16-bit kernel's shared-memory layout, one row per chunk of 64 hidden units
    j: first ``W1[:, chunk j]`` transposed (64 rows of hidden units by C
    inputs, C padded to a multiple of 64, in blocks of 64 inputs), then
    ``W2[chunk j, :]`` transposed (256 rows of outputs, C2 padded to 256, by
    the 64 hidden units); every 64-wide block of rows stored in the
    128-byte-swizzle layout of ``_swizzled``. A permutation of the weights
    and zeros, in w1's dtype: each chunk's two parts are the two contiguous
    byte ranges that the kernel copies into shared memory with one bulk copy
    each."""
    C, Hd = w1.shape
    idx = _image_index(C, Hd, w2.shape[1], str(w1.device))
    return torch.cat((w1.reshape(-1), w2.reshape(-1).to(w1.dtype), w1.new_zeros(1)))[idx]


def weight_image(w1: torch.Tensor, w2: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``weight_image_plain`` in ``dtype`` (bf16 or float16, the type of the
    x it serves): for CUDA tensors one launch of the repack kernel of
    ``csrc/fused_mlp.cu`` (counted in ``weight_image.launches``), which the
    K2/K3 wrappers make before each 16-bit launch; for CPU tensors the plain
    version."""
    if dtype not in _HALF:
        raise TypeError(f"weight_image: a bfloat16 or float16 image, not {dtype}")
    if w1.device.type == "cpu":
        return weight_image_plain(w1, w2).to(dtype)
    C, Hd = w1.shape
    C2 = w2.shape[1]
    if w1.dtype not in _DTYPE_CODES:
        raise TypeError(f"weight_image: float32, bfloat16 or float16 weights, got {w1.dtype}")
    w1 = w1.contiguous()
    w2 = w2.to(w1.dtype).contiguous()
    img = torch.empty((-(-Hd // _CHUNK), (-(-C // 64) * 64 + _OUT) * _CHUNK),
                      device=w1.device, dtype=dtype)
    _cuda.check(_cuda.library().sdt_weight_image(
        w1.data_ptr(), w2.data_ptr(), img.data_ptr(), C, Hd, C2, _DTYPE_CODES[w1.dtype],
        _DTYPE_CODES[dtype], _cuda.stream_ptr(w1.device)), "weight_image")
    weight_image.launches += 1
    return img


weight_image.launches = 0


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t contiguous at a 16-byte-aligned address (the kernels' vector loads)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, x: torch.Tensor, affine, w1, b1, w2, b2, residual, seed,
            drop_rate: float, exact_gelu: bool, block: Optional[Block]) -> torch.Tensor:
    """Checks and launch of K2 (``affine`` None) or K3 (``affine`` the
    float32 (B, C) pair) on CUDA tensors: the tensor-core kernel's instance
    for bf16 or float16 x, the float32 kernel for float32 x; raises on what
    the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    t, seed = _dropout_args(name, drop_rate, seed)
    _check_block(name, x, block)
    C = x.shape[-1]
    lead = x.shape[:-1]
    Hd, C2 = w1.shape[-1], w2.shape[-1]
    half = x.dtype in _HALF
    res_types = (torch.float32, x.dtype) if half else (torch.float32, torch.bfloat16)
    if x.dtype not in _DTYPE_CODES or (residual is not None and residual.dtype not in res_types):
        raise TypeError(f"{name}: x float32, bfloat16 or float16 with a residual in float32 "
                        f"or x's type (bfloat16 too for float32 x), got x {x.dtype} and "
                        f"residual {None if residual is None else residual.dtype}")
    out_dtype = torch.promote_types(x.dtype, residual.dtype) if residual is not None else x.dtype
    x2 = x.reshape(-1, C)
    res2 = residual.reshape(-1, C2) if residual is not None else None
    if w1.shape[0] != C or w2.shape[0] != Hd or b1.numel() != Hd \
            or b2.numel() != C2 or (res2 is not None and res2.shape[0] != x2.shape[0]):
        raise ValueError(f"{name}: operand shapes do not match")
    if C2 > _OUT:
        raise ValueError(f"{name}: output width {C2} exceeds the kernel's {_OUT}")
    if half and (C % 16 or Hd % 16 or C2 % 16 or C > 256):
        raise ValueError(f"{name}: the 16-bit tensor-core kernel takes C, Hd and C2 multiples "
                         f"of 16 with C and C2 at most 256; got C={C}, Hd={Hd}, C2={C2}")
    tensors = [x2, w1, b1, w2, b2] + ([res2] if res2 is not None else []) + list(affine or ())
    if any(a.device != x.device for a in tensors):
        raise ValueError(f"{name}: all operands must lie on x's device")
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    res_code = _DTYPE_CODES[res2.dtype] if res2 is not None else -1
    y2 = torch.empty((x2.shape[0], C2), device=x.device, dtype=out_dtype)
    lib = _cuda.library()
    N = x2.shape[0]
    nps = N // x.shape[0] if affine is not None else 1
    a, c = (_aligned(v) for v in affine) if affine is not None else (None, None)
    ptr = lambda v: v.data_ptr() if v is not None else None  # noqa: E731
    if half:
        x2, res2 = _aligned(x2), _aligned(res2)
        img = weight_image(w1, w2, x.dtype)
        code = lib.sdt_fused_mlp_tc(
            x2.data_ptr(), ptr(a), ptr(c), nps, img.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            ptr(res2), y2.data_ptr(), N, C, Hd, C2, _DTYPE_CODES[x.dtype], res_code, t, seed,
            int(exact_gelu), *_map_args(block), _cuda.stream_ptr(x.device))
    else:
        x2, w1, w2 = x2.contiguous(), w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
        res2 = res2.contiguous() if res2 is not None else None
        args = [x2.data_ptr()] + ([ptr(a), ptr(c)] if affine is not None else [])
        args += [w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ptr(res2),
                 y2.data_ptr(), N] + ([nps] if affine is not None else [])
        args += [C, Hd, C2, _DTYPE_CODES[x.dtype], res_code, t, seed, int(exact_gelu),
                 *_map_args(block), _cuda.stream_ptr(x.device)]
        entry = lib.sdt_fused_block_tail if affine is not None else lib.sdt_fused_mlp
        code = entry(*args)
    _cuda.check(code, name)
    return y2.reshape(*lead, C2)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would record a call of a kernel that has no
    backward (grad enabled and an operand requiring grad), on every device,
    as the JAX package's K2/K3 fail under differentiation: the output would
    otherwise carry no gradient to the operands, silently."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; run it under torch.no_grad() "
                           f"or inference, and train with the plain path")


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, residual: Optional[torch.Tensor] = None,
              seed: Optional[int] = None, *, drop_rate: float = 0.0,
              exact_gelu: bool = False, block: Optional[Block] = None) -> torch.Tensor:
    """Fused pointwise MLP over the trailing channel axis.

    x ``(..., C)``; w1 ``(C, H)``; w2 ``(H, C2)`` (cast to x's dtype, as in
    the JAX wrapper); b1, b2 float32; residual optional ``(..., C2)`` added
    after the output dropout. ``seed`` (a Python int) is required when
    ``drop_rate > 0``. ``block``: x is ``(B, Hl, Wl, C)``, this rank's block
    of a grid split over a mesh, whose rows draw the dropout bits of their
    pixels' rows on the whole grid. Returns ``(..., C2)`` in
    ``promote(x, residual)``. Forward only: raises under autograd
    (``refuse_grad``)."""
    refuse_grad("fused_mlp", x, w1, b1, w2, b2, residual)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, residual, seed, drop_rate=drop_rate,
                               exact_gelu=exact_gelu, block=block)
    y = _launch("fused_mlp", x, None, w1, b1, w2, b2, residual, seed, drop_rate, exact_gelu,
                block)
    fused_mlp.launches += 1
    return y


fused_mlp.launches = 0


def fused_block_tail(x: torch.Tensor, affine_a: torch.Tensor, affine_c: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     residual: Optional[torch.Tensor] = None, seed: Optional[int] = None, *,
                     drop_rate: float = 0.0, exact_gelu: bool = False,
                     block: Optional[Block] = None) -> torch.Tensor:
    """Fused norm-apply, time scale-shift, MLP and outer skip.

    x ``(B, ..., C)``: the PRE-norm activations, in the compute dtype;
    ``affine_a``/``affine_c``: float32 per-(sample, channel) fold,
    broadcastable as ``(B, 1, ..., 1, C)``; the rest, ``block`` too, as
    ``fused_mlp``. Returns ``(B, ..., C2)`` in ``promote(x, residual)``.
    Forward only: raises under autograd (``refuse_grad``)."""
    refuse_grad("fused_block_tail", x, affine_a, affine_c, w1, b1, w2, b2, residual)
    if x.device.type == "cpu":
        return fused_block_tail_plain(x, affine_a, affine_c, w1, b1, w2, b2, residual, seed,
                                      drop_rate=drop_rate, exact_gelu=exact_gelu, block=block)
    affine = (_fold_rows("fused_block_tail", x, affine_a),
              _fold_rows("fused_block_tail", x, affine_c))
    y = _launch("fused_block_tail", x, affine, w1, b1, w2, b2, residual, seed, drop_rate,
                exact_gelu, block)
    fused_block_tail.launches += 1
    return y


fused_block_tail.launches = 0
