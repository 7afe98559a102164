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

Both kernels are ``csrc/fused_mlp.cu`` (one template; K3 sets its affine
flag); its source note says what bounds them on the H100 and how they are
tiled. ``fused_mlp`` and ``fused_block_tail`` launch them for CUDA tensors
and count the launches in ``fused_mlp.launches`` and
``fused_block_tail.launches``; for CPU tensors they compute the plain
versions, ``fused_mlp_plain`` and ``fused_block_tail_plain``. There is no
fallback: a CUDA tensor that a kernel cannot take raises.

Quantized dropout (``QuantizedDropout`` in the JAX package) keeps an element
iff ``(bits & 255) < t`` with ``t = round((1 - rate) * 256)`` and scales kept
values by ``256 / t``. The bits are the first word of Philox4x32-10, keyed by
a 64-bit seed and counted by (column, row, stream), where K3's row is the
flat row ``b * N + n``: ``philox_bits`` below computes exactly the kernels'
bits, so the plain versions and the kernels drop the same elements, and K3
with ``A = 1, C = 0`` drops what K2 drops. The TPU's hardware PRNG cannot be
reproduced, so the port and the JAX package agree on the distribution of the
mask, not on its bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

__all__ = ["fused_mlp", "fused_mlp_plain", "fused_block_tail", "fused_block_tail_plain",
           "philox4x32", "philox_bits", "quantized_dropout", "keep_threshold"]

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def philox_bits(seed: int, rows: int, cols: int, stream: int,
                device=None) -> torch.Tensor:
    """First output word of Philox4x32-10 for every (row, col) of a
    ``(rows, cols)`` grid, as int64 in [0, 2**32): counter
    ``(col, row, stream, 0)``, key ``(seed & 0xffffffff, seed >> 32)``. The
    CUDA kernel computes the same words (``philox_word0`` in
    ``csrc/fused_mlp.cu``)."""
    col = torch.arange(cols, device=device, dtype=torch.int64).expand(rows, cols)
    row = torch.arange(rows, device=device, dtype=torch.int64)[:, None].expand(rows, cols)
    zero = torch.zeros((rows, cols), device=device, dtype=torch.int64)
    return philox4x32((col, row, zero + stream, zero),
                      (seed & _MASK32, (seed >> 32) & _MASK32))[0]


def keep_threshold(drop_rate: float) -> int:
    """``t`` of quantized dropout; 0 means dropout off. Raises where the
    rate quantizes to keep-nothing, as the JAX package's fused wrappers do
    (its ``QuantizedDropout`` module drops at the exact rate there, as
    ``models/modules.py`` does)."""
    t = int(round((1.0 - drop_rate) * 256)) if drop_rate > 0.0 else 256
    if t <= 0:
        raise ValueError(f"drop_rate {drop_rate} quantizes to keep-nothing")
    return 0 if t >= 256 else t


def quantized_dropout(x: torch.Tensor, t: int, seed: int, stream: int = 0) -> torch.Tensor:
    """Quantized dropout over ``x`` viewed as rows of its last axis, with the
    bits of ``philox_bits``; returns x unchanged for ``t == 0``. These are
    the kernels' bits, for any width, reproduced by their plain versions."""
    if t == 0:
        return x
    cols = x.shape[-1]
    bits = philox_bits(seed, x.numel() // cols, cols, stream, x.device)
    keep = (bits & 255).lt(t).reshape(x.shape)
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
                    exact_gelu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with ``fused_mlp``'s
    signature: float32 accumulation, the hidden tensor rounded to x's dtype,
    the same Philox dropout bits (rows are x's leading axes flattened)."""
    t, seed = _dropout_args("fused_mlp", drop_rate, seed)
    out_dtype = torch.promote_types(x.dtype, residual.dtype) if residual is not None else x.dtype
    h = x.float() @ w1.to(x.dtype).float() + b1.float()
    h = quantized_dropout(_gelu(h, exact_gelu), t, seed, stream=0)
    h = h.to(x.dtype).float()
    y = h @ w2.to(x.dtype).float() + b2.float()
    y = quantized_dropout(y, t, seed, stream=1)
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
                           exact_gelu: bool = False) -> torch.Tensor:
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
                           exact_gelu=exact_gelu)


def _launch(name: str, entry: str, x: torch.Tensor, affine, w1, b1, w2, b2, residual,
            seed, drop_rate: float, exact_gelu: bool) -> torch.Tensor:
    """Checks and launch of K2 (``affine`` None) or K3 (``affine`` the
    float32 (B, C) pair) on CUDA tensors; raises on what the kernels do not
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    t, seed = _dropout_args(name, drop_rate, seed)
    C = x.shape[-1]
    lead = x.shape[:-1]
    C2 = w2.shape[-1]
    out_dtype = torch.promote_types(x.dtype, residual.dtype) if residual is not None else x.dtype
    x2 = x.reshape(-1, C)
    res2 = residual.reshape(-1, C2) if residual is not None else None
    w1 = w1.to(x.dtype)
    w2 = w2.to(x.dtype)
    if x.dtype not in _DTYPE_CODES or (res2 is not None and res2.dtype not in _DTYPE_CODES):
        raise TypeError(f"{name}: float32/bfloat16 only, got {x.dtype}")
    if w1.shape[0] != C or w2.shape[0] != w1.shape[1] or b1.numel() != w1.shape[1] \
            or b2.numel() != C2 or (res2 is not None and res2.shape[0] != x2.shape[0]):
        raise ValueError(f"{name}: operand shapes do not match")
    if C2 > 256:
        raise ValueError(f"{name}: output width {C2} exceeds the kernel's 256")
    tensors = [x2, w1, b1, w2, b2] + ([res2] if res2 is not None else []) + list(affine or ())
    if any(a.device != x.device for a in tensors):
        raise ValueError(f"{name}: all operands must lie on x's device")
    x2, w1, w2 = x2.contiguous(), w1.contiguous(), w2.contiguous()
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    if res2 is not None:
        res2 = res2.contiguous()
    y2 = torch.empty((x2.shape[0], C2), device=x.device, dtype=out_dtype)
    fn = getattr(_cuda.library(), entry)
    args = [x2.data_ptr()]
    if affine is not None:
        affine = [a.contiguous() for a in affine]
        args += [a.data_ptr() for a in affine]
    args += [w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             res2.data_ptr() if res2 is not None else None, y2.data_ptr(), x2.shape[0]]
    if affine is not None:
        args.append(x2.shape[0] // x.shape[0])
    args += [C, w1.shape[1], C2, _DTYPE_CODES[x.dtype],
             _DTYPE_CODES[res2.dtype] if res2 is not None else -1, t, seed, int(exact_gelu),
             _cuda.stream_ptr(x.device)]
    _cuda.check(fn(*args), name)
    return y2.reshape(*lead, C2)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, residual: Optional[torch.Tensor] = None,
              seed: Optional[int] = None, *, drop_rate: float = 0.0,
              exact_gelu: bool = False) -> torch.Tensor:
    """Fused pointwise MLP over the trailing channel axis.

    x ``(..., C)``; w1 ``(C, H)``; w2 ``(H, C2)`` (cast to x's dtype, as in
    the JAX wrapper); b1, b2 float32; residual optional ``(..., C2)`` added
    after the output dropout. ``seed`` (a Python int) is required when
    ``drop_rate > 0``. Returns ``(..., C2)`` in ``promote(x, residual)``."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, residual, seed, drop_rate=drop_rate,
                               exact_gelu=exact_gelu)
    y = _launch("fused_mlp", "sdt_fused_mlp", x, None, w1, b1, w2, b2, residual, seed,
                drop_rate, exact_gelu)
    fused_mlp.launches += 1
    return y


fused_mlp.launches = 0


def fused_block_tail(x: torch.Tensor, affine_a: torch.Tensor, affine_c: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     residual: Optional[torch.Tensor] = None, seed: Optional[int] = None, *,
                     drop_rate: float = 0.0, exact_gelu: bool = False) -> torch.Tensor:
    """Fused norm-apply, time scale-shift, MLP and outer skip.

    x ``(B, ..., C)``: the PRE-norm activations, in the compute dtype;
    ``affine_a``/``affine_c``: float32 per-(sample, channel) fold,
    broadcastable as ``(B, 1, ..., 1, C)``; the rest as ``fused_mlp``.
    Returns ``(B, ..., C2)`` in ``promote(x, residual)``."""
    if x.device.type == "cpu":
        return fused_block_tail_plain(x, affine_a, affine_c, w1, b1, w2, b2, residual, seed,
                                      drop_rate=drop_rate, exact_gelu=exact_gelu)
    affine = (_fold_rows("fused_block_tail", x, affine_a),
              _fold_rows("fused_block_tail", x, affine_c))
    y = _launch("fused_block_tail", "sdt_fused_block_tail", x, affine, w1, b1, w2, b2,
                residual, seed, drop_rate, exact_gelu)
    fused_block_tail.launches += 1
    return y


fused_block_tail.launches = 0
