"""Products with the JAX package's ``matmul_dtype`` rounding, in PyTorch.

The JAX package's transforms and spectral contractions take a matmul dtype
(``SFNOConfig.sht_matmul_dtype``): both operands are rounded to it, and the
product is accumulated and returned in float32
(``preferred_element_type=jnp.float32``). ``einsum`` below is that product
for a two-operand ``torch.einsum`` equation:

- float32: ``torch.einsum`` on float32 operands;
- bf16 or float16 on the CPU: the operands are rounded to that dtype and
  multiplied in float32. A product of two bf16 (8-bit mantissa) or two
  float16 (11-bit) values is exact in float32 (24 bits), so this is a 16-bit
  GEMM with float32 accumulation, up to the order of the sums;
- bf16 or float16 on the card: one 16-bit ``torch.bmm`` with a float32
  result (``out_dtype``), which runs on the tensor cores and returns the
  float32 sums that JAX keeps. That call has no derivative in PyTorch, so it
  runs inside ``Product16``, whose backward is the CPU form's autograd: each
  operand's gradient a float32 product of the float32 cotangent and the
  other (16-bit) operand, rounded to the operand's dtype (the backward of
  the CPU form's ``.float()`` cast).

For the 16-bit dtypes the equation is lowered by hand to that one batched
product (batch axes, then the free axes of each operand, then the
contracted axes), the same lowering on both devices, so the CPU tests run
the card's index arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["einsum", "emit", "as_dtype"]

_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def as_dtype(name) -> Optional[torch.dtype]:
    """A JAX-package dtype name ("float32", "bfloat16", "float16", "" or
    None) as a torch dtype; "" and None give None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    if name == "":
        return None
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def emit(y: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Round a spectral-stage output to the spectral-IO dtype, as the JAX
    package's ``_emit`` does (``ops/sht.py``); None leaves it as it is."""
    return y if out_dtype is None else y.to(out_dtype)


def _expand(sub: str, ndim: int, n_ell: int) -> str:
    if "..." not in sub:
        return sub
    n = ndim - (len(sub) - 3)
    return sub.replace("...", _LETTERS[n_ell - n:n_ell])


def _lowered(eq: str, a: torch.Tensor, b: torch.Tensor, product) -> torch.Tensor:
    lhs, out = eq.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    n_ell = max(a.dim() - (len(sa) - 3) if "..." in sa else 0,
                b.dim() - (len(sb) - 3) if "..." in sb else 0)
    sa, sb, out = _expand(sa, a.dim(), n_ell), _expand(sb, b.dim(), n_ell), \
        out.replace("...", _LETTERS[:n_ell])
    size = dict(zip(sa, a.shape))
    size.update(zip(sb, b.shape))
    batch = [c for c in sa if c in sb and c in out]
    contr = [c for c in sa if c in sb and c not in out]
    a_free = [c for c in sa if c not in sb]
    b_free = [c for c in sb if c not in sa]
    if sorted(batch + a_free + b_free) != sorted(out):
        raise ValueError(f"einsum: equation {eq!r} is not a single batched product")

    def numel(axes):
        return math.prod(size[c] for c in axes)

    a3 = a.permute([sa.index(c) for c in batch + a_free + contr]).reshape(
        numel(batch), numel(a_free), numel(contr))
    b3 = b.permute([sb.index(c) for c in batch + contr + b_free]).reshape(
        numel(batch), numel(contr), numel(b_free))
    y = product(a3, b3).reshape([size[c] for c in batch + a_free + b_free])
    order = batch + a_free + b_free
    return y.permute([order.index(c) for c in out])


class Product16(torch.autograd.Function):
    """``torch.bmm(a3, b3, out_dtype=torch.float32)`` of bf16 or float16
    operands (one dtype), with the backward of ``torch.bmm(a3.float(),
    b3.float())``."""

    @staticmethod
    def forward(ctx, a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a3, b3)
        return torch.bmm(a3, b3, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a3, b3 = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b3.transpose(1, 2).float()).to(a3.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a3.transpose(1, 2).float(), g).to(b3.dtype)
        return ga, gb


def _product16(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    if a3.device.type == "cuda":
        return Product16.apply(a3.contiguous(), b3.contiguous())
    return torch.bmm(a3.float(), b3.float())


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` with both operands rounded to ``dtype``
    (float32 when None) and a float32 result."""
    if dtype is None or dtype == torch.float32:
        return torch.einsum(eq, a.float(), b.float())
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"einsum: matmul dtype {dtype} is not float32, bfloat16 or float16")
    return _lowered(eq, a.to(dtype), b.to(dtype), _product16)
