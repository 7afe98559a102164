"""Shared building blocks, channels-last, in PyTorch.

Counterparts of ``spherical_dyffusion_tpu/models/modules.py``. Parameter
names and layouts follow the flax modules (``Dense.kernel`` is ``(in, out)``,
``InstanceNorm2d.scale``/``bias``), so a flax parameter tree maps onto a
``state_dict`` by renaming alone (``utils/convert.py``). Dtypes follow flax:
``Dense(dtype=...)`` computes and returns in that dtype, with float32
parameters cast at use; with ``dtype=None`` it promotes its inputs.

Randomness comes from an explicit host-side ``torch.Generator``. The fused
MLP (K2, K3) draws a 64-bit seed from it for its in-kernel Philox bits;
``QuantizedDropout`` draws a seed for a generator on x's device, which then
draws the 8 random bits of each element in one call, as the JAX package's
module draws ``jax.random.bits(..., uint8)``. Both keep an element iff its
8 bits are below ``t``, so the unfused and the fused MLP drop by the same
rule, from different bits. Exact-rate dropout (``exact_dropout``: the
config's ``exact_dropout``, and where the JAX package's ``QuantizedDropout``
leaves quantized dropout for it) draws a uniform on x's device, from a
generator there seeded from the caller's. The per-sample draws for the card
(DropPath's keep mask here, the timesteps of the training losses) are made
there too, from ``device_generator``: a training step copies nothing from
the host.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_mlp import fused_block_tail, fused_mlp

__all__ = ["Dense", "InstanceNorm2d", "SpatialLayerNorm", "QuantizedDropout", "MLP2d",
           "SinusoidalTimeEmbedding", "TimeEmbedMLP", "DropPath",
           "get_activation", "draw_seed", "device_generator", "exact_dropout"]


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit dropout seed from a host-side generator (no device sync)."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator).item())


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded by a draw from ``generator`` (a host
    generator), so that a draw for the card is made on the card and nothing
    of it crosses from the host."""
    return torch.Generator(device=device).manual_seed(draw_seed(generator))


def exact_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout at the exact rate (``flax.linen.Dropout``): keep
    each element with probability ``1 - rate`` and scale kept ones by
    ``1 / (1 - rate)`` in x's dtype; rate 1 drops everything. The uniform
    draw is made on x's device, from a generator there seeded from
    ``generator`` (a host generator): nothing of x's size crosses from the
    host."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    device_gen = device_generator(generator, x.device)
    u = torch.rand(x.shape, generator=device_gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    acts = {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "relu": F.relu,
        "silu": F.silu,
        "tanh": torch.tanh,
    }
    if name not in acts:
        raise ValueError(f"Unknown activation {name!r}")
    return acts[name]


class Dense(nn.Module):
    """``flax.linen.Dense`` over the trailing axis: ``x @ kernel + bias``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalization over (H, W) of (B, H, W, C),
    float32 statistics, affine, eps 1e-6. ``exact=False`` is the one-pass
    form ``var = max(E[x^2] - E[x]^2, 0)`` of the JAX package's default.

    ``fold=True`` returns the per-(sample, channel) pair ``(A, B)`` with
    ``norm(x) == x * A + B`` (float32, shape (B, 1, 1, C)) instead of the
    normalized tensor, for the fused block tail (K3)."""

    def __init__(self, features: int, eps: float = 1e-6, exact: bool = False):
        super().__init__()
        self.eps = eps
        self.exact = exact
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, fold: bool = False):
        xf = x.float()
        mean = xf.mean(dim=(-3, -2), keepdim=True)
        if self.exact:
            var = (xf - mean).square().mean(dim=(-3, -2), keepdim=True)
        else:
            var = (xf.square().mean(dim=(-3, -2), keepdim=True) - mean.square()).clamp_min(0.0)
        rstd = torch.rsqrt(var + self.eps)
        if fold:
            return rstd * self.scale, self.bias - mean * rstd * self.scale
        y = (xf - mean) * rstd
        return (y * self.scale + self.bias).to(x.dtype)


class SpatialLayerNorm(nn.Module):
    """Layer norm over the spatial dims of (B, H, W, C): each channel's
    (H, W) slice normalized jointly (float32 statistics, eps 1e-6, one-pass
    ``max(E[x^2] - E[x]^2, 0)`` unless ``exact``), then the per-pixel
    ``scale`` and ``bias`` of shape ``(h, w, 1)``, shared by the channels
    (the JAX package's module and parameter layout)."""

    def __init__(self, spatial_shape: Tuple[int, int], eps: float = 1e-6,
                 exact: bool = False):
        super().__init__()
        h, w = spatial_shape
        self.eps = eps
        self.exact = exact
        self.scale = nn.Parameter(torch.ones(h, w, 1))
        self.bias = nn.Parameter(torch.zeros(h, w, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(-3, -2), keepdim=True)
        if self.exact:
            var = (xf - mean).square().mean(dim=(-3, -2), keepdim=True)
        else:
            var = (xf.square().mean(dim=(-3, -2), keepdim=True) - mean.square()).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class QuantizedDropout(nn.Module):
    """Inverted dropout with the keep probability quantized to 1/256: keep
    iff ``bits < t`` for 8 random bits drawn on x's device,
    ``t = round((1 - rate) * 256)``, scale ``256/t``. As the JAX package's
    module: a rate that rounds to
    keep-everything (below 1/512) is no dropout, and where the last axis is
    not a multiple of 4 or the rate rounds to keep-nothing (``rate >= 1 -
    1/512``) the module drops at the exact rate (``exact_dropout``).
    ``exact=True`` always drops at the exact rate (the config's
    ``exact_dropout``, which the loader of reference checkpoints turns on)."""

    def __init__(self, rate: float, exact: bool = False):
        super().__init__()
        self.rate = rate
        self.exact = exact
        self.t = int(round((1.0 - rate) * 256)) if rate > 0.0 else 256

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate <= 0.0:
            return x
        if self.exact:
            return exact_dropout(x, self.rate, generator)
        if self.t >= 256:
            return x
        if self.t <= 0 or x.shape[-1] % 4:
            return exact_dropout(x, self.rate, generator)
        device_gen = device_generator(generator, x.device)
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                             generator=device_gen)
        return torch.where(bits < self.t, x * (256.0 / self.t),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class MLP2d(nn.Module):
    """Pointwise two-layer MLP with dropout after each layer.

    ``fused=True`` runs the whole MLP through the K2 kernel (``fused_mlp``):
    one pass, the hidden tensor never in device memory, the optional residual
    added inside, output ``promote(x, residual)``. With ``affine=(A, B)``, x
    is the pre-norm tensor: the fused form runs the K3 kernel
    (``fused_block_tail``), which applies ``x * A + B`` before the first
    product, and the unfused form applies it in float32 first. Both forms
    share the parameter tree ``Dense_0``/``Dense_1``. A live dropout rate
    that rounds to keep-nothing leaves the fused form for the unfused one, as
    in the JAX package (the kernels quantize the rate), and ``exact_dropout``
    never takes it: K2 and K3 draw quantized masks only."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 activation: str = "gelu", drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, fused: bool = False,
                 exact_dropout: bool = False):
        super().__init__()
        if fused and activation not in ("gelu", "gelu_exact"):
            raise ValueError(f"fused MLP supports gelu/gelu_exact, not {activation!r}")
        self.activation = activation
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.fused = fused and not exact_dropout
        self.Dense_0 = Dense(in_features, hidden_features, dtype=dtype)
        self.Dense_1 = Dense(hidden_features, out_features, dtype=dtype)
        self.drop = QuantizedDropout(drop_rate, exact=exact_dropout)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                residual: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        drop_active = self.drop_rate > 0.0 and not deterministic
        if self.fused and not (drop_active and self.drop.t <= 0):
            kw = dict(residual=residual, seed=draw_seed(generator) if drop_active else None,
                      drop_rate=self.drop_rate if drop_active else 0.0,
                      exact_gelu=self.activation == "gelu_exact")
            params = (self.Dense_0.kernel, self.Dense_0.bias, self.Dense_1.kernel,
                      self.Dense_1.bias)
            x = x.to(self.dtype or x.dtype)
            if affine is not None:
                return fused_block_tail(x, affine[0], affine[1], *params, **kw)
            return fused_mlp(x, *params, **kw)
        if affine is not None:
            x = (x.float() * affine[0] + affine[1]).to(self.dtype or x.dtype)
        y = get_activation(self.activation)(self.Dense_0(x))
        y = self.drop(y, deterministic, generator)
        y = self.drop(self.Dense_1(y), deterministic, generator)
        return y + residual if residual is not None else y


class SinusoidalTimeEmbedding(nn.Module):
    """Sinusoidal embedding of a scalar time per sample: frequencies
    ``exp(-log(10000) * i / (half - 1))``, then ``[sin, cos]``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        i = torch.arange(half, dtype=torch.float32, device=t.device)
        freqs = torch.exp(-math.log(10000.0) * i / (half - 1))
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeEmbedMLP(nn.Module):
    """Sinusoidal embedding -> Dense -> erf gelu -> Dense."""

    def __init__(self, time_dim: int, pos_emb_dim: int):
        super().__init__()
        self.embed = SinusoidalTimeEmbedding(pos_emb_dim)
        self.Dense_0 = Dense(pos_emb_dim, time_dim)
        self.Dense_1 = Dense(time_dim, time_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(self.embed(t))))


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch of a sample with
    probability ``rate`` and rescales kept samples by ``1 / keep`` in x's
    dtype."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape[0], generator=device_generator(generator, x.device),
                          device=x.device) < keep
        mask = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        scale = torch.full((), 1.0 / keep, dtype=x.dtype, device=x.device)
        return torch.where(mask, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))
