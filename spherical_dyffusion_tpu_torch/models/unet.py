"""The UNet backbone, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/models/unet.py``: weight-standardized
conv ResNet blocks with GroupNorm and a time scale-shift, linear attention
along the down and up paths, full attention at the bottleneck, an optional
outer resampler for grids that do not halve evenly, and the input residual
into the final block. The JAX package computes all of it with
``lax.conv_general_dilated``, ``jnp.einsum`` and ``softmax``, outside any
Pallas kernel, so here it is ``F.conv2d``, ``torch.einsum`` and ``softmax``.

Inputs and outputs are channels-last ``(B, H, W, C)``, as for the SFNO.
Inside, activations are NCHW tensors in ``torch.channels_last`` memory, so
the permutes at the boundary are views. Parameters keep the flax names and
layouts (``Conv.kernel`` is HWIO, ``Dense.kernel`` is ``(in, out)``,
``GroupNorm_0.scale``/``bias``, ``ChanLayerNorm_0.g``; submodules are named as
flax names them, ``ConvBlock_0``, ``WSConv_0``, and the attentions in the
UNet's own scope, ``LinearAttention_0``, ..., ``FullAttention_0``), so
``utils/convert.py`` carries a flax tree across by renaming; a conv's OIHW
view of its kernel is made at call time.

Where the two packages can part:

* resizing: ``jax.image.resize`` "bilinear" antialiases, as
  ``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``
  does; its "nearest" is ``mode="nearest-exact"``;
* GroupNorm: flax's ``GroupNorm`` takes eps 1e-6 and the one-pass variance
  ``max(E[x^2] - E[x]^2, 0)``; ``F.group_norm`` takes eps 1e-6 here and the
  two-pass variance, which leaves rounding differences (float32, a few
  1e-7 of a unit-scale activation);
* dropout: ``QuantizedDropout`` chooses between its quantized and exact
  forms by the last axis of JAX's channels-last tensor, so a block's
  dropout runs on the channels-last view of the activation (channels last)
  and the bottleneck attention's on the ``(B, h, i, j)`` matrix (pixels
  last: 1058 at the published width, not a multiple of 4, so the exact
  rate). Masks come from the port's generators, so only the rate and the
  scale can match JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .modules import Dense, QuantizedDropout, TimeEmbedMLP

__all__ = ["UNetConfig", "UNet", "Conv", "WSConv", "ChanLayerNorm", "GroupNorm", "ConvBlock",
           "ResnetBlock", "LinearAttention", "FullAttention", "PreNormResidual"]


def _channels_last_dropout(drop: QuantizedDropout, x: torch.Tensor, deterministic: bool,
                           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``drop`` on the (B, H, W, C) view of NCHW ``x``, so that it decides
    by the channel count, as the JAX module does on its layout."""
    if deterministic or drop.rate <= 0.0:
        return x
    return drop(x.permute(0, 2, 3, 1), deterministic, generator).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW tensors: an HWIO ``kernel`` and a
    ``bias``; ``padding`` "SAME" (odd kernels: symmetric) or explicit
    ``(pad_h, pad_w)``."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding="SAME", use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        if padding == "SAME":
            if kh % 2 == 0 or kw % 2 == 0:
                raise ValueError(f"'SAME' padding of an even kernel {kernel_size} is asymmetric")
            padding = (kh // 2, kw // 2)
        self.strides = tuple(strides)
        self.padding = tuple(padding)
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def weight(self) -> torch.Tensor:
        return self.kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight().permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(x, w, self.bias, self.strides, self.padding)


class WSConv(Conv):
    """Weight-standardized conv: the kernel z-scored per output channel over
    (kh, kw, cin), population variance, eps 1e-5 (float32)."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int] = (3, 3)):
        super().__init__(in_features, features, kernel_size)

    def weight(self) -> torch.Tensor:
        k = self.kernel
        eps = 1e-5 if k.dtype == torch.float32 else 1e-3
        var, mean = torch.var_mean(k, dim=(0, 1, 2), keepdim=True, correction=0)
        return (k - mean) * torch.rsqrt(var + eps)


class ChanLayerNorm(nn.Module):
    """Layer norm over the channels with a scale ``g`` only, two-pass
    variance, eps 1e-5 (float32)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        var, mean = torch.var_mean(x, dim=1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + eps) * self.g[:, None, None]


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` (``scale``, ``bias``, eps 1e-6) through
    ``F.group_norm``."""

    def __init__(self, features: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.scale, self.bias, eps=1e-6)


class ConvBlock(nn.Module):
    """WSConv -> GroupNorm -> (time scale-shift) -> SiLU -> dropout."""

    def __init__(self, in_features: int, features: int, groups: int = 8, dropout: float = 0.0):
        super().__init__()
        self.WSConv_0 = WSConv(in_features, features)
        self.GroupNorm_0 = GroupNorm(features, groups)
        self.drop = QuantizedDropout(dropout)

    def forward(self, x, scale_shift=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = self.GroupNorm_0(self.WSConv_0(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return _channels_last_dropout(self.drop, F.silu(x), deterministic, generator)


class ResnetBlock(nn.Module):
    """Two ConvBlocks (the first with the time scale-shift) and the skip,
    through a 1x1 ``Conv_0`` where the widths differ."""

    def __init__(self, in_features: int, features: int, groups: int = 8, dropout1: float = 0.0,
                 dropout2: float = 0.0, double_conv_layer: bool = True,
                 time_emb_dim: Optional[int] = None):
        super().__init__()
        if time_emb_dim is not None:
            self.Dense_0 = Dense(time_emb_dim, features * 2)
        self.ConvBlock_0 = ConvBlock(in_features, features, groups, dropout1)
        self.double_conv_layer = double_conv_layer
        if double_conv_layer:
            self.ConvBlock_1 = ConvBlock(features, features, groups, dropout2)
        if in_features != features:
            self.Conv_0 = Conv(in_features, features, (1, 1))

    def forward(self, x, time_emb=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        scale_shift = None
        if hasattr(self, "Dense_0") and time_emb is not None:
            emb = self.Dense_0(F.silu(time_emb))[:, :, None, None]
            scale_shift = emb.chunk(2, dim=1)
        h = self.ConvBlock_0(x, scale_shift, deterministic, generator)
        if self.double_conv_layer:
            h = self.ConvBlock_1(h, None, deterministic, generator)
        if hasattr(self, "Conv_0"):
            x = self.Conv_0(x)
        return h + x


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, heads * d, H, W) -> (B, heads, d, H * W); channel ``h * d + e``
    is head h's e-th, as JAX splits its channels-last tensor."""
    B, C, H, W = t.shape
    return t.reshape(B, heads, C // heads, H * W)


class LinearAttention(nn.Module):
    """Linear attention: q softmaxed over its head dim and scaled, k over
    the pixels, v over the pixel count; ``context = k v^T`` per head."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.drop = QuantizedDropout(dropout)
        self.Conv_0 = Conv(dim, hidden * 3, (1, 1), use_bias=False)
        self.Conv_1 = Conv(hidden, dim, (1, 1))

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        B, _, H, W = x.shape
        x = _channels_last_dropout(self.drop, x, deterministic, generator)
        q, k, v = (_heads(t, self.heads) for t in self.Conv_0(x).chunk(3, dim=1))
        q = torch.softmax(q, dim=2) * self.dim_head ** -0.5
        k = torch.softmax(k, dim=3)
        v = v / (H * W)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        out = out.reshape(B, -1, H, W).contiguous(memory_format=torch.channels_last)
        return self.Conv_1(out)


class FullAttention(nn.Module):
    """Softmax attention over all pixels, with its ``(B, h, i, j)`` matrix
    explicit: dropout acts on that matrix, as in JAX."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.Conv_0 = Conv(dim, hidden * 3, (1, 1), use_bias=False)
        self.drop = QuantizedDropout(dropout)
        self.Conv_1 = Conv(hidden, dim, (1, 1))

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        B, _, H, W = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.Conv_0(x).chunk(3, dim=1))
        q = q * self.dim_head ** -0.5
        attn = torch.softmax(torch.einsum("bhdi,bhdj->bhij", q, k), dim=-1)
        attn = self.drop(attn, deterministic, generator)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v)
        out = out.reshape(B, -1, H, W).contiguous(memory_format=torch.channels_last)
        return self.Conv_1(out)


class PreNormResidual(nn.Module):
    """``x + fn(ChanLayerNorm(x))``. ``fn`` comes with the call: flax binds
    the attention that the UNet hands its ``PreNormResidual`` to the UNet's
    own scope (``LinearAttention_0``, ..., ``FullAttention_0``), so its
    parameters are not under this module."""

    def __init__(self, dim: int):
        super().__init__()
        self.ChanLayerNorm_0 = ChanLayerNorm(dim)

    def forward(self, x, fn: nn.Module, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        return x + fn(self.ChanLayerNorm_0(x), deterministic, generator)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The JAX package's UNet settings, same names and defaults."""

    img_shape: Tuple[int, int] = (180, 360)
    in_chans: int = 35
    out_chans: int = 35
    dim: int = 64
    dim_mults: Sequence[int] = (1, 2, 4, 8)
    resnet_block_groups: int = 8
    with_time_emb: bool = False
    time_dim_mult: int = 2
    block_dropout: float = 0.1
    block_dropout1: float = 0.1
    attn_dropout: float = 0.1
    input_dropout: float = 0.0
    double_conv_layer: bool = True
    outer_sample_mode: Optional[str] = None  # "nearest" | "bilinear"
    upsample_dims: Optional[Tuple[int, int]] = None
    keep_spatial_dims: bool = False
    init_kernel_size: int = 7
    dim_head: int = 32
    num_heads: int = 4
    debug_mode: bool = False

    def resolved(self) -> "UNetConfig":
        if self.debug_mode:
            return dataclasses.replace(self, dim=8, dim_mults=(1, 1, 1), debug_mode=False)
        return self


def _resize(x: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
    """``jax.image.resize`` of NCHW x to ``size``: "nearest", or "bilinear"
    with its antialiasing."""
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest-exact")
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class UNet(nn.Module):
    """The UNet backbone: ``(inputs, time, condition, static_condition) ->
    outputs``, all (B, H, W, C), float32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        cfg = cfg.resolved()
        self.cfg = cfg
        dims = [cfg.dim] + [cfg.dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        tdim = cfg.dim * cfg.time_dim_mult if cfg.with_time_emb else None
        k = cfg.init_kernel_size
        self.init_conv = Conv(cfg.in_chans, cfg.dim, (k, k))
        self.input_drop = QuantizedDropout(cfg.input_dropout)
        if cfg.with_time_emb:
            self.time_emb = TimeEmbedMLP(cfg.dim * cfg.time_dim_mult, cfg.dim)

        def block(c_in, feats):
            return ResnetBlock(c_in, feats, cfg.resnet_block_groups, cfg.block_dropout1,
                               cfg.block_dropout, cfg.double_conv_layer, tdim)

        n_lin = 0

        def attn(name, dim):
            # the attention sits in the UNet's scope under flax's auto-name
            nonlocal n_lin
            self.add_module(name, PreNormResidual(dim))
            self.add_module(f"LinearAttention_{n_lin}", LinearAttention(
                dim, cfg.num_heads, cfg.dim_head, cfg.attn_dropout))
            self.attn_fn[name] = f"LinearAttention_{n_lin}"
            n_lin += 1

        self.attn_fn = {}  # PreNormResidual -> the attention it applies
        hs: List[int] = []  # the channels of the skip tensors, in push order
        x = cfg.dim
        self.resamples_down = []
        for i, (dim_in, dim_out) in enumerate(in_out):
            down = i < len(in_out) - 1 and not cfg.keep_spatial_dims
            self.add_module(f"down{i}_block1", block(x, dim_in))
            self.add_module(f"down{i}_block2", block(dim_in, dim_in))
            attn(f"down{i}_attn", dim_in)
            hs += [dim_in, dim_in]
            if down:
                self.add_module(f"down{i}_downsample",
                                Conv(dim_in, dim_out, (4, 4), (2, 2), padding=(1, 1)))
            else:
                self.add_module(f"down{i}_conv", Conv(dim_in, dim_out, (3, 3)))
            self.resamples_down.append(down)
            x = dim_out
        mid = dims[-1]
        self.mid_block1 = block(mid, mid)
        self.mid_attn = PreNormResidual(mid)
        self.FullAttention_0 = FullAttention(mid, cfg.num_heads, cfg.dim_head, cfg.attn_dropout)
        self.attn_fn["mid_attn"] = "FullAttention_0"
        self.mid_block2 = block(mid, mid)
        self.resamples_up = []
        for i, (dim_in, dim_out) in enumerate(reversed(in_out)):
            up = i < len(in_out) - 1 and not cfg.keep_spatial_dims
            self.add_module(f"up{i}_block1", block(x + hs.pop(), dim_out))
            self.add_module(f"up{i}_block2", block(dim_out + hs.pop(), dim_out))
            attn(f"up{i}_attn", dim_out)
            self.add_module(f"up{i}_upsample" if up else f"up{i}_conv",
                            Conv(dim_out, dim_in, (3, 3)))
            self.resamples_up.append(up)
            x = dim_in
        self.final_res_block = block(x + cfg.dim, cfg.dim)
        self.final_conv = Conv(cfg.dim, cfg.out_chans, (1, 1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (on the parameters' device),
        with the JAX package's initializers: LeCun normal (truncated at two
        standard deviations, flax's ``lecun_normal``) for conv and Dense
        kernels, truncated normal(0.02) for the time embedding's kernels;
        zeros for biases, ones for the norms' scales."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel" and name.startswith("time_emb."):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif leaf == "kernel":
                fan_in = math.prod(p.shape[:-1])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)
            elif leaf == "bias":
                p.zero_()
            elif leaf in ("scale", "g"):
                p.fill_(1.0)
            else:
                raise KeyError(f"no initializer for parameter {name}")

    def forward(self, inputs: torch.Tensor, time: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                static_condition: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        conds = [c for c in (condition, static_condition) if c is not None]
        x = torch.cat([inputs] + conds, dim=-1) if conds else inputs
        x = x.float().contiguous().permute(0, 3, 1, 2)  # NCHW in channels_last memory
        orig_shape = tuple(x.shape[2:])
        resample = cfg.outer_sample_mode is not None and cfg.upsample_dims is not None
        if resample:
            x = _resize(x, cfg.upsample_dims, cfg.outer_sample_mode)

        x = self.init_conv(x)
        r = x
        if cfg.input_dropout > 0.0:
            x = _channels_last_dropout(self.input_drop, x, deterministic, generator)
            r = _channels_last_dropout(self.input_drop, r, deterministic, generator)

        t = None
        if cfg.with_time_emb:
            if time is None:
                raise ValueError("with_time_emb=True but no time given")
            t = self.time_emb(time.float())

        def run(name, x, *args):
            if name in self.attn_fn:
                args = (getattr(self, self.attn_fn[name]),)
            return getattr(self, name)(x, *args, deterministic, generator)

        hs = []
        for i, down in enumerate(self.resamples_down):
            x = run(f"down{i}_block1", x, t)
            hs.append(x)
            x = run(f"down{i}_block2", x, t)
            x = run(f"down{i}_attn", x)
            hs.append(x)
            x = getattr(self, f"down{i}_downsample" if down else f"down{i}_conv")(x)

        x = run("mid_block1", x, t)
        x = run("mid_attn", x)
        x = run("mid_block2", x, t)

        for i, up in enumerate(self.resamples_up):
            x = run(f"up{i}_block1", torch.cat([x, hs.pop()], dim=1), t)
            x = run(f"up{i}_block2", torch.cat([x, hs.pop()], dim=1), t)
            x = run(f"up{i}_attn", x)
            if up:
                x = self.get_submodule(f"up{i}_upsample")(
                    F.interpolate(x, scale_factor=2, mode="nearest-exact"))
            else:
                x = self.get_submodule(f"up{i}_conv")(x)

        x = torch.cat([x, r], dim=1)
        if resample:
            x = _resize(x, orig_shape, cfg.outer_sample_mode)
        x = run("final_res_block", x, t)
        return self.final_conv(x).permute(0, 2, 3, 1)
