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

A grid split over "h" (latitudes) and "w" (longitudes) (``UNet.set_mesh``)
runs as JAX's ``jit``-with-shardings partitions the same program. The
levels at the top of the network run on this rank's block, as far as
``level_plan`` allows (each level's grid must divide over the mesh with
blocks at least as wide as its halo; the bottleneck level, whose
``FullAttention`` reads every pixel, never splits); from the first level
that does not split down to the bottleneck and back up to it, the network
runs whole on every rank of the spatial group. On a block:

* a conv first takes ``kh // 2`` rows and ``kw // 2`` columns from the
  neighbouring blocks (``parallel/mesh.py:halo_exchange``; zeros beyond the
  grid's edges, as "SAME" pads) and convolves with no padding: 3 rows for
  the 7x7 ``init_conv``, 1 for the 3x3s and for the 4x4 stride-2
  downsample, whose output block is the input block's half (block origins
  are even); the x2 nearest upsample is local;
* the outer resampler applies the whole grid's 1-D weights (the resize of
  an identity, so the weights the one-process resize takes) to its block
  and a halo as wide as those weights reach;
* GroupNorm takes its group moments over the whole grid (two passes, each
  block's share summed over "h" then "w"); ``LinearAttention`` takes the
  grid's max and sum of exponentials for ``k``'s softmax over pixels, the
  grid's pixel count for ``v``, and sums ``k v^T`` over the grid;
  ``ChanLayerNorm`` and ``q``'s softmax are per pixel;
* dropout draws the whole grid's bits and keeps the block's (its
  ``_mesh``), so every block drops what one process drops there; a level
  that runs whole draws as one process does.

The input of the first whole level's downsample is gathered (``gather``,
"w" then "h") and the up path's output at that level cut back to the
block; where level 0 itself does not split, the whole input is gathered,
the whole network run, and the block kept.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import (
    AXIS_H,
    AXIS_W,
    Mesh,
    all_reduce_spatial,
    gather,
    halo_exchange,
    shard,
    spatial_block,
)
from .modules import Dense, QuantizedDropout, TimeEmbedMLP

__all__ = ["UNetConfig", "UNet", "Conv", "WSConv", "ChanLayerNorm", "GroupNorm", "ConvBlock",
           "ResnetBlock", "LinearAttention", "FullAttention", "PreNormResidual", "LevelPlan",
           "level_plan"]

_NCHW = (None, None, AXIS_H, AXIS_W)  # the spatial dims of an NCHW tensor, for shard/gather


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
    ``(pad_h, pad_w)``. On a split grid (``_mesh``) the padding rows and
    columns are the neighbouring blocks' (``halo_exchange``)."""

    _mesh: Optional[Mesh] = None

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
        if self._mesh is None:
            return F.conv2d(x, w, self.bias, self.strides, self.padding)
        x = halo_exchange(self._mesh, x.permute(0, 2, 3, 1), *self.padding).permute(0, 3, 1, 2)
        return F.conv2d(x, w, self.bias, self.strides)


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
    ``F.group_norm``; on a split grid (``_mesh``) with the whole grid's
    group moments, in two passes as ``F.group_norm`` takes them."""

    _mesh: Optional[Mesh] = None

    def __init__(self, features: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self._mesh
        if mesh is None:
            return F.group_norm(x, self.num_groups, self.scale, self.bias, eps=1e-6)
        H, W = x.shape[2:]
        share = H * W / math.prod(spatial_block(mesh, (H, W)).shape)
        xg = x.float().unflatten(1, (self.num_groups, -1))  # (B, G, C / G, H, W)
        mean = all_reduce_spatial(xg.mean(dim=(2, 3, 4)) * share, mesh)[..., None, None, None]
        xc = xg - mean
        var = all_reduce_spatial(xc.square().mean(dim=(2, 3, 4)) * share, mesh)
        y = (xc * torch.rsqrt(var + 1e-6)[..., None, None, None]).flatten(1, 2)
        return y * self.scale[:, None, None] + self.bias[:, None, None]


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
    the pixels, v over the pixel count; ``context = k v^T`` per head. On a
    split grid (``_mesh``) k's softmax takes the grid's max, and the sum of
    its exponentials goes with the block's part of ``k v^T`` into one sum
    over the grid."""

    _mesh: Optional[Mesh] = None

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
        mesh = self._mesh
        if mesh is None:
            k = torch.softmax(k, dim=3)
            v = v / (H * W)
            context = torch.einsum("bhdn,bhen->bhde", k, v)
        else:
            top = all_reduce_spatial(k.amax(dim=3, keepdim=True), mesh, dist.ReduceOp.MAX)
            e = torch.exp(k - top)
            v = v / math.prod(spatial_block(mesh, (H, W)).shape)
            # [sum_n e_dn v_en | sum_n e_dn] over the grid, then softmax's division
            sums = all_reduce_spatial(torch.cat([torch.einsum("bhdn,bhen->bhde", e, v),
                                                 e.sum(dim=3, keepdim=True)], dim=3), mesh)
            context = sums[..., :-1] / sums[..., -1:]
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


def _resize_matrix(n_in: int, n_out: int, mode: str, device=None) -> torch.Tensor:
    """The (n_out, n_in) float32 weights of ``_resize`` along one axis: the
    resize of an identity on ``device``, so the weights that the whole
    grid's resize takes there (both modes are separable). The identity is
    two columns wide: torch's antialiased bilinear mishandles a width of
    one."""
    eye = torch.eye(n_in, device=device)[None, :, :, None].expand(1, n_in, n_in, 2)
    return _resize(eye.contiguous(), (n_out, 2), mode)[0, :, :, 0].T.contiguous()


def _resize_halo(m: torch.Tensor, n: int) -> int:
    """The most rows beyond its own block, on either side, that a block of
    an ``n``-way split reads through the resize weights ``m`` (n_out,
    n_in): the reach of their nonzero columns."""
    n_out, n_in = m.shape
    if n == 1:
        return 0
    cols = torch.arange(n_in, device=m.device)
    first = torch.where(m != 0, cols, n_in).amin(dim=1)
    last = torch.where(m != 0, cols, -1).amax(dim=1)
    start = torch.arange(n_out, device=m.device) // (n_out // n) * (n_in // n)
    return max(int((start - first).max()), int((last + 1 - start - n_in // n).max()), 0)


def _block_resize(x: torch.Tensor, size: Tuple[int, int], mode: str, mesh: Mesh,
                  weights: dict) -> torch.Tensor:
    """``_resize`` of this rank's block ``x`` (NCHW) of the grid to its
    block of the whole grid resized to ``size``: the whole grid's weights
    (zero columns beyond its edges) applied to the block and its halo.
    ``weights`` caches each axis's padded weights and halo."""
    ways = (mesh.shape[AXIS_H], mesh.shape[AXIS_W])
    local = tuple(x.shape[2:])
    out_local = tuple(n // k for n, k in zip(size, ways))
    at, out_at = spatial_block(mesh, local), spatial_block(mesh, out_local)
    mats, halos = [], []
    for n_in, n_out, k, origin, out_origin, ln, lo in zip(
            at.shape, size, ways, (at.h0, at.w0), (out_at.h0, out_at.w0), local, out_local):
        key = (n_in, n_out, mode, k, x.device)
        if key not in weights:
            m = _resize_matrix(n_in, n_out, mode, x.device)
            r = _resize_halo(m, k)
            weights[key] = (F.pad(m, (r, r)), r)
        m, r = weights[key]
        mats.append(m[out_origin:out_origin + lo, origin:origin + ln + 2 * r])
        halos.append(r)
    x = halo_exchange(mesh, x.permute(0, 2, 3, 1), *halos).permute(0, 3, 1, 2)
    return (mats[0] @ x @ mats[1].T).contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """How a UNet runs on a grid split ``h`` x ``w`` ways: ``grids`` the
    (H, W) of each level (level 0 is the outer resampler's grid where there
    is one); the levels below ``split`` run on this rank's block, the
    others whole on every rank."""

    grids: Tuple[Tuple[int, int], ...]
    split: int


def level_plan(cfg: UNetConfig, h: int, w: int) -> LevelPlan:
    """The ``LevelPlan`` of ``cfg`` on ``h`` x ``w`` blocks. Level i splits
    where every level above it does, it is not the bottleneck's, its grid
    divides over (h, w) with blocks at least as wide as its halo (3 rows
    and columns for the 7x7 ``init_conv`` at level 0, else 1), and, for
    level 0, the outer resampler's weights reach no further than the
    neighbouring block on either grid (the input's grid must divide too)."""
    cfg = cfg.resolved()
    ways = (h, w)
    resample = cfg.outer_sample_mode is not None and cfg.upsample_dims is not None
    grid = tuple(cfg.upsample_dims) if resample else tuple(cfg.img_shape)
    grids = [grid]
    for _ in cfg.dim_mults[1:]:
        if not cfg.keep_spatial_dims:
            grid = (grid[0] // 2, grid[1] // 2)
        grids.append(grid)

    def fits(grid, halo):
        return all(k == 1 or (g % k == 0 and g // k >= halo) for g, k in zip(grid, ways))

    def resamples():  # the outer resize and its inverse, along each axis
        return all(_resize_halo(_resize_matrix(a, b, cfg.outer_sample_mode), k) <= a // k
                   for top, orig, k in zip(grids[0], cfg.img_shape, ways)
                   for a, b in ((orig, top), (top, orig)))

    split = 0
    while (split < len(grids) - 1
           and fits(grids[split], max(cfg.init_kernel_size // 2, 1) if split == 0 else 1)
           and (split > 0 or (fits(cfg.img_shape, 1) and (not resample or resamples())))):
        split += 1
    return LevelPlan(tuple(grids), split)


class UNet(nn.Module):
    """The UNet backbone: ``(inputs, time, condition, static_condition) ->
    outputs``, all (B, H, W, C), float32."""

    _mesh: Optional[Mesh] = None

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        cfg = cfg.resolved()
        self.cfg = cfg
        self.plan: Optional[LevelPlan] = None
        self._resize_weights = {}  # (n_in, n_out, mode, ways, device) -> (padded weights, halo)
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

    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Attach a process mesh (``parallel/mesh.py``; None detaches it):
        from then on ``forward`` takes this rank's block of the grid,
        latitudes over "h" and longitudes over "w", and returns its block of
        the output. The plan of levels (``level_plan``, kept as ``plan``)
        decides which modules run on the block: only theirs get the mesh
        (the bottleneck's ``FullAttention`` never does). Parameters are left
        as they are. A grid that does not split raises ``ValueError``; with
        "h" and "w" at 1 the block is the whole grid, its collectives over
        groups of one."""
        for m in self.modules():
            if hasattr(type(m), "_mesh"):
                m._mesh = None
        self.plan = None
        self._resize_weights.clear()
        if mesh is None:
            return
        nh, nw = mesh.shape[AXIS_H], mesh.shape[AXIS_W]
        H, W = self.cfg.img_shape
        if H % nh or W % nw:
            raise ValueError(f"UNet on the mesh {mesh.shape}: {H} latitudes and {W} longitudes "
                             f"must split over h={nh}, w={nw}")
        plan = level_plan(self.cfg, nh, nw)
        n, s = len(self.resamples_down), plan.split
        names = ["init_conv", "input_drop", "final_res_block", "final_conv"] if s else []
        for i, down in enumerate(self.resamples_down[:s]):
            names += [f"down{i}_block1", f"down{i}_block2", self.attn_fn[f"down{i}_attn"]]
            if i < s - 1:  # its output level splits too
                names.append(f"down{i}_downsample" if down else f"down{i}_conv")
        for u, up in enumerate(self.resamples_up[n - s:], start=n - s):
            names += [f"up{u}_block1", f"up{u}_block2", self.attn_fn[f"up{u}_attn"],
                      f"up{u}_upsample" if up else f"up{u}_conv"]
        for name in names:
            for m in self.get_submodule(name).modules():
                if hasattr(type(m), "_mesh"):
                    m._mesh = mesh
        self._mesh, self.plan = mesh, plan

    def forward(self, inputs: torch.Tensor, time: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                static_condition: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        conds = [c for c in (condition, static_condition) if c is not None]
        x = torch.cat([inputs] + conds, dim=-1) if conds else inputs
        mesh = self._mesh
        if mesh is None:
            return self._net(x, time, deterministic, generator)
        if mesh.spatial and torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise NotImplementedError(
                "UNet on a split grid computes forwards only (the trainer replicates its step "
                "over 'h' and 'w'); run it under torch.no_grad() or inference")
        whole = spatial_block(mesh, x.shape[1:3]).shape
        if whole != tuple(self.cfg.img_shape):
            raise ValueError(f"UNet on the mesh {mesh.shape}: a block {tuple(x.shape[1:3])} of "
                             f"a {whole} grid, not of the configured {self.cfg.img_shape}")
        if self.plan.split == 0:  # no level splits: the whole network on every rank
            spec = (None, AXIS_H, AXIS_W, None)
            y = self._net(gather(mesh, x, spec), time, deterministic, generator)
            return shard(mesh, y, spec).contiguous()
        return self._net(x, time, deterministic, generator, self.plan.split)

    def _net(self, x: torch.Tensor, time: Optional[torch.Tensor], deterministic: bool,
             generator: Optional[torch.Generator], split: Optional[int] = None) -> torch.Tensor:
        """The network on (B, H, W, C) x. With ``split``, x is this rank's
        block and the levels below ``split`` run on blocks: the input of
        level ``split``'s downsample is gathered, and the up path's output
        at that level cut back to the block."""
        cfg = self.cfg
        mesh = self._mesh
        x = x.float().contiguous().permute(0, 3, 1, 2)  # NCHW in channels_last memory
        orig_shape = tuple(x.shape[2:])
        resample = cfg.outer_sample_mode is not None and cfg.upsample_dims is not None
        resize = (functools.partial(_block_resize, mesh=mesh, weights=self._resize_weights)
                  if split else _resize)
        if resample:
            orig_shape = tuple(cfg.img_shape) if split else orig_shape
            x = resize(x, cfg.upsample_dims, cfg.outer_sample_mode)

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
            if i == (split or 0) - 1:  # the next level runs whole
                x = gather(mesh, x, _NCHW).contiguous(memory_format=torch.channels_last)
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
            if split and i == len(self.resamples_up) - 1 - split:  # back to the split levels
                x = shard(mesh, x, _NCHW).contiguous(memory_format=torch.channels_last)

        x = torch.cat([x, r], dim=1)
        if resample:
            x = resize(x, orig_shape, cfg.outer_sample_mode)
        x = run("final_res_block", x, t)
        return self.final_conv(x).permute(0, 2, 3, 1)
