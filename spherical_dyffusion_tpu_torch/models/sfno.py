"""Spherical Fourier Neural Operator, channels-last, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/models/sfno.py`` (``SFNOConfig``,
``SpectralConvS2``, ``FNOBlock``, ``SFNO``) for the configurations of the
main path: SHT transforms, the linear ``dhconv`` filter (dense, or
CP-factorized with the rank pipeline), instance norm, a gelu MLP and an
optional time embedding. ``scan_layers`` is accepted and runs as the same
plain loop over the blocks (the JAX package states both are the same math).
Fields whose other values the port does not implement raise in
``SFNOConfig.__post_init__`` rather than being ignored.

Mixed precision follows the JAX package: Dense layers compute in
``compute_dtype``; the transforms and spectral contractions round their
operands to ``sht_matmul_dtype`` and sum in float32, and
``spectral_io_dtype`` rounds the spectral stages' outputs (``ops/sht.py``);
parameters stay float32, and the residual stream is promoted to float32 by
the float32 time scale-shift, position embedding and filter output, so under
bf16 compute every block returns float32.

``use_pallas`` routes the dense contraction through the K1 kernel and
``fused_mlp`` the block MLP through the K2 kernel (the JAX package's flag
names). K1 is differentiable (its backward's dx runs K1 too), so
``use_pallas`` trains; K2, K3 and K4 have no backward and refuse autograd,
so a network that trains keeps ``fused_mlp``, ``fused_tail`` and
``fused_rank`` off, as the JAX trainer does. A training forward passes
``deterministic=False`` and a host generator for the dropout masks. ``fused_tail`` (for instance norm, an MLP and a gelu) takes
precedence over ``fused_mlp``: each block folds norm1 and, with
``time_scale_shift_before_filter=False``, the time scale-shift into one
per-(sample, channel) affine (``InstanceNorm2d(fold=True)``) and runs
norm-apply, MLP and outer skip as the K3 kernel, as the JAX package's
boundary-corrected block tail does. ``SFNO(cfg, fused_rank=True)`` routes
the spectral middle of every block that takes the CP rank pipeline (Legendre
analysis, CP scale, Legendre synthesis) through the K4 kernel. It is a
keyword of the port's model, not a config field, because ``SFNOConfig``
mirrors the JAX package's config field for field; it is off by default, so a
config computes the JAX package's three separate stages unless asked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.contractions import (
    contract,
    contract_dhconv_cp,
    cp_spatial_expand,
    cp_spatial_project,
    cp_spectral_scale_stacked,
)
from ..ops.fused_rank import fused_rank as fused_rank_kernel
from ..ops.matmul import as_dtype
from ..ops.pallas_contractions import WeightImageCache
from ..ops.sht import InverseRealSHT, RealSHT
from .modules import (
    Dense,
    DropPath,
    InstanceNorm2d,
    MLP2d,
    QuantizedDropout,
    TimeEmbedMLP,
    get_activation,
)

__all__ = ["SFNOConfig", "SFNO", "FNOBlock", "SpectralConvS2"]

# field -> the values the port implements (the JAX package's default first)
_SUPPORTED = {
    "spectral_transform": ("sht",),
    "filter_type": ("linear",),
    "operator_type": ("dhconv",),
    "separable": (False,),
    "checkpointing": (0,),
    "factorization": (None, "", "cp"),
    "spectral_io_dtype": ("", "bfloat16"),
    "lon_method": ("matmul",),
    "sht_fold_symmetry": (False,),
    "merged_dhconv": (False,),
    "sht_matmul_dtype": ("float32", "bfloat16"),
    "fused_mlp_tile_rows": (1024,),
}


@dataclasses.dataclass(frozen=True)
class SFNOConfig:
    """Static configuration, with the JAX package's field names."""

    img_shape: Tuple[int, int] = (180, 360)
    in_chans: int = 35
    out_chans: int = 35
    embed_dim: int = 256
    num_layers: int = 8
    scale_factor: int = 1
    spectral_transform: str = "sht"
    filter_type: str = "linear"
    operator_type: str = "dhconv"
    separable: bool = False
    mlp_ratio: float = 2.0
    use_mlp: bool = True
    activation_function: str = "gelu"
    encoder_layers: int = 1
    pos_embed: bool = True
    big_skip: bool = True
    normalization_layer: str = "instance_norm"  # "instance_norm" | "none"
    exact_norm: bool = False
    exact_dropout: bool = False
    hard_thresholding_fraction: float = 1.0
    fused_mlp: bool = False
    fused_mlp_tile_rows: int = 1024
    fused_tail: bool = False
    scan_layers: bool = False
    dropout_mlp: float = 0.0
    dropout_filter: float = 0.0
    pos_emb_dropout: float = 0.0
    drop_path_rate: float = 0.0
    checkpointing: int = 0
    data_grid: str = "equiangular"
    with_time_emb: bool = False
    time_dim_mult: int = 2
    time_rescale: bool = False
    time_scale_shift_before_filter: bool = True
    min_time: float = 0.0
    max_time: float = 1000.0
    factorization: Optional[str] = None
    rank: float = 1.0
    rank_pipeline: bool = True
    spectral_layers: int = 3
    complex_activation: str = "real"
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    sht_matmul_dtype: str = "float32"
    spectral_io_dtype: str = ""
    lon_method: str = "matmul"
    sht_fold_symmetry: bool = False
    use_pallas: bool = False
    merged_dhconv: bool = False
    debug_mode: bool = False

    def __post_init__(self):
        for name, values in _SUPPORTED.items():
            if getattr(self, name) not in values:
                raise NotImplementedError(
                    f"SFNOConfig.{name}={getattr(self, name)!r}: the port implements "
                    f"only {values}")
        if self.normalization_layer not in ("instance_norm", "none"):
            raise NotImplementedError(
                f"normalization_layer={self.normalization_layer!r} is not ported")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")

    def resolved(self) -> "SFNOConfig":
        if self.debug_mode:
            return dataclasses.replace(self, embed_dim=16, num_layers=2, debug_mode=False)
        return self

    @property
    def model_shape(self) -> Tuple[int, int]:
        return (self.img_shape[0] // self.scale_factor,
                self.img_shape[1] // self.scale_factor)

    @property
    def modes(self) -> Tuple[int, int]:
        h, w = self.model_shape
        return (int(h * self.hard_thresholding_fraction),
                int((w // 2 + 1) * self.hard_thresholding_fraction))

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class SpectralConvS2(nn.Module):
    """SHT -> spectral weight -> ISHT (+ bias). Returns ``(filtered,
    residual)``; the residual is the input regridded through ISHT(SHT(x))
    when the two transforms' grids differ, else the input.

    The weight is dense (``weight (ci, co, lmax, 2)``) or, with
    ``factorization="cp"``, the CP factors ``cp_A (ci, R, 2)``,
    ``cp_B (co, R, 2)`` and ``cp_C (lmax, R, 2)`` with
    ``R = max(1, int(rank * min(ci, co)))`` (the flax names). A CP filter
    whose two transforms share a grid, with ``2R <= min(ci, co)``, runs the
    rank pipeline: project to rank in grid space, transform 2R channels,
    scale per l, inverse-transform, expand in grid space; the other CP
    filters contract in spectral space (``contract_dhconv_cp``).
    ``fused_rank`` runs the rank pipeline's spectral middle as the K4 kernel.
    """

    def __init__(self, forward_transform: RealSHT, inverse_transform: InverseRealSHT,
                 in_channels: int, out_channels: int, use_pallas: bool = False,
                 operator_type: str = "dhconv", separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0,
                 rank_pipeline: bool = False, matmul_dtype: str = "float32",
                 io_dtype: str = "", fused_rank: bool = False):
        super().__init__()
        # held outside the module tree: the SFNO owns the shared transforms
        self._transforms = (forward_transform, inverse_transform)
        self.use_pallas = use_pallas
        self.factorization = factorization or ""
        self.matmul_dtype = as_dtype(matmul_dtype)
        lmax = forward_transform.lmax
        if self.factorization == "cp":
            R = max(1, int(rank * min(in_channels, out_channels)))
            self.cp_A = nn.Parameter(torch.empty(in_channels, R, 2))
            self.cp_B = nn.Parameter(torch.empty(out_channels, R, 2))
            self.cp_C = nn.Parameter(torch.empty(lmax, R, 2))
        elif self.factorization:
            raise NotImplementedError(f"factorization {factorization!r} is not ported")
        else:
            self.weight = nn.Parameter(torch.empty(in_channels, out_channels, lmax, 2))
        # K1's weight images, made on the card once per weight version (not
        # saved): the forward's, and the backward's conjugate transpose
        k1 = use_pallas and not self.factorization
        self._k1_image = WeightImageCache() if k1 else None
        self._k1_image_t = WeightImageCache(conj_t=True) if k1 else None
        self.bias = nn.Parameter(torch.zeros(out_channels))
        fwd, inv = forward_transform, inverse_transform
        self.scale_residual = (fwd.nlat, fwd.nlon, fwd.grid) != (inv.nlat, inv.nlon, inv.grid)
        # the JAX package's gate (models/sfno.py:323-334), condition for
        # condition
        self.rank_pipeline = (
            rank_pipeline
            and self.factorization in ("cp", "tucker")
            and operator_type == "dhconv"
            and not separable
            and not self.scale_residual
            and isinstance(fwd, RealSHT)
            and isinstance(inv, InverseRealSHT)
            and 2 * R <= min(in_channels, out_channels)
        )
        # the rank pipeline emits io_dtype; the dense filter only on the
        # stacked path the JAX package takes for it (no Pallas kernel)
        stackable = not self.factorization and not use_pallas
        self.io_dtype = as_dtype(io_dtype) if (self.rank_pipeline or stackable) else None
        self.fused_rank = fused_rank and self.rank_pipeline
        if self.fused_rank and (self.matmul_dtype, self.io_dtype) not in (
                (torch.float32, None), (torch.bfloat16, torch.bfloat16)):
            raise NotImplementedError(
                "fused_rank: K4 rounds like sht_matmul_dtype = spectral_io_dtype = bfloat16 "
                "or computes in float32 throughout; other mixes are not implemented")
        if self.fused_rank:  # where K4 may start: A[m] and S[m] are zero before it
            self.register_buffer("rank_l_first", torch.minimum(fwd.analysis_l_first,
                                                               inv.synthesis_l_first),
                                 persistent=False)

    def _rank_pipeline(self, x: torch.Tensor) -> torch.Tensor:
        fwd, inv = self._transforms
        md, io = self.matmul_dtype, self.io_dtype
        z = cp_spatial_project(x.float(), self.cp_A, md, out_dtype=io)
        xf = fwd.longitude(z, out_dtype=io)
        if self.fused_rank:
            y = fused_rank_kernel(xf.contiguous(), fwd.analysis_mhl, inv.synthesis_mhl,
                                  self.cp_C.float().contiguous(), self.rank_l_first)
        else:
            zs = fwd.latitude(xf, out_dtype=io)
            y = inv.latitude(cp_spectral_scale_stacked(zs, self.cp_C), out_dtype=io)
        g = inv.longitude(y, out_dtype=io)
        return cp_spatial_expand(g, self.cp_B, md, out_dtype=io)

    def forward(self, x: torch.Tensor):
        fwd, inv = self._transforms
        dtype = x.dtype
        residual = x
        if self.rank_pipeline:
            return (self._rank_pipeline(x) + self.bias).to(dtype), residual
        io = self.io_dtype
        xs = fwd(x.float(), out_dtype=io)
        if self.scale_residual:
            residual = inv(xs).to(dtype)
        if self.factorization == "cp":
            factors = {"A": self.cp_A, "B": self.cp_B, "C": self.cp_C}
            ys = contract_dhconv_cp(xs, factors, self.matmul_dtype)
        else:
            image = self._k1_image(self.weight) \
                if self._k1_image is not None and self.weight.is_cuda else None
            ys = contract(xs, self.weight, self.use_pallas, self.matmul_dtype, out_dtype=io,
                          image=image, image_t=self._k1_image_t)
        out = inv(ys, out_dtype=io) + self.bias
        return out.to(dtype), residual


class FNOBlock(nn.Module):
    """norm0 -> (time scale-shift) -> spectral filter -> + inner skip -> act
    -> norm1 -> MLP -> (drop path) -> + outer skip."""

    def __init__(self, cfg: SFNOConfig, forward_transform, inverse_transform,
                 drop_path: float = 0.0, fused_rank: bool = False):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        compute = cfg.torch_compute_dtype
        self.drop_path_rate = drop_path
        if cfg.normalization_layer == "instance_norm":
            self.norm0 = InstanceNorm2d(C, exact=cfg.exact_norm)
            self.norm1 = InstanceNorm2d(C, exact=cfg.exact_norm)
        else:
            self.norm0 = self.norm1 = nn.Identity()
        if cfg.with_time_emb:
            self.time_mlp = Dense(C * cfg.time_dim_mult, 2 * C)
        self.filter = SpectralConvS2(
            forward_transform, inverse_transform, C, C, use_pallas=cfg.use_pallas,
            operator_type=cfg.operator_type, separable=cfg.separable,
            factorization=cfg.factorization, rank=cfg.rank, rank_pipeline=cfg.rank_pipeline,
            matmul_dtype=cfg.sht_matmul_dtype, io_dtype=cfg.spectral_io_dtype,
            fused_rank=fused_rank)
        self.inner_skip = Dense(C, C, dtype=compute)
        # the fused tail folds norm1 and the time scale-shift into the K3
        # kernel (the JAX package's gating, models/sfno.py:596-598)
        self.use_tail = (cfg.fused_tail and cfg.use_mlp
                         and cfg.normalization_layer == "instance_norm"
                         and cfg.activation_function in ("gelu", "gelu_exact"))
        if cfg.use_mlp:
            self.mlp = MLP2d(C, int(C * cfg.mlp_ratio), C,
                             activation=cfg.activation_function,
                             drop_rate=cfg.dropout_mlp, dtype=compute,
                             fused=cfg.fused_mlp or self.use_tail,
                             exact_dropout=cfg.exact_dropout)
        self.drop_path = DropPath(drop_path)

    def _scale_shift(self, time_emb: torch.Tensor):
        emb = self.time_mlp(torch.nn.functional.silu(time_emb))
        return emb[:, None, None, :].chunk(2, dim=-1)

    def _time_scale_shift(self, h: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self._scale_shift(time_emb)
        return h * (scale + 1.0) + shift

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        x_norm = self.norm0(x)
        if time_emb is not None and cfg.time_scale_shift_before_filter:
            x_norm = self._time_scale_shift(x_norm, time_emb)
        x_f, residual = self.filter(x_norm)
        x = get_activation(cfg.activation_function)(x_f + self.inner_skip(residual))
        dp_active = self.drop_path_rate > 0.0 and not deterministic
        if self.use_tail:
            # norm1 (and the time scale-shift after the filter) as one
            # per-(sample, channel) affine applied inside K3; a live DropPath
            # keeps the outer skip out of the kernel
            A, B = self.norm1(x, fold=True)
            if time_emb is not None and not cfg.time_scale_shift_before_filter:
                scale, shift = self._scale_shift(time_emb)
                A, B = A * (scale + 1.0), B * (scale + 1.0) + shift
            x = self.mlp(x, deterministic, None if dp_active else residual, generator,
                         affine=(A, B))
            if dp_active:
                return self.drop_path(x, deterministic, generator) + residual
            return x
        x = self.norm1(x)
        if time_emb is not None and not cfg.time_scale_shift_before_filter:
            x = self._time_scale_shift(x, time_emb)
        if cfg.use_mlp:
            # the fused kernel adds the outer skip itself unless a live
            # DropPath has to act on the MLP output first
            fuse_res = cfg.fused_mlp and not dp_active
            x = self.mlp(x, deterministic, residual if fuse_res else None, generator)
            if dp_active:
                x = self.drop_path(x, deterministic, generator)
            return x if fuse_res else x + residual
        if dp_active:
            x = self.drop_path(x, deterministic, generator)
        return x + residual


class SFNO(nn.Module):
    """The SFNO backbone: ``(inputs, time, condition, static_condition) ->
    outputs``, all (B, H, W, C), output float32."""

    def __init__(self, cfg: SFNOConfig, fused_rank: bool = False):
        super().__init__()
        cfg = cfg.resolved()
        self.cfg = cfg
        compute = cfg.torch_compute_dtype
        C = cfg.embed_dim
        lmax, mmax = cfg.modes
        H, W = cfg.img_shape
        h, w = cfg.model_shape
        # the JAX package's _build_transforms; K4's (m, h, l) matrices are
        # made here once, in the matmul dtype
        kw = dict(matmul_dtype=cfg.sht_matmul_dtype, kernel_layout=fused_rank)
        self.trans_down = RealSHT(H, W, lmax, mmax, grid=cfg.data_grid, **kw)
        self.itrans_up = InverseRealSHT(H, W, lmax, mmax, grid=cfg.data_grid, **kw)
        self.trans = RealSHT(h, w, lmax, mmax, grid="legendre-gauss", **kw)
        self.itrans = InverseRealSHT(h, w, lmax, mmax, grid="legendre-gauss", **kw)

        width = cfg.in_chans
        for i in range(cfg.encoder_layers):
            self.add_module(f"encoder_{i}", Dense(width, C, dtype=compute))
            width = C
        self.encoder_out = Dense(width, C, use_bias=False, dtype=compute)
        if cfg.pos_embed:
            self.pos_embed = nn.Parameter(torch.empty(1, H, W, C))
        self.pos_drop = QuantizedDropout(cfg.pos_emb_dropout, exact=cfg.exact_dropout)
        if cfg.with_time_emb:
            self.time_emb = TimeEmbedMLP(C * cfg.time_dim_mult, C)
        n = cfg.num_layers
        self.blocks = []
        for i in range(n):
            first, last = i == 0, i == n - 1
            block = FNOBlock(cfg, self.trans_down if first else self.trans,
                             self.itrans_up if last else self.itrans,
                             drop_path=cfg.drop_path_rate * i / max(n - 1, 1),
                             fused_rank=fused_rank)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        width = C + (cfg.in_chans if cfg.big_skip else 0)
        for i in range(cfg.encoder_layers):
            self.add_module(f"decoder_{i}", Dense(width, C, dtype=compute))
            width = C
        self.decoder_out = Dense(width, cfg.out_chans, use_bias=False, dtype=compute)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (on the parameters' device),
        with the JAX package's initializers: truncated normal(0.02) for
        Dense kernels and the position embedding, normal(1/(ci*co)) for the
        dense spectral weights, normal((1/(ci*co))**(1/3)) for the CP
        factors, ones for norm scales, zeros for biases."""
        cp_std = (1.0 / (self.cfg.embed_dim * self.cfg.embed_dim)) ** (1.0 / 3.0)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel" or leaf == "pos_embed":
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif name.endswith("filter.weight"):
                p.normal_(0.0, 1.0 / (p.shape[0] * p.shape[1]), generator=generator)
            elif leaf.startswith("cp_"):
                p.normal_(0.0, cp_std, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                raise KeyError(f"no initializer for parameter {name}")

    def forward(self, inputs: torch.Tensor, time: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                static_condition: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        act = get_activation(cfg.activation_function)
        compute = cfg.torch_compute_dtype
        conds = [c for c in (condition, static_condition) if c is not None]
        x = torch.cat([inputs] + conds, dim=-1) if conds else inputs
        x = x.to(compute)
        big_skip = x
        for i in range(cfg.encoder_layers):
            x = act(getattr(self, f"encoder_{i}")(x))
        x = self.encoder_out(x)
        if cfg.pos_embed:
            x = x + self.pos_embed
            x = self.pos_drop(x, deterministic, generator)
        t_repr = None
        if cfg.with_time_emb:
            if time is None:
                raise ValueError("cfg.with_time_emb=True but no time passed")
            t = time.float()
            if cfg.time_rescale:
                t = (t - cfg.min_time) * (1000.0 / (cfg.max_time - cfg.min_time))
            t_repr = self.time_emb(t)
        for block in self.blocks:
            x = block(x, t_repr, deterministic, generator)
        if cfg.big_skip:
            dtype = torch.promote_types(x.dtype, big_skip.dtype)
            x = torch.cat([x.to(dtype), big_skip.to(dtype)], dim=-1)
        for i in range(cfg.encoder_layers):
            x = act(getattr(self, f"decoder_{i}")(x))
        return self.decoder_out(x).float()
