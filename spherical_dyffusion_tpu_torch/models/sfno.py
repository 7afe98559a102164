"""Spherical Fourier Neural Operator, channels-last, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/models/sfno.py`` (``SFNOConfig``,
``SpectralConvS2``, ``SpectralAttentionS2``, ``FNOBlock``, ``SFNO``) over the
JAX package's configuration space:

- transforms: the SHT (``lon_method`` "matmul" or "fft",
  ``sht_fold_symmetry``) or the planar FFT (``spectral_transform="fft"``);
- the linear filter (``filter_type="linear"``): ``operator_type`` "dhconv"
  or "diagonal", separable or not, dense or factorized (``factorization``
  "cp", "tucker" or "tt"); CP and Tucker take the rank pipeline where the
  JAX package does; ``merged_dhconv`` computes the dense dhconv as one
  product;
- the non-linear filter (``filter_type="non-linear"``, spectral attention):
  a complex MLP per mode, shared ("dhconv"/"diagonal") or per degree
  ("l-dependant"), with the complex activations "real", "cartesian" and
  "complex";
- ``normalization_layer`` "instance_norm", "layer_norm" or "none"; any
  activation of ``get_activation``; ``use_mlp``; ``scale_factor``; an
  optional time embedding;
- remat (``checkpointing >= 3``, below).

``scan_layers`` runs the same plain loop over the blocks (the JAX package
states both are the same math; its stacked parameter layout is unstacked by
``utils/convert.py``). Values that the JAX package rejects raise in
``SFNOConfig.__post_init__``, and so do compute, matmul and spectral-IO
dtypes other than float32, bfloat16 and float16, and a non-linear
``operator_type`` name outside "dhconv", "diagonal" and "l-dependant", which
the JAX package reads as "diagonal". The transforms check their own names
(``ops/sht.py``): an unknown ``lon_method``, which the JAX package reads as
"fft", raises at model build.

Remat: with ``checkpointing >= 3`` every block runs under
``torch.utils.checkpoint`` (non-reentrant), the middle blocks under
``scan_layers`` included, as the JAX package wraps each block (and its scan
body) in ``nn.remat`` from 3 on; lower values remat nothing (the JAX field's
comment says 1 remats the encoder and decoder, but its code does not). A
block is checkpointed only where autograd records; at inference it is the
plain forward. The recompute draws exactly the dropout and DropPath bits of
the forward, as flax replays its keys: it runs on a copy of the caller's
host generator restored to the state the block's forward started from, so
the caller's generator ends the step where it would without remat.

Mixed precision follows the JAX package: Dense layers compute in
``compute_dtype``; the transforms and spectral contractions round their
operands to ``sht_matmul_dtype`` and sum in float32, and
``spectral_io_dtype`` rounds the spectral stages' outputs (``ops/sht.py``);
parameters stay float32, and the residual stream is promoted to float32 by
the float32 time scale-shift, position embedding and filter output, so under
bf16 or float16 compute every block returns float32.

``use_pallas`` routes the dense dhconv contraction that is not separable
through the K1 kernel and ``fused_mlp`` the block MLP through the K2 kernel
(the JAX package's flag names). K1 is differentiable (its backward's dx runs
K1 too), so ``use_pallas`` trains, remat included; K2, K3 and K4 have no
backward and refuse autograd, so a network that trains keeps
``fused_mlp``, ``fused_tail`` and ``fused_rank`` off, as the JAX trainer
does. A training forward passes ``deterministic=False`` and a host generator
for the dropout masks. ``fused_tail`` (for instance norm, an MLP and a gelu)
takes precedence over ``fused_mlp``: each block folds norm1 and, with
``time_scale_shift_before_filter=False``, the time scale-shift into one
per-(sample, channel) affine (``InstanceNorm2d(fold=True)``) and runs
norm-apply, MLP and outer skip as the K3 kernel, as the JAX package's
boundary-corrected block tail does. ``SFNO(cfg, fused_rank=True)`` routes
the spectral middle of every block that takes the CP rank pipeline on the
unfolded matmul SHT (Legendre analysis, CP scale, Legendre synthesis)
through the K4 kernel; other blocks compute their stages as they would
without it. It is a keyword of the port's model, not a config field,
because ``SFNOConfig`` mirrors the JAX package's config field for field; it
is off by default, so a config computes the JAX package's three separate
stages unless asked.

Spatial model parallelism (``SFNO.set_mesh``): with a process mesh attached
(``parallel/mesh.py``) each rank runs the network on its block of the grid,
latitudes over "h" and longitudes over "w" (ranks that differ only in
"data" or "matmul" hold their own rows or replicas), as JAX's
``jit``-with-shardings partitions the same program. Every filter runs
between ``distributed_sht`` and ``distributed_isht``
(``parallel/distributed_sht.py``), over every transform (the unfolded and
the folded Legendre stage, either longitude method, the planar FFT), on the
channel shard of "w":

- a filter linear in its input channels (the dense dhconv on K1 or in its
  XLA form, merged or not, with bf16 operands or spectral IO; the diagonal
  filter) forms its partial product from this rank's input-channel rows of
  the weight, sums it over "w" in float32 and scatters it over the output
  channels, then rounds where the one-device path rounds;
- a separable filter scales this rank's channels by their rows, with no
  sum;
- the spectral-space CP, Tucker and TT filters project this rank's rows of
  A (G1), sum the rank-space projection over "w", and expand to this
  rank's output channels (B's rows; TT: G2's);
- the rank pipeline projects in grid space with its 2R columns permuted so
  that each "w" shard holds whole re/im pairs (``pair_order``; R must
  divide by "w"), transforms them, scales them by its columns of C (CP) or
  mixes them by its rows of the per-l kernel with a reduce-scatter
  (Tucker), and expands with the rows permuted alike. With ``fused_rank``,
  K4 runs on the shard: the longitude-transformed rank channels of every
  latitude shard are gathered over "h", and K4 analyses all latitudes and
  synthesizes only this block's rows;
- spectral attention trades the channel shard for a shard of the orders m
  and runs its MLP there with the whole weights;
- under ``scale_factor`` the first block transforms from the image grid and
  returns on the model grid, the last the reverse.

The norms sum their statistics over the "h" and "w" groups; the position
embedding and a layer norm's affine are sliced to the block; the fused MLP,
``QuantizedDropout`` (quantized or at the exact rate) and the noised
conditionings draw the whole grid's bits and keep the block's
(``models/modules.py``). The parameters stay whole and replicated, so
attaching and detaching a mesh touches no weight, name or checkpoint.
Under "h" or "w" above 1 autograd raises: the trainer replicates its step
over "h" and "w", as JAX's does.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.contractions import (
    complex_einsum,
    contract,
    contract_dhconv_cp,
    contract_dhconv_stacked,
    contract_dhconv_tt,
    contract_dhconv_tucker,
    cp_spatial_expand,
    cp_spatial_project,
    cp_spectral_scale_stacked,
    pair_order,
    tucker_rank_kernel,
    tucker_spectral_mix_stacked,
)
from ..ops.fft import InverseRealFFT2, RealFFT2
from ..ops.fused_rank import fused_rank as fused_rank_kernel
from ..ops.matmul import as_dtype, emit
from ..ops.pallas_contractions import WeightImageCache
from ..ops.sht import InverseRealSHT, RealSHT
from ..parallel.distributed_sht import (
    all_reduce_w,
    channels_to_orders,
    distributed_dhconv,
    distributed_ilongitude,
    distributed_isht,
    distributed_longitude,
    distributed_sht,
    orders_to_channels,
    reduce_scatter_w,
)
from ..parallel.mesh import AXIS_H, AXIS_W, Mesh, gather, shard, spatial_block
from .modules import (
    Dense,
    DropPath,
    InstanceNorm2d,
    MLP2d,
    QuantizedDropout,
    SpatialLayerNorm,
    TimeEmbedMLP,
    get_activation,
)

__all__ = ["SFNOConfig", "SFNO", "FNOBlock", "SpectralConvS2", "SpectralAttentionS2",
           "K4_PAIRS"]

# field -> the values the port implements, where it implements fewer than
# the JAX package runs
_SUPPORTED = {
    "spectral_io_dtype": ("", "bfloat16", "float16"),
    "sht_matmul_dtype": ("float32", "bfloat16", "float16"),
}
# field -> its values, as the JAX package names them
_NAMES = {
    "spectral_transform": ("sht", "fft"),
    "filter_type": ("linear", "non-linear"),
    "normalization_layer": ("instance_norm", "layer_norm", "none"),
    "activation_function": ("gelu", "gelu_exact", "relu", "silu", "tanh"),
}
_FACTORIZATIONS = (None, "", "cp", "tucker", "tt")
# the (sht_matmul_dtype, spectral_io_dtype) pairs that K4 has an instance for
K4_PAIRS = ((torch.float32, None), (torch.bfloat16, torch.bfloat16),
            (torch.float16, torch.float16))
_COMPLEX_ACTIVATIONS = ("real", "cartesian", "complex")


def _factor_shapes(factorization: str, ci: int, co: int, lmax: int, R: int) -> dict:
    """The factors of a factorization by their short names, with shapes."""
    cp = {"A": (ci, R, 2), "B": (co, R, 2), "C": (lmax, R, 2)}
    return {"cp": cp, "tucker": dict(cp, core=(R, R, R, 2)),
            "tt": {"G1": (ci, R, 2), "G2": (R, co, R, 2), "G3": (R, lmax, 2)}}[factorization]


@dataclasses.dataclass(frozen=True)
class SFNOConfig:
    """Static configuration, with the JAX package's field names and
    defaults. Every value that the JAX package runs is accepted, with the
    exceptions listed in the module docstring; ``checkpointing >= 3``
    remats every block (lower values remat nothing)."""

    img_shape: Tuple[int, int] = (180, 360)
    in_chans: int = 35
    out_chans: int = 35
    embed_dim: int = 256
    num_layers: int = 8
    scale_factor: int = 1
    spectral_transform: str = "sht"  # "sht" | "fft"
    filter_type: str = "linear"  # "linear" | "non-linear"
    operator_type: str = "dhconv"  # "dhconv" | "diagonal" | "l-dependant" (non-linear)
    separable: bool = False
    mlp_ratio: float = 2.0
    use_mlp: bool = True
    activation_function: str = "gelu"
    encoder_layers: int = 1
    pos_embed: bool = True
    big_skip: bool = True
    normalization_layer: str = "instance_norm"  # "instance_norm" | "layer_norm" | "none"
    exact_norm: bool = False
    exact_dropout: bool = False
    hard_thresholding_fraction: float = 1.0
    fused_mlp: bool = False
    # the row tile of the JAX package's Pallas MLP; the CUDA kernels (K2, K3)
    # tile by their own rule, so any positive value gives the same result
    fused_mlp_tile_rows: int = 1024
    fused_tail: bool = False
    scan_layers: bool = False
    dropout_mlp: float = 0.0
    dropout_filter: float = 0.0
    pos_emb_dropout: float = 0.0
    drop_path_rate: float = 0.0
    checkpointing: int = 0  # >= 3: remat every block
    data_grid: str = "equiangular"
    with_time_emb: bool = False
    time_dim_mult: int = 2
    time_rescale: bool = False
    time_scale_shift_before_filter: bool = True
    min_time: float = 0.0
    max_time: float = 1000.0
    factorization: Optional[str] = None  # None | "cp" | "tucker" | "tt"
    rank: float = 1.0
    rank_pipeline: bool = True
    spectral_layers: int = 3
    complex_activation: str = "real"  # "real" | "cartesian" | "complex"
    compute_dtype: str = "float32"  # "float32" | "bfloat16" | "float16"
    sht_matmul_dtype: str = "float32"
    spectral_io_dtype: str = ""
    lon_method: str = "matmul"  # "matmul" | "fft"
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
        for name, values in _NAMES.items():
            if getattr(self, name) not in values:
                raise ValueError(f"SFNOConfig.{name}={getattr(self, name)!r}: one of {values}")
        if self.compute_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if not (isinstance(self.fused_mlp_tile_rows, int) and self.fused_mlp_tile_rows > 0):
            raise ValueError(f"fused_mlp_tile_rows {self.fused_mlp_tile_rows!r}: a positive int")
        if self.filter_type == "linear":
            if self.operator_type not in ("dhconv", "diagonal"):
                raise ValueError(f"Unsupported operator_type {self.operator_type!r}")
            if self.factorization not in _FACTORIZATIONS:
                raise ValueError(f"Unknown factorization {self.factorization!r}")
            if self.factorization and self.operator_type != "dhconv":
                raise NotImplementedError("factorizations implemented for dhconv")
        else:
            if self.operator_type not in ("dhconv", "diagonal", "l-dependant"):
                raise ValueError(
                    f"Unknown non-linear operator type {self.operator_type!r}")
            if self.complex_activation not in _COMPLEX_ACTIVATIONS:
                raise ValueError(f"Unknown complex activation {self.complex_activation!r}")

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


def _build_transforms(cfg: SFNOConfig, kernel_layout: bool = False):
    """``(trans_down, itrans_up, trans, itrans)``: the data-grid transforms
    of the first and last block and the model-grid (legendre-gauss)
    transforms of the others, as the JAX package's ``_build_transforms``;
    K4's ``(m, h, l)`` matrices are made with ``kernel_layout``."""
    lmax, mmax = cfg.modes
    H, W = cfg.img_shape
    h, w = cfg.model_shape
    if cfg.spectral_transform == "fft":
        return (RealFFT2(H, W, lmax, mmax), InverseRealFFT2(H, W, lmax, mmax),
                RealFFT2(h, w, lmax, mmax), InverseRealFFT2(h, w, lmax, mmax))
    kw = dict(matmul_dtype=cfg.sht_matmul_dtype, kernel_layout=kernel_layout,
              lon_method=cfg.lon_method, fold_symmetry=cfg.sht_fold_symmetry)
    return (RealSHT(H, W, lmax, mmax, grid=cfg.data_grid, **kw),
            InverseRealSHT(H, W, lmax, mmax, grid=cfg.data_grid, **kw),
            RealSHT(h, w, lmax, mmax, grid="legendre-gauss", **kw),
            InverseRealSHT(h, w, lmax, mmax, grid="legendre-gauss", **kw))


class SpectralConvS2(nn.Module):
    """The linear filter: transform -> spectral weight -> inverse transform
    (+ bias). Returns ``(filtered, residual)``; the residual is the input
    regridded through the inverse of the forward transform when the two
    transforms' grids differ, else the input.

    The weight (flax name ``weight``) is dense, ``(ci[, co], lmax[, mmax],
    2)`` (co dropped when ``separable``, mmax added for "diagonal"), or with
    ``factorization`` the flax-named factors ``{cp,tucker,tt}_*`` with
    ``R = max(1, int(rank * min(ci, co)))``: CP ``A (ci, R, 2)``,
    ``B (co, R, 2)``, ``C (lmax, R, 2)``; Tucker the same and
    ``core (R, R, R, 2)``; TT ``G1 (ci, R, 2)``, ``G2 (R, co, R, 2)``,
    ``G3 (R, lmax, 2)``. A CP or Tucker dhconv filter that is not separable,
    whose two SHTs share a grid, with ``2R <= min(ci, co)``, runs the rank
    pipeline: project to rank in grid space, transform 2R channels, scale
    (CP) or mix (Tucker) per l, inverse-transform, expand in grid space;
    every other factorized filter contracts in spectral space.

    The dense dhconv filter that is not separable, between two SHTs and off
    K1, takes the JAX package's stacked path when ``merged_dhconv`` or a
    spectral-IO dtype is set (the merged product with ``merged_dhconv``):
    only there, and in the rank pipeline, does ``io_dtype`` round the
    spectral stages. ``fused_rank`` runs the CP rank pipeline's spectral
    middle as the K4 kernel (unfolded matmul SHTs only).

    With a mesh (``_mesh``) the input is this rank's block and the filter
    runs over it (``_distributed``, the routes of the module docstring),
    whatever its transforms.
    """

    _mesh: Optional[Mesh] = None

    def __init__(self, forward_transform, inverse_transform,
                 in_channels: int, out_channels: int, use_pallas: bool = False,
                 operator_type: str = "dhconv", separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0,
                 rank_pipeline: bool = False, matmul_dtype: str = "float32",
                 io_dtype: str = "", fused_rank: bool = False,
                 merged_dhconv: bool = False):
        super().__init__()
        # held outside the module tree: the SFNO owns the shared transforms
        self._transforms = (forward_transform, inverse_transform)
        self.use_pallas = use_pallas
        self.operator_type = operator_type
        self.separable = separable
        self.factorization = factorization or ""
        self.matmul_dtype = as_dtype(matmul_dtype)
        fwd, inv = forward_transform, inverse_transform
        lmax = fwd.lmax
        R = max(1, int(rank * min(in_channels, out_channels)))
        if self.factorization:
            shapes = _factor_shapes(self.factorization, in_channels, out_channels, lmax, R)
            self._factor_keys = tuple(shapes)
            for k, shape in shapes.items():
                self.register_parameter(f"{self.factorization}_{k}",
                                        nn.Parameter(torch.empty(shape)))
        else:
            shape = (in_channels,) + (() if separable else (out_channels,)) + (lmax,) + \
                ((fwd.mmax,) if operator_type == "diagonal" else ()) + (2,)
            self.weight = nn.Parameter(torch.empty(shape))
        # K1's weight images, made on the card once per weight version (not
        # saved): the forward's, and the backward's conjugate transpose
        k1 = use_pallas and not self.factorization and operator_type == "dhconv" \
            and not separable
        self._k1_image = WeightImageCache() if k1 else None
        self._k1_image_t = WeightImageCache(conj_t=True) if k1 else None
        self._k1_shard_image: Optional[WeightImageCache] = None  # of the weight's rows
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale_residual = (fwd.nlat, fwd.nlon, fwd.grid) != (inv.nlat, inv.nlon, inv.grid)
        shts = isinstance(fwd, RealSHT) and isinstance(inv, InverseRealSHT)
        # the JAX package's gates (models/sfno.py:323-334 and 358-366),
        # condition for condition
        self.rank_pipeline = (
            rank_pipeline
            and self.factorization in ("cp", "tucker")
            and operator_type == "dhconv"
            and not separable
            and not self.scale_residual
            and shts
            and 2 * R <= min(in_channels, out_channels)
        )
        stackable = (not self.factorization and operator_type == "dhconv" and not separable
                     and not use_pallas and shts)
        stacked = stackable and (merged_dhconv or bool(io_dtype))
        self.merged = stacked and merged_dhconv
        self.io_dtype = as_dtype(io_dtype) if (self.rank_pipeline or stacked) else None
        self.fused_rank = (fused_rank and self.rank_pipeline and self.factorization == "cp"
                           and not (fwd.folded or inv.folded or fwd.lon_fft or inv.lon_fft))
        if self.fused_rank and (self.matmul_dtype, self.io_dtype) not in K4_PAIRS:
            raise NotImplementedError(
                "fused_rank: K4 rounds like sht_matmul_dtype = spectral_io_dtype = bfloat16 "
                "or float16, or computes in float32 throughout; other mixes are not "
                "implemented")
        if self.fused_rank:  # where K4 may start: A[m] and S[m] are zero before it
            self.register_buffer("rank_l_first", torch.minimum(fwd.analysis_l_first,
                                                               inv.synthesis_l_first),
                                 persistent=False)

    def _contract(self, xs: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None,
                  image: Optional[torch.Tensor] = None, reduce=None) -> torch.Tensor:
        """The spectral contraction of ``xs`` with the dense weight or the
        factors ``w``; ``reduce`` sums a factorized filter's rank-space
        projection over the ranks (``ops/contractions.py``)."""
        md = self.matmul_dtype
        if self.merged:
            return contract_dhconv_stacked(xs, w, md, out_dtype=out_dtype)
        if self.factorization == "cp":
            return contract_dhconv_cp(xs, w, md, reduce=reduce)
        if self.factorization == "tucker":
            return contract_dhconv_tucker(xs, w, reduce=reduce)
        if self.factorization == "tt":
            return contract_dhconv_tt(xs, w, reduce=reduce)
        return contract(xs, w, self.use_pallas, md, out_dtype=out_dtype, image=image,
                        image_t=self._k1_image_t, operator_type=self.operator_type,
                        separable=self.separable)

    def _distributed(self, x: torch.Tensor):
        """The forward on this rank's block: ``distributed_sht``, the
        spectral weight on the channel shard (``_sharded_contract``),
        ``distributed_isht``; the residual regridded likewise; the rank
        pipeline over the mesh."""
        fwd, inv = self._transforms
        mesh, io, dtype = self._mesh, self.io_dtype, x.dtype
        residual = x
        if self.rank_pipeline:
            return (self._rank_pipeline(x, mesh) + self.bias).to(dtype), residual
        xs = distributed_sht(x.float(), fwd, mesh, out_dtype=io)
        if self.scale_residual:
            residual = distributed_isht(xs, inv, mesh).to(dtype)
        ys = self._sharded_contract(xs, mesh)
        out = distributed_isht(ys, inv, mesh, out_dtype=io) + self.bias
        return out.to(dtype), residual

    def _sharded_contract(self, xs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """The spectral weight on this rank's channel shard ``(B, L, M,
        CI/nw, 2)`` -> its output channel shard ``(B, L, M, CO/nw, 2)``."""
        io = self.io_dtype
        if self.factorization:  # the rank-space projection summed over "w"
            f = self._factors()
            first, last, dim = ("G1", "G2", 1) if self.factorization == "tt" else ("A", "B", 0)
            f.update({first: shard(mesh, f[first], (AXIS_W,)),
                      last: shard(mesh, f[last], (None,) * dim + (AXIS_W,))})
            return self._contract(xs, f, reduce=lambda t: all_reduce_w(t, mesh))
        w = shard(mesh, self.weight, (AXIS_W,))
        if self.separable:  # channel by channel: this rank's rows, no sum
            return self._contract(xs, w, io)
        if self._k1_image is None:
            return emit(reduce_scatter_w(self._contract(xs, w), mesh), io)
        image = None
        if w.is_cuda:  # the whole weight's image where "w" is 1, else its rows'
            if mesh.shape[AXIS_W] == 1:
                image = self._k1_image(w)
            else:
                if self._k1_shard_image is None:
                    self._k1_shard_image = WeightImageCache()
                image = self._k1_shard_image(w)
        return emit(distributed_dhconv(xs, w, mesh, image=image), io)

    def _factors(self) -> dict:
        """The factorization's factors by their short names ("A", "core",
        "G1", ...)."""
        return {k: getattr(self, f"{self.factorization}_{k}") for k in self._factor_keys}

    def _rank_pipeline(self, x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """Project, transform 2R channels, scale (CP; K4 with
        ``fused_rank``) or mix (Tucker), inverse-transform, expand. With a
        ``mesh``, on this rank's block: the 2R channels in ``pair_order``,
        this rank's columns of C or rows of the Tucker kernel."""
        fwd, inv = self._transforms
        md, io = self.matmul_dtype, self.io_dtype
        f = self._factors()
        C, order = f["C"], None
        if mesh is not None:
            if mesh.shape[AXIS_W] > 1:
                order = pair_order(C.shape[1], mesh.shape[AXIS_W])
            C = shard(mesh, C, (None, AXIS_W))
        z = cp_spatial_project(x.float(), f["A"], md, out_dtype=io, order=order)
        if self.fused_rank:
            S_t = inv.synthesis_mhl
            if mesh is None:
                xf = fwd.longitude(z, out_dtype=io)
            else:  # every latitude analysed, this block's synthesized
                xf = gather(mesh, distributed_longitude(z, fwd, mesh, io), (None, AXIS_H))
                S_t = S_t[:, spatial_block(mesh, x.shape[-3:-1]).rows()].contiguous()
            y = fused_rank_kernel(xf.contiguous(), fwd.analysis_mhl, S_t,
                                  C.float().contiguous(), self.rank_l_first)
            g = inv.longitude(y, out_dtype=io) if mesh is None else \
                distributed_ilongitude(y, inv, mesh, io)
        else:
            zs = fwd(z, out_dtype=io) if mesh is None else \
                distributed_sht(z, fwd, mesh, out_dtype=io)
            if self.factorization == "cp":
                t = cp_spectral_scale_stacked(zs, C)
            else:
                K, reduce = tucker_rank_kernel(f["core"], f["C"]), None
                if mesh is not None:  # this shard's p, q summed over "w" and scattered
                    K = shard(mesh, K, (None, AXIS_W))
                    reduce = lambda q: reduce_scatter_w(q, mesh)  # noqa: E731
                t = tucker_spectral_mix_stacked(zs, K, md, out_dtype=io, reduce=reduce)
            g = inv(t, out_dtype=io) if mesh is None else \
                distributed_isht(t, inv, mesh, out_dtype=io)
        return cp_spatial_expand(g, f["B"], md, out_dtype=io, order=order)

    def forward(self, x: torch.Tensor):
        if self._mesh is not None:
            return self._distributed(x)
        fwd, inv = self._transforms
        dtype = x.dtype
        residual = x
        if self.rank_pipeline:
            return (self._rank_pipeline(x) + self.bias).to(dtype), residual
        io = self.io_dtype
        xs = fwd(x.float(), out_dtype=io)
        if self.scale_residual:
            residual = inv(xs).to(dtype)
        if self.factorization:
            ys = self._contract(xs, self._factors())
        else:
            image = self._k1_image(self.weight) \
                if self._k1_image is not None and self.weight.is_cuda else None
            ys = self._contract(xs, self.weight, io, image=image)
        out = inv(ys, out_dtype=io) + self.bias
        return out.to(dtype), residual


class SpectralAttentionS2(nn.Module):
    """The non-linear filter: a complex MLP per spectral mode (transform ->
    ``spectral_layers`` complex layers with bias and complex activation ->
    complex output layer -> inverse transform), no bias after it. Returns
    ``(filtered, residual)`` as ``SpectralConvS2``.

    ``operator_type="l-dependant"`` gives every degree l its own weights (a
    leading lmax axis); any other shares one MLP across the modes. The
    parameters keep the flax names: ``w{i}_re``/``_im`` ``([lmax,] in,
    out)``, ``b{i}_re``/``_im`` ``(out,)`` and ``wout_re``/``_im``, with
    ``hidden = int(embed_dim * hidden_size_factor)``. The complex
    activations: "real" applies relu to the real part, "cartesian" to both
    parts, "complex" the erf gelu to both. Computes in float32.

    With a mesh (``_mesh``) the input is this rank's block: the spectral
    block's channel shard is traded over "w" for a shard of the orders m
    (``channels_to_orders``), the MLP runs there on every channel with the
    whole weights, and the output is traded back for ``distributed_isht``."""

    _mesh: Optional[Mesh] = None

    def __init__(self, forward_transform, inverse_transform, embed_dim: int,
                 hidden_size_factor: float = 2.0, spectral_layers: int = 3,
                 complex_activation: str = "real", operator_type: str = "diagonal"):
        super().__init__()
        self._transforms = (forward_transform, inverse_transform)
        self.complex_activation = complex_activation
        self.spectral_layers = spectral_layers
        self.l_dependant = operator_type == "l-dependant"
        fwd, inv = forward_transform, inverse_transform
        self.scale_residual = (fwd.nlat, fwd.nlon, fwd.grid) != (inv.nlat, inv.nlon, inv.grid)
        hidden = int(embed_dim * hidden_size_factor)
        dims = [embed_dim] + [hidden] * spectral_layers
        lead = (fwd.lmax,) if self.l_dependant else ()
        for i in range(spectral_layers):
            for part in ("re", "im"):
                self.register_parameter(f"w{i}_{part}", nn.Parameter(
                    torch.empty(lead + (dims[i], dims[i + 1]))))
            for part in ("re", "im"):
                self.register_parameter(f"b{i}_{part}", nn.Parameter(torch.zeros(dims[i + 1])))
        for part in ("re", "im"):
            self.register_parameter(f"wout_{part}", nn.Parameter(
                torch.empty(lead + (dims[-1], embed_dim))))

    def _act(self, zr: torch.Tensor, zi: torch.Tensor):
        if self.complex_activation == "real":
            return torch.relu(zr), zi
        if self.complex_activation == "cartesian":
            return torch.relu(zr), torch.relu(zi)
        return torch.nn.functional.gelu(zr), torch.nn.functional.gelu(zi)

    def _mlp(self, xs: torch.Tensor) -> torch.Tensor:
        """The complex MLP on every mode of ``xs`` ``(..., l, m, c, 2)``."""
        eq = "...lmi,lio->...lmo" if self.l_dependant else "...lmi,io->...lmo"
        zr, zi = xs[..., 0].float(), xs[..., 1].float()
        for i in range(self.spectral_layers):
            zr, zi = complex_einsum(eq, zr, zi, getattr(self, f"w{i}_re"),
                                    getattr(self, f"w{i}_im"))
            zr, zi = self._act(zr + getattr(self, f"b{i}_re"), zi + getattr(self, f"b{i}_im"))
        zr, zi = complex_einsum(eq, zr, zi, self.wout_re, self.wout_im)
        return torch.stack([zr, zi], dim=-1)

    def forward(self, x: torch.Tensor):
        fwd, inv = self._transforms
        dtype = x.dtype
        residual = x
        mesh = self._mesh
        if mesh is None:  # the one-device transforms, only here
            xs = fwd(x.float())
            if self.scale_residual:
                residual = inv(xs).to(dtype)
            return inv(self._mlp(xs)).to(dtype), residual
        xs = distributed_sht(x.float(), fwd, mesh)
        if self.scale_residual:
            residual = distributed_isht(xs, inv, mesh).to(dtype)
        ys = orders_to_channels(self._mlp(channels_to_orders(xs, mesh)), mesh, xs.shape[-3])
        return distributed_isht(ys.contiguous(), inv, mesh).to(dtype), residual


class FNOBlock(nn.Module):
    """norm0 -> (time scale-shift) -> spectral filter -> + inner skip ->
    (act, for the linear filter) -> norm1 -> MLP -> (drop path) -> + outer
    skip. A layer norm takes the block's input grid for norm0 and its output
    grid for norm1 (they differ in the first and last block under
    ``scale_factor`` 2)."""

    def __init__(self, cfg: SFNOConfig, forward_transform, inverse_transform,
                 drop_path: float = 0.0, fused_rank: bool = False,
                 input_shape: Optional[Tuple[int, int]] = None,
                 output_shape: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        compute = cfg.torch_compute_dtype
        self.drop_path_rate = drop_path
        self.norm0 = self._norm(input_shape or cfg.model_shape)
        self.norm1 = self._norm(output_shape or cfg.model_shape)
        if cfg.with_time_emb:
            self.time_mlp = Dense(C * cfg.time_dim_mult, 2 * C)
        if cfg.filter_type == "linear":
            self.filter = SpectralConvS2(
                forward_transform, inverse_transform, C, C, use_pallas=cfg.use_pallas,
                operator_type=cfg.operator_type, separable=cfg.separable,
                factorization=cfg.factorization, rank=cfg.rank,
                rank_pipeline=cfg.rank_pipeline, matmul_dtype=cfg.sht_matmul_dtype,
                io_dtype=cfg.spectral_io_dtype, fused_rank=fused_rank,
                merged_dhconv=cfg.merged_dhconv)
        else:
            # the linear operator names both select the shared MLP
            self.filter = SpectralAttentionS2(
                forward_transform, inverse_transform, C, hidden_size_factor=cfg.mlp_ratio,
                spectral_layers=cfg.spectral_layers,
                complex_activation=cfg.complex_activation,
                operator_type="l-dependant" if cfg.operator_type == "l-dependant"
                else "diagonal")
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

    def _norm(self, shape: Tuple[int, int]) -> nn.Module:
        cfg = self.cfg
        if cfg.normalization_layer == "instance_norm":
            return InstanceNorm2d(cfg.embed_dim, exact=cfg.exact_norm)
        if cfg.normalization_layer == "layer_norm":
            return SpatialLayerNorm(shape, exact=cfg.exact_norm)
        return nn.Identity()

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
        x = x_f + self.inner_skip(residual)
        if cfg.filter_type == "linear":
            x = get_activation(cfg.activation_function)(x)
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


def _checkpointed(block: FNOBlock, x: torch.Tensor, time_emb: Optional[torch.Tensor],
                  deterministic: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, time_emb, deterministic, generator)`` under a
    non-reentrant ``torch.utils.checkpoint``. The forward draws from
    ``generator`` itself; the recompute in the backward draws from a copy
    restored to the state the forward started from, so it makes the same
    dropout and DropPath masks and leaves ``generator`` where the forward
    left it."""
    state = generator.get_state() if generator is not None else None
    calls = []

    def run(x, time_emb):
        gen = generator
        if calls and state is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        calls.append(None)
        return block(x, time_emb, deterministic, gen)

    return checkpoint(run, x, time_emb, use_reentrant=False)


class SFNO(nn.Module):
    """The SFNO backbone: ``(inputs, time, condition, static_condition) ->
    outputs``, all (B, H, W, C), output float32."""

    _mesh: Optional[Mesh] = None

    def __init__(self, cfg: SFNOConfig, fused_rank: bool = False):
        super().__init__()
        cfg = cfg.resolved()
        self.cfg = cfg
        self.fused_rank = fused_rank
        compute = cfg.torch_compute_dtype
        C = cfg.embed_dim
        H, W = cfg.img_shape
        h, w = cfg.model_shape
        # the JAX package's _build_transforms; K4's (m, h, l) matrices are
        # made here once, in the matmul dtype
        self.trans_down, self.itrans_up, self.trans, self.itrans = _build_transforms(
            cfg, kernel_layout=fused_rank)

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
                             fused_rank=fused_rank,
                             input_shape=(H, W) if first else (h, w),
                             output_shape=(H, W) if last else (h, w))
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        width = C + (cfg.in_chans if cfg.big_skip else 0)
        for i in range(cfg.encoder_layers):
            self.add_module(f"decoder_{i}", Dense(width, C, dtype=compute))
            width = C
        self.decoder_out = Dense(width, cfg.out_chans, use_bias=False, dtype=compute)

    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Attach a process mesh (``parallel/mesh.py``; None detaches it):
        from then on ``forward`` takes this rank's block of the grid,
        latitudes over "h" and longitudes over "w", and returns its block of
        the output. Parameters, their names and shapes are left as they are.
        Every option has a route. A grid (the image grid's and the model
        grid's latitudes, which the folded Legendre stage pairs across the
        ranks of "h", and longitudes), width or rank-pipeline rank that does
        not split raises ``ValueError``; with "h" and "w" at 1 the block is
        the whole grid, its collectives over groups of one."""
        if mesh is not None and mesh.spatial:
            cfg = self.cfg
            nh, nw = mesh.shape[AXIS_H], mesh.shape[AXIS_W]
            for H, W in dict.fromkeys((cfg.img_shape, cfg.model_shape)):
                if H % nh or W % nw or cfg.embed_dim % nw:
                    raise ValueError(
                        f"SFNO on the mesh {mesh.shape}: {H} latitudes, {W} longitudes and "
                        f"{cfg.embed_dim} channels must split over h={nh}, w={nw}")
            for block in self.blocks:
                f = block.filter
                R = f._factors()["C"].shape[1] if getattr(f, "rank_pipeline", False) else 0
                if R % nw:
                    raise ValueError(f"SFNO on the mesh {mesh.shape}: the rank pipeline's "
                                     f"rank {R} must split over w={nw}")
        for m in self.modules():
            if hasattr(type(m), "_mesh"):
                m._mesh = mesh

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (on the parameters' device),
        with the JAX package's initializers: truncated normal(0.02) for
        Dense kernels and the position embedding; normal(1/(ci*co)) for the
        dense spectral weight of every shape (separable and diagonal
        included, ci = co = embed_dim); normal((1/(ci*co))**(1/3)) for the
        CP, Tucker and TT factors; normal(1/sqrt(embed_dim * hidden)) for
        the spectral-attention weights and zeros for their biases; ones for
        norm scales, zeros for biases."""
        C = self.cfg.embed_dim
        factor_std = (1.0 / (C * C)) ** (1.0 / 3.0)
        attention_std = 1.0 / math.sqrt(C * int(C * self.cfg.mlp_ratio))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel" or leaf == "pos_embed":
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif name.endswith("filter.weight"):
                p.normal_(0.0, 1.0 / (C * C), generator=generator)
            elif leaf.split("_", 1)[0] in ("cp", "tucker", "tt"):
                p.normal_(0.0, factor_std, generator=generator)
            elif re.fullmatch(r"w(\d+|out)_(re|im)", leaf):
                p.normal_(0.0, attention_std, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias" or re.fullmatch(r"b\d+_(re|im)", leaf):
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
        mesh = self._mesh
        if mesh is not None and mesh.spatial and torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise NotImplementedError(
                "SFNO on a split grid computes forwards only (the trainer replicates its step "
                "over 'h' and 'w'); run it under torch.no_grad() or inference")
        conds = [c for c in (condition, static_condition) if c is not None]
        x = torch.cat([inputs] + conds, dim=-1) if conds else inputs
        x = x.to(compute)
        big_skip = x
        for i in range(cfg.encoder_layers):
            x = act(getattr(self, f"encoder_{i}")(x))
        x = self.encoder_out(x)
        if cfg.pos_embed:
            pos = self.pos_embed
            if mesh is not None:
                blk = spatial_block(mesh, x.shape[-3:-1])
                pos = pos[:, blk.rows(), blk.cols()]
            x = x + pos
            x = self.pos_drop(x, deterministic, generator)
        t_repr = None
        if cfg.with_time_emb:
            if time is None:
                raise ValueError("cfg.with_time_emb=True but no time passed")
            t = time.float()
            if cfg.time_rescale:
                t = (t - cfg.min_time) * (1000.0 / (cfg.max_time - cfg.min_time))
            t_repr = self.time_emb(t)
        remat = cfg.checkpointing >= 3 and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = _checkpointed(block, x, t_repr, deterministic, generator)
            else:
                x = block(x, t_repr, deterministic, generator)
        if cfg.big_skip:
            dtype = torch.promote_types(x.dtype, big_skip.dtype)
            x = torch.cat([x.to(dtype), big_skip.to(dtype)], dim=-1)
        for i in range(cfg.encoder_layers):
            x = act(getattr(self, f"decoder_{i}")(x))
        return self.decoder_out(x).float()
