"""Spherical harmonic transforms and the dhconv contraction over a process mesh.

Counterpart of ``spherical_dyffusion_tpu/parallel/distributed_sht.py``.
JAX writes each as a ``shard_map`` body over the local block with ``lax``
collectives; here each rank runs the body on its own block and makes the
collectives over the mesh's process groups:

* the grid is sharded (latitudes over "h", longitudes over "w");
* the longitude transform needs every longitude, so ``all_to_all_single``
  over "w" trades the longitude shard for a channel shard;
* the Legendre contraction sums over latitudes, so each rank contracts its
  rows with its rows of the analysis matrix and ``all_reduce`` over "h"
  sums them (l stays whole for the per-l spectral weights);
* the spectral block comes out whole in (l, m) with the channels sharded
  over "w", the layout that the channel-sharded ``distributed_dhconv``
  takes.

The inverse runs the adjoint. Spectral tensors use the port's stacked real
layout ``(B, L, M, C, 2)`` (``ops/sht.py``), contiguous, the layout K1
reads; the longitude stage is the transform's own (its DFT matrix or FFT),
and ``out_dtype`` rounds each stage's output where the transform's own
``out_dtype`` does (after the latitude sum over "h"). The latitude stage is
the transform's too:

* the unfolded Legendre matrix: this rank's rows of it, as above;
* the folded Legendre stage (``sht_fold_symmetry``): latitude r pairs with
  H-1-r, so rank i of "h" pairs its rows with those of rank nh-1-i. The
  two ranks of a pair split its latitude pairs in half (``mirror_pairs``):
  each sends the other the rows of the pairs the other owns, in the matmul
  dtype (the rounding point of JAX's e and o), in one ``all_to_all_single``
  over "h" whose split sizes are zero but for the mirror's chunk. A rank
  that pairs with itself (the equator's block when nh is odd) sends and
  receives nothing in that call, and where "h" is 1 no call is made. Each
  rank forms e and o of the pairs it owns, takes the two half-size
  products (``RealSHT.folded_pairs``, restacked into l) and the partial
  (l, m) sums go to the ``all_reduce`` over "h". Per forward that moves B x
  H/(2 nh) x M x C/nw x 2 values of the matmul dtype each way between the
  two ranks of a pair, besides the all-reduce's B x L x M x C/nw x 2
  float32. The folded synthesis needs no exchange: each rank forms E and
  O at the mirror-north rows of its own rows (``InverseRealSHT.
  folded_rows``);
* the planar FFT (``spectral_transform="fft"``): after the longitude FFT,
  this rank's channel shard ``(B, H/nh, M, C/nw, 2)`` float32 is gathered
  over "h" in rank order (``parallel/mesh.py:gather``; B x H x M x C/nw x
  2 float32 a rank, never the whole grid's channels) and the FFT over H
  keeps its rows, giving the same layout as the SHTs. The inverse runs the
  latitude inverse FFT on the whole spectrum of its channel shard, keeps
  its H/nh rows and runs the longitude stage: no collective over "h".

The contraction is K1's wrapper
(``ops/pallas_contractions.py:dhconv``): the kernel on the card, its plain
version on the CPU. A collective runs over an axis wherever the mesh has a
group for it, so on a world of one (an NCCL group of one rank) each runs
with one rank; without a process group the functions are the single-device
transforms. Latitudes, longitudes and channels must divide by their axis
sizes.

The filters share three more collectives over "w":

* ``reduce_scatter_w``: the sum of a filter that is linear in its input
  channels. Each rank forms its partial product from its input-channel
  rows of the weight; the partials are summed in float32 and scattered over
  the output channels (``distributed_dhconv`` on K1; the dense, merged and
  diagonal filters off it; Tucker's per-l rank mix);
* ``all_reduce_w``: the sum of a rank-space projection (the spectral-space
  CP, Tucker and TT filters), after which each rank expands to its own
  output channels;
* ``channels_to_orders`` and back: the channel shard traded for a shard of
  the orders m (padded to a multiple of "w"), for a filter that acts per
  mode across all channels (spectral attention).

``distributed_longitude`` and ``distributed_ilongitude`` are the
transforms' longitude stages with the all-to-alls around them, so that K4
can run between them (the model gathers the longitude-transformed rank
channels of every latitude shard over "h" for it, ``parallel/mesh.py:
gather``: this rank's channel shard only). None of these gathers the whole
grid onto one rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.fft import InverseRealFFT2, RealFFT2
from ..ops.matmul import einsum, emit
from ..ops.pallas_contractions import dhconv
from ..ops.sht import InverseRealSHT, RealSHT
from .mesh import AXIS_H, AXIS_W, Mesh, gather

__all__ = ["distributed_sht", "distributed_isht", "distributed_dhconv", "distributed_longitude",
           "distributed_ilongitude", "reduce_scatter_w", "all_reduce_w",
           "channels_to_orders", "orders_to_channels", "mirror_pairs"]


def _all_to_all(x: torch.Tensor, group, n: int, split: int, concat: int) -> torch.Tensor:
    """``lax.all_to_all(..., split_axis=split, concat_axis=concat,
    tiled=True)`` over ``group`` of ``n`` ranks: ``split`` cut into n
    chunks, chunk j sent to rank j, the received chunks joined along
    ``concat`` in rank order."""
    parts = torch.stack(x.chunk(n, dim=split)).flatten(0, 1).contiguous()  # chunk j, rank j
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.chunk(n), dim=concat)


def _rows(mesh: Mesh, n_lat: int) -> slice:
    nh = mesh.shape[AXIS_H]
    if n_lat % nh:
        raise ValueError(f"{n_lat} latitudes do not split over {nh} 'h' ranks")
    k = n_lat // nh
    i = mesh.index(AXIS_H) if nh > 1 else 0
    return slice(i * k, (i + 1) * k)


def mirror_pairs(n_lat: int, nh: int, i: int):
    """The latitude pairs (r, n_lat-1-r) that rank ``i`` of ``nh`` "h"
    ranks owns in the folded analysis: ``(keep, send, north)``. The rank
    keeps its first ``keep`` rows and sends its last ``send`` rows to rank
    nh-1-i, whose last ``keep`` rows it receives; ``north`` (a slice of the
    rows r < n_lat/2) is the northern row of each pair it owns, in order.
    Of two mirror ranks the northern one owns the first ceil(k/2) pairs of
    its k rows and the southern one the rest; a rank that is its own mirror
    owns its k/2 pairs and sends nothing."""
    k = n_lat // nh
    j = nh - 1 - i
    if i == j:
        return k // 2, 0, slice(i * k, i * k + k // 2)
    k2 = (k + 1) // 2
    if i < j:
        return k2, k - k2, slice(i * k, i * k + k2)
    return k - k2, k2, slice(j * k + k2, (j + 1) * k)


def _folded_analysis(xf: torch.Tensor, sht: RealSHT, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the folded Legendre analysis of ``(B, H/nh, M,
    C/nw, 2)``: the mirror rows exchanged over "h", the pairs it owns
    contracted (the module docstring)."""
    nh, gh = mesh.shape[AXIS_H], mesh.groups[AXIS_H]
    i = mesh.index(AXIS_H) if nh > 1 else 0
    j = nh - 1 - i
    keep, send, north = mirror_pairs(sht.nlat, nh, i)
    xf = xf.to(sht.matmul_dtype)
    if nh > 1:  # one call of every rank of "h"; a rank that is its own mirror sends nothing
        out_splits, in_splits = [0] * nh, [0] * nh
        if i != j:
            out_splits[j], in_splits[j] = keep, send
        rows = xf[..., xf.shape[-4] - send:, :, :, :].movedim(-4, 0).contiguous()
        recv = xf.new_empty((out_splits[j],) + rows.shape[1:])
        dist.all_to_all_single(recv, rows, out_splits, in_splits, group=gh)
        theirs = recv.movedim(0, -4)
    mine = xf[..., :keep, :, :, :]
    if i == j:  # both rows of every pair: the mirrors are its other half, last-first
        return sht.folded_pairs(mine, xf[..., keep:, :, :, :].flip(-4), north)
    if i < j:  # northern: its rows on top, the mirrors received last-first
        return sht.folded_pairs(mine, theirs.flip(-4), north)
    return sht.folded_pairs(theirs, mine.flip(-4), north)


def distributed_longitude(x: torch.Tensor, sht: RealSHT | RealFFT2, mesh: Mesh,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The longitude stage of ``distributed_sht``: this rank's grid block
    ``(B, H/nh, W/nw, C)`` -> ``(B, H/nh, M, C/nw, 2)``, the longitude shard
    traded for a channel shard first."""
    nw = mesh.shape[AXIS_W]
    gw = mesh.groups[AXIS_W]
    if x.shape[-1] % nw:
        raise ValueError(f"{x.shape[-1]} channels do not split over {nw} 'w' ranks")
    if gw is not None:  # the longitude shard for a channel shard
        x = _all_to_all(x, gw, nw, split=3, concat=2)
    return sht.longitude(x, out_dtype)


def distributed_sht(x: torch.Tensor, sht: RealSHT | RealFFT2, mesh: Mesh,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's grid block ``(B, H/nh, W/nw, C)`` -> its spectral block
    ``(B, L, M, C/nw, 2)``: JAX's input ``P(None, 'h', 'w', None)`` and
    output ``P(None, None, None, 'w')``; ``out_dtype`` as ``sht``'s."""
    gh = mesh.groups[AXIS_H]
    rows = _rows(mesh, sht.nlat)
    xf = distributed_longitude(x, sht, mesh, out_dtype)  # (B, H/nh, M, C/nw, 2)
    if isinstance(sht, RealFFT2):  # every latitude of this channel shard, in rank order
        return sht.latitude(gather(mesh, xf, (None, AXIS_H)))
    if sht.folded:
        part = _folded_analysis(xf, sht, mesh)
    else:
        part = einsum("...hmcr,hlm->...lmcr", xf, sht.analysis[rows], sht.matmul_dtype)
    part = part.contiguous()
    if gh is not None:  # the latitude sum over the latitude shards
        dist.all_reduce(part, group=gh)
    return emit(part, out_dtype)


def distributed_ilongitude(y: torch.Tensor, isht: InverseRealSHT | InverseRealFFT2, mesh: Mesh,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The inverse longitude stage of ``distributed_isht``: ``(B, H/nh, M,
    C/nw, 2)`` -> this rank's grid block ``(B, H/nh, W/nw, C)``, the channel
    shard traded back for a longitude shard."""
    nw = mesh.shape[AXIS_W]
    gw = mesh.groups[AXIS_W]
    out = isht.longitude(y, out_dtype)  # (B, H/nh, W, C/nw)
    if gw is not None:  # the channel shard back to a longitude shard
        out = _all_to_all(out, gw, nw, split=2, concat=3)
    return out


def distributed_isht(xs: torch.Tensor, isht: InverseRealSHT | InverseRealFFT2, mesh: Mesh,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's spectral block ``(B, L, M, C/nw, 2)`` -> its grid block
    ``(B, H/nh, W/nw, C)``, the adjoint of ``distributed_sht``;
    ``out_dtype`` as ``isht``'s."""
    rows = _rows(mesh, isht.nlat)
    if isinstance(isht, InverseRealFFT2):  # the whole spectrum of the shard, this block's rows
        y = isht.latitude(xs)[..., rows, :, :, :]
    elif isht.folded:
        y = isht.folded_rows(xs, rows)
    else:
        y = einsum("...lmcr,hlm->...hmcr", xs, isht.synthesis[rows], isht.matmul_dtype)
        if isht._emits:
            y = emit(y, out_dtype)
    return distributed_ilongitude(y, isht, mesh, out_dtype)


def reduce_scatter_w(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over "w" of this rank's partial ``(..., CO, 2)`` (a product
    over its input-channel rows), in float32, scattered over the output
    channels: this rank keeps ``(..., CO/nw, 2)``, chunk ``index("w")``.
    Without a "w" group, the partial itself."""
    nw = mesh.shape[AXIS_W]
    gw = mesh.groups[AXIS_W]
    y = y.float()
    if gw is None:
        return y
    CO = y.shape[-2]
    if CO % nw:
        raise ValueError(f"{CO} output channels do not split over {nw} 'w' ranks")
    parts = torch.stack(y.chunk(nw, dim=-2))  # (nw, ..., CO/nw, 2)
    out = torch.empty_like(parts[0])
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1).contiguous(), group=gw)
    return out


def all_reduce_w(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's partial ``t`` summed over "w" in float32, in place where
    ``t`` is a contiguous float32 tensor (without a "w" group, ``t`` in
    float32)."""
    gw = mesh.groups[AXIS_W]
    t = t.float().contiguous()
    if gw is not None:
        dist.all_reduce(t, group=gw)
    return t


def _padded_orders(M: int, nw: int) -> int:
    return -(-M // nw) * nw


def channels_to_orders(xs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's channel shard of a spectral block ``(B, L, M, C/nw, 2)``
    traded over "w" for a shard of the orders: ``(B, L, Mp/nw, C, 2)``,
    chunk ``index("w")`` of the orders padded with zeros to ``Mp``, the
    multiple of "w" at or above M (a trade of equal chunks)."""
    nw = mesh.shape[AXIS_W]
    gw = mesh.groups[AXIS_W]
    if gw is None:
        return xs
    M = xs.shape[-3]
    pad = _padded_orders(M, nw) - M
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, 0, 0, pad))
    return _all_to_all(xs, gw, nw, split=-3, concat=-2)


def orders_to_channels(ys: torch.Tensor, mesh: Mesh, M: int) -> torch.Tensor:
    """The inverse of ``channels_to_orders``: ``(B, L, Mp/nw, C, 2)`` ->
    ``(B, L, M, C/nw, 2)``, the padded orders dropped."""
    nw = mesh.shape[AXIS_W]
    gw = mesh.groups[AXIS_W]
    if gw is None:
        return ys
    return _all_to_all(ys, gw, nw, split=-2, concat=-3)[..., :M, :, :]


def distributed_dhconv(xs: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                       scatter_output: bool = True,
                       image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The channel-sharded Driscoll-Healy contraction: this rank's spectral
    block ``(B, L, M, CI/nw, 2)`` and its rows of the weight ``(CI/nw, CO, L,
    2)`` give the partial ``(B, L, M, CO, 2)`` on K1 (``image``: those rows'
    K1 weight image, made once by the caller; the wrapper makes one where it
    is None), summed over "w". With ``scatter_output`` (JAX's default) the
    sum is a ``reduce_scatter`` over the output channels, leaving this rank
    ``(B, L, M, CO/nw, 2)``, the layout ``distributed_isht`` takes; else an
    ``all_reduce`` leaves every rank the whole output."""
    y = dhconv(xs.float().contiguous(), w.float(), image)
    if not scatter_output:
        return all_reduce_w(y, mesh)
    return reduce_scatter_w(y, mesh)
