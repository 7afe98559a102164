"""The process mesh: the world's ranks laid out as ``(data, h, w, matmul)``.

Counterpart of ``spherical_dyffusion_tpu/parallel/mesh.py``. A JAX mesh is
one program's view of its devices, and XLA inserts the collectives; here
each process is one rank of the layout and holds one block, and the mesh
gives it a process group per axis for the collectives it makes itself:

* ``data``: data parallelism (the trainer's gradient mean, the stepper's
  rows);
* ``h`` / ``w``: latitude and longitude shards (``distributed_sht``);
* ``matmul``: channel shards.

A group is made for every axis with more than one rank (the world's own
group where the axis spans the whole world, a world of one included), by
``dist.new_subgroups_by_enumeration`` otherwise, which every rank of the
world must call with the same layout. Without a process group a mesh is a
layout alone (no groups; this process is rank 0), which is how a one-process
run and the layout checks use it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "Block", "make_mesh", "data_mesh", "batch_sharding", "shard", "gather",
           "shard_batch", "gather_batch", "spatial_block", "all_reduce_spatial", "halo_exchange",
           "replicated",
           "AXIS_DATA", "AXIS_H", "AXIS_W", "AXIS_MATMUL", "AXES"]

AXIS_DATA = "data"
AXIS_H = "h"
AXIS_W = "w"
AXIS_MATMUL = "matmul"
AXES = (AXIS_DATA, AXIS_H, AXIS_W, AXIS_MATMUL)


@dataclasses.dataclass(eq=False)
class Mesh:
    """``ranks``: the global ranks as a ``(data, h, w, matmul)`` array;
    ``groups``: the process group of this rank's fiber along each axis
    (None where no collective is needed or there is no process group);
    ``rank``: this process's global rank."""

    ranks: np.ndarray
    groups: Dict[str, Any]
    rank: int = 0

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks.ravel().tolist()}")
        return int(where[0][AXES.index(axis)])

    @property
    def spatial(self) -> bool:
        """Whether the grid is split: "h" or "w" above 1."""
        return self.shape[AXIS_H] * self.shape[AXIS_W] > 1

    def fiber(self, axis: str) -> list:
        """The global ranks of this rank's fiber along ``axis``, in order."""
        at = list(np.argwhere(self.ranks == self.rank)[0])
        at[AXES.index(axis)] = slice(None)
        return [int(r) for r in self.ranks[tuple(at)]]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _build(blocks: np.ndarray) -> Mesh:
    """The mesh of this rank's block of ``blocks`` ``(R, data, h, w,
    matmul)``, with groups over the fibers of every block (collective over
    the world)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = next((b for b in blocks if (b == rank).any()), blocks[0])
    groups: Dict[str, Any] = {a: None for a in AXES}
    if dist.is_initialized():
        world = list(range(dist.get_world_size()))
        for i, axis in enumerate(AXES):
            fibers = np.moveaxis(blocks, i + 1, -1).reshape(-1, blocks.shape[i + 1])
            if len(fibers) == 1 and fibers[0].tolist() == world:
                groups[axis] = dist.group.WORLD
            elif fibers.shape[1] > 1:
                if any((np.diff(f) <= 0).any() for f in fibers):
                    raise ValueError(f"mesh ranks must increase along each axis ({axis})")
                groups[axis], _ = dist.new_subgroups_by_enumeration(fibers.tolist())
    return Mesh(ranks=mine, groups=groups, rank=rank)


def make_mesh(data: int = -1, h: int = 1, w: int = 1, matmul: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 4-axis mesh over ``ranks`` (every rank of the world, or the one
    process without a group); ``data=-1`` takes the ranks left over. The
    JAX package's errors: the rank count must divide by ``h * w * matmul``
    and equal ``data * h * w * matmul``."""
    ranks = list(ranks) if ranks is not None else list(range(_world()))
    n = len(ranks)
    model = h * w * matmul
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model size {model}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{h}x{w}x{matmul} != {n} devices")
    arr = np.asarray(ranks).reshape(data, h, w, matmul)
    return _build(arr[None])


def data_mesh(data: int) -> Mesh:
    """The trainer's default mesh: ``data`` ranks of pure data parallelism.
    JAX takes the first ``data`` devices and leaves the others idle; here the
    world splits into blocks of ``data`` consecutive ranks, each a mesh of
    its own that runs the same steps, so every rank holds the same state
    (``data`` must divide the world)."""
    world = _world()
    if world % data:
        raise ValueError(f"data size {data} does not divide the world of {world} ranks")
    return _build(np.arange(world).reshape(world // data, data, 1, 1, 1))


def batch_sharding(mesh: Mesh, ndim: int, spatial: bool = False) -> tuple:
    """The partition of a (B, ..., H, W, C) batch, as JAX's ``PartitionSpec``
    entries: B over "data" and, with ``spatial`` (and ``ndim >= 3``), the
    latitudes (dim -3) over "h" and the longitudes (dim -2) over "w"."""
    spec = [AXIS_DATA] + [None] * (ndim - 1)
    if spatial and ndim >= 3:
        spec[-3], spec[-2] = AXIS_H, AXIS_W
    return tuple(spec)


def shard(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (one mesh axis or None per
    dim): each named dim narrowed to this rank's part along its axis."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over the "
                             f"{n} ranks of mesh axis {axis!r}")
        k = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * k, k)
    return x


def gather(mesh: Mesh, x: Optional[torch.Tensor], spec: tuple) -> Optional[torch.Tensor]:
    """The inverse of ``shard``: this rank's block gathered over the groups
    of the axes that ``spec`` names, "w" first, then "h", then "data", into
    the global tensor on every rank of those groups."""
    if x is None:
        return x
    for axis in (AXIS_W, AXIS_H, AXIS_DATA):
        if axis not in spec or mesh.shape[axis] == 1 or mesh.groups[axis] is None:
            continue
        dim = spec.index(axis)
        n = mesh.shape[axis]
        part = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]), dtype=part.dtype,
                          device=part.device)
        dist.all_gather_into_tensor(out, part, group=mesh.groups[axis])
        x = out.movedim(0, dim)
    return x


def shard_batch(mesh: Mesh, batch, spatial: bool = False):
    """This rank's block of a batch (a tensor, or a dict or list of them;
    None passes) under ``batch_sharding``: its rows over "data" and, with
    ``spatial``, its latitudes and longitudes over "h" and "w". On a mesh of
    one rank the batch itself."""
    if batch is None or mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, spatial) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, spatial) for v in batch)
    return shard(mesh, batch, batch_sharding(mesh, batch.dim(), spatial))


def gather_batch(mesh: Mesh, x: Optional[torch.Tensor],
                 spatial: bool = False) -> Optional[torch.Tensor]:
    """The inverse of ``shard_batch``: this rank's block gathered over "w",
    then "h" (with ``spatial``), then "data" into the global batch."""
    if x is None or mesh.size == 1:
        return x
    return gather(mesh, x, batch_sharding(mesh, x.dim(), spatial))


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's block of a (..., H, W, C) grid: its origin ``(h0, w0)``,
    its ``local`` (Hl, Wl) and the ``shape`` (H, W) of the whole grid."""

    h0: int
    w0: int
    local: Tuple[int, int]
    shape: Tuple[int, int]

    @property
    def whole(self) -> bool:
        return self.local == self.shape

    def rows(self) -> slice:
        return slice(self.h0, self.h0 + self.local[0])

    def cols(self) -> slice:
        return slice(self.w0, self.w0 + self.local[1])


def spatial_block(mesh: Optional[Mesh], local: Tuple[int, int]) -> Block:
    """The block of this rank whose local grid is ``local`` (Hl, Wl): the
    latitudes split over "h" and the longitudes over "w" in rank order;
    without a mesh the whole grid."""
    Hl, Wl = int(local[0]), int(local[1])
    if mesh is None:
        return Block(0, 0, (Hl, Wl), (Hl, Wl))
    nh, nw = mesh.shape[AXIS_H], mesh.shape[AXIS_W]
    hi = mesh.index(AXIS_H) if nh > 1 else 0
    wi = mesh.index(AXIS_W) if nw > 1 else 0
    return Block(hi * Hl, wi * Wl, (Hl, Wl), (nh * Hl, nw * Wl))


def all_reduce_spatial(t: torch.Tensor, mesh: Optional[Mesh],
                       op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) in place over this rank's "h"
    group, then its "w" group (every group the mesh has, a group of one
    included); a partial sum over a block becomes the sum over the grid."""
    if mesh is not None:
        for axis in (AXIS_H, AXIS_W):
            if mesh.groups[axis] is not None:
                dist.all_reduce(t, op=op, group=mesh.groups[axis])
    return t


def _exchange(mesh: Mesh, axis: str, t: torch.Tensor, k: int, dim: int) -> None:
    """Fill the ``k`` halo slots at both ends of ``dim`` of ``t`` (this
    rank's block between them) from its neighbours along ``axis``, in one
    ``all_to_all_single`` whose split sizes are zero but for the neighbours'
    (NCCL sends nothing to a rank itself); the slots beyond the grid's edges
    stay as they are."""
    n = mesh.shape[axis]
    if k == 0 or n == 1:
        return
    m = t.shape[dim]
    if m - 2 * k < k:
        raise ValueError(f"a halo of {k} along mesh axis {axis!r} is wider than the "
                         f"neighbour's block of {m - 2 * k}")
    i = mesh.index(axis)
    splits = [0] * n
    sends, slots = [], []
    if i > 0:  # this block's first k to the rank before, whose last k arrive
        splits[i - 1] = k
        sends.append(t.narrow(dim, k, k))
        slots.append(t.narrow(dim, 0, k))
    if i < n - 1:  # its last k to the rank after, whose first k arrive
        splits[i + 1] = k
        sends.append(t.narrow(dim, m - 2 * k, k))
        slots.append(t.narrow(dim, m - k, k))
    send = torch.cat([s.movedim(dim, 0) for s in sends])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, splits, splits, group=mesh.groups[axis])
    for slot, part in zip(slots, recv.split(k)):
        slot.copy_(part.movedim(0, dim))


def halo_exchange(mesh: Mesh, x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """This rank's block ``x`` (..., Hl, Wl, C) with a halo: ``(..., Hl + 2
    rows, Wl + 2 cols, C)``, ``rows`` rows above and below from its "h"
    neighbours, then ``cols`` columns left and right from its "w"
    neighbours, taken from the row-extended block so that the corners
    arrive; zeros beyond the grid's edges, which is not periodic (a conv's
    zero padding). One ``all_to_all_single`` per axis, none where the axis
    is 1; ``ValueError`` where a neighbour's block is narrower than the
    halo."""
    Hl, Wl = x.shape[-3], x.shape[-2]
    if rows == 0 and cols == 0:
        return x
    out = x.new_zeros(x.shape[:-3] + (Hl + 2 * rows, Wl + 2 * cols) + x.shape[-1:])
    out[..., rows:rows + Hl, cols:cols + Wl, :] = x
    _exchange(mesh, AXIS_H, out[..., cols:cols + Wl, :], rows, -3)
    _exchange(mesh, AXIS_W, out, cols, -2)
    return out


def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Broadcast ``tensors`` in place from the mesh's first rank to all of
    its ranks (axis by axis, from index 0 of each fiber), the counterpart of
    placing them with JAX's replicated sharding. A no-op on one rank."""
    if mesh.size == 1:
        return tensors
    for axis in AXES:
        group = mesh.groups[axis]
        if group is None or mesh.shape[axis] == 1:
            continue
        src = mesh.fiber(axis)[0]
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=src,
                           group=group)
    return tensors
