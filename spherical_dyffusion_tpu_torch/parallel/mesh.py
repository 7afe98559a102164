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
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "data_mesh", "batch_sharding", "shard_batch", "gather_batch",
           "replicated", "AXIS_DATA", "AXIS_H", "AXIS_W", "AXIS_MATMUL", "AXES"]

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


def batch_sharding(mesh: Mesh, ndim: int) -> tuple:
    """The partition of a (B, ...) batch: B over "data" (JAX's
    ``PartitionSpec`` entries). Latitudes and longitudes over "h" and "w"
    wait for spatial model parallelism (ROADMAP Queue 1 item 7b)."""
    return (AXIS_DATA,) + (None,) * (ndim - 1)


def _block(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
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


def shard_batch(mesh: Mesh, batch):
    """This rank's block of a batch (a tensor, or a dict or list of them;
    None passes): its rows over "data". On a mesh of one rank the batch
    itself."""
    if batch is None or mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return _block(mesh, batch, batch_sharding(mesh, batch.dim()))


def gather_batch(mesh: Mesh, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The inverse of ``shard_batch`` over the rows: this rank's rows
    gathered over the "data" group into the global batch."""
    group = mesh.groups[AXIS_DATA]
    if x is None or mesh.shape[AXIS_DATA] == 1 or group is None:
        return x
    x = x.contiguous()
    out = torch.empty((mesh.shape[AXIS_DATA] * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
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
