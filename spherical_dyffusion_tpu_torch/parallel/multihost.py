"""Multi-process wireup: one process per GPU, over ``torch.distributed``.

Counterpart of ``spherical_dyffusion_tpu/parallel/multihost.py``. The JAX
package wires every host into one runtime with
``jax.distributed.initialize()``; here each process joins a process group
with ``init_process_group``: NCCL on the card, gloo only when the caller
asks for the CPU.

Opt-in by environment, with the JAX package's variables and results:

* ``SPHDY_COORDINATOR=host:port`` with ``SPHDY_NUM_PROCESSES`` and
  ``SPHDY_PROCESS_ID``: the group's rendezvous at ``tcp://host:port``, the
  world size and this process's rank (a coordinator without them takes
  torchrun's ``WORLD_SIZE`` and ``RANK``);
* ``SPHDY_MULTIHOST=1`` alone: ``env://``, torchrun's variables
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), where JAX
  reads the Cloud TPU metadata.

Launch, one process per card of a host (torchrun sets ``LOCAL_RANK``)::

    SPHDY_MULTIHOST=1 torchrun --nproc-per-node 4 -m spherical_dyffusion_tpu_torch.train ...

or, per process ``i`` of ``n``::

    SPHDY_COORDINATOR=10.0.0.2:29500 SPHDY_NUM_PROCESSES=n SPHDY_PROCESS_ID=i \\
        python -m spherical_dyffusion_tpu_torch.train ...

Each process drives the card ``LOCAL_RANK`` (else its rank modulo the cards
of its host). The command lines call :func:`maybe_init_multihost` before
they build anything.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["MultihostSpec", "parse_multihost_env", "maybe_init_multihost"]


@dataclasses.dataclass(frozen=True)
class MultihostSpec:
    """Parsed wireup parameters; ``None`` fields are read from torchrun's
    variables."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def parse_multihost_env(env: Mapping[str, str]) -> Optional[MultihostSpec]:
    """The wireup spec when the environment opts in, else ``None``.

    Raises ``ValueError`` on a malformed opt-in (a coordinator without a
    port, a process count or id that is not an integer, or only one of the
    two): a half-configured launch fails at start-up, not in the
    rendezvous."""
    coord = env.get("SPHDY_COORDINATOR", "").strip()
    flag = env.get("SPHDY_MULTIHOST", "").strip()
    if not coord and flag not in ("1", "true", "yes"):
        return None
    if not coord:
        return MultihostSpec()
    host, sep, port = coord.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"SPHDY_COORDINATOR must be host:port, got {coord!r}")

    def _int(name: str) -> Optional[int]:
        raw = env.get(name, "").strip()
        if not raw:
            return None
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"{name} must be an integer, got {raw!r}") from None

    num = _int("SPHDY_NUM_PROCESSES")
    pid = _int("SPHDY_PROCESS_ID")
    if (num is None) != (pid is None):
        raise ValueError("SPHDY_NUM_PROCESSES and SPHDY_PROCESS_ID must be set together "
                         "(or both left unset for auto-detection)")
    return MultihostSpec(coordinator_address=coord, num_processes=num, process_id=pid)


def maybe_init_multihost(env: Optional[Mapping[str, str]] = None,
                         backend: str = "nccl") -> Optional[MultihostSpec]:
    """Join the process group the environment describes.

    No-op (returns ``None``) unless the environment opts in. ``backend`` is
    "nccl" (the card; raises without CUDA, never falling back to gloo) or
    "gloo" (the CPU, when the caller asks for it). With NCCL the process
    takes the card ``LOCAL_RANK`` first. Idempotent: with a group already
    up it only returns the spec."""
    env = os.environ if env is None else env
    spec = parse_multihost_env(env)
    if spec is None:
        return None
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' (the card) or 'gloo' (the CPU)")
    if not dist.is_initialized():
        if spec.coordinator_address is None:
            init, world, rank = "env://", -1, -1
        else:
            init = f"tcp://{spec.coordinator_address}"
            world = spec.num_processes if spec.num_processes is not None else \
                int(env.get("WORLD_SIZE", "-1"))
            rank = spec.process_id if spec.process_id is not None else \
                int(env.get("RANK", "-1"))
            if world < 1 or rank < 0:
                raise ValueError("SPHDY_COORDINATOR without SPHDY_NUM_PROCESSES and "
                                 "SPHDY_PROCESS_ID needs torchrun's WORLD_SIZE and RANK")
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("NCCL process group: CUDA is not available; ask for the "
                                   "CPU (gloo) to run there")
            local = env.get("LOCAL_RANK")
            card = int(local) if local is not None else max(rank, 0) % torch.cuda.device_count()
            torch.cuda.set_device(card)
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    print(f"[multihost] process {dist.get_rank()}/{dist.get_world_size()} initialized "
          f"({dist.get_backend()})", flush=True)
    return spec
