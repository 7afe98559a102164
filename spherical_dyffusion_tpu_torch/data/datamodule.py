"""Host-side data plumbing of the rollout.

Only ``prefetched`` of ``spherical_dyffusion_tpu/data/datamodule.py`` is
ported (copied: that module imports the JAX package's netCDF sources); the
datamodules come with the data layer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

__all__ = ["prefetched"]


def prefetched(iterable: Iterable, depth: int = 2) -> Iterator:
    """Background-thread prefetch with a bounded queue (double buffering at
    ``depth=2``): one producer thread runs the underlying iterator while the
    consumer works, so every source read happens on that one thread.
    Exceptions re-raise at the consumer. ``depth <= 0`` disables it."""
    if depth <= 0:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    errbox: list = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            errbox.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True, name="data-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if errbox:
                raise errbox[0]
            return
        yield item
