"""Restart-safe sharded host data pipeline (port of
`repro.data.pipeline`).

  * Stateless: the batch for global step s is a pure function of
    (seed, s) -- no iterator state to checkpoint; restoring `step`
    restores the stream.
  * Sharded: each data-parallel host slices its rows of the global batch
    by process index, so every host touches only its shard.
  * Prefetched: a small bounded queue filled by one thread hides host
    generation latency.

Batches are trees (`utils.tree`) of numpy arrays or tensors.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from ..utils.tree import tree_map


class ShardedPipeline:
    """Wraps a `make_batch(step) -> tree` function with sharding + prefetch."""

    def __init__(self, make_batch: Callable[[int], object],
                 shard_fn: Optional[Callable[[object], object]] = None,
                 prefetch: int = 2):
        self.make_batch = make_batch
        self.shard_fn = shard_fn or (lambda b: b)
        self.prefetch = prefetch

    def batch_at(self, step: int):
        """Random access -- the restart-safety primitive."""
        return self.shard_fn(self.make_batch(step))

    def iterate(self, start_step: int, num_steps: int) -> Iterator:
        """Prefetching iterator of (step, batch) from `start_step`, for
        `num_steps` steps."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for s in range(start_step, start_step + num_steps):
                    q.put((s, self.batch_at(s)))
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def shard_rows(process_index: int, process_count: int):
    """Row-slice a batch tree for this host (leading dim = global batch)."""

    def fn(batch):
        def slice_leaf(x):
            per = x.shape[0] // process_count
            return x[process_index * per: (process_index + 1) * per]
        return tree_map(slice_leaf, batch)
    return fn
