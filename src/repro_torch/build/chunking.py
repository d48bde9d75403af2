"""Shared chunk pipeline for the batched build stages (port of
`repro.build.chunking`).

Every stage runs its chunks over a host-side work list; independent chunks
are pipelined two-deep (PyTorch releases the GIL inside its ops, so a
second worker stages one chunk while the other's work runs on the device).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

WORKERS = 2


def map_chunks(starts: Sequence[int], run: Callable[[int], None]) -> None:
    """Run `run(start)` for every chunk start, two-deep when >1 chunk.

    `run` must write its results into preallocated per-chunk slices (the
    chunks are disjoint, so concurrent writes never alias)."""
    if len(starts) > 1:
        with ThreadPoolExecutor(WORKERS) as ex:
            list(ex.map(run, starts))
    else:
        for s in starts:
            run(s)
