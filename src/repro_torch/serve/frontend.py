"""Sharded scatter-gather serving front-end (compatibility shim; port of
`repro.serve.frontend`).

Historically this module *was* the serving layer: a single-process Python
loop over sub-index engines.  That loop now lives in
`serve.runtime` as a placed, instruction-stream runtime
(`ServeRuntime`: ShardPlacement -> SCATTER/RUN/GATHER/MERGE ->
deadline scheduler); `ShardedFrontend` survives as a thin shim so every
existing caller -- and every existing test -- exercises the new path with
the old API and bit-identical results.

The corpus is partitioned into S sub-corpora; each shard owns an
independently built BAMG sub-index wrapped in a `BatchedANNEngine`
(elastic: adding/removing a shard rebuilds only the moved partition).
A query batch makes ONE batched engine call per shard -- not a Python loop
over queries -- and the per-shard local top-k are mapped to global ids and
merged with a single top-k pass.

Degraded mode: a shard whose engine raises is marked down and its
RUN/GATHER instructions masked -- the merge proceeds over the surviving
shards and the answer is a partial top-k (flagged via
`ServeStatus.degraded` when `search_batch(..., with_status=True)`).
`health()` snapshots per-shard state; `mark_up()` restores a shard after
repair (e.g. a blue/green re-deploy of the failed sub-index).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.engine import BAMGIndex, BAMGParams

from .ann_engine import BatchedANNEngine, EngineConfig
from .runtime import ServeRuntime, ServeStatus, ShardHealth  # noqa: F401
from .runtime import build_shard_fleet
# legacy private names, still imported by tests and benchmarks
from .runtime.instructions import merge_topk as _merge_topk  # noqa: F401
from .runtime.instructions import pad_cols as _pad_cols  # noqa: F401


class ShardedFrontend:
    """Scatter-gather over S `BatchedANNEngine` sub-indexes.

    `shard_vids[s]` maps shard-local row ids back to global corpus ids.
    All serving flows through a `ServeRuntime` (the compiled instruction
    stream); this class only adapts the legacy constructor/attribute
    surface.  Pass `mesh` / `n_replicas` to place the fleet on a device
    mesh with replicated shards; without a mesh the workers are
    `device`'s (None: every CUDA device).
    """

    def __init__(self, shard_vids: Sequence[np.ndarray],
                 engines: Sequence[BatchedANNEngine],
                 host_indexes: Optional[Sequence[BAMGIndex]] = None,
                 mesh=None, n_replicas: int = 1, device=None):
        self.runtime = ServeRuntime(shard_vids, engines,
                                    host_indexes=host_indexes,
                                    mesh=mesh, n_replicas=n_replicas,
                                    device=device)

    @classmethod
    def build(cls, x: np.ndarray, n_shards: int,
              params: Optional[BAMGParams] = None,
              config: Optional[EngineConfig] = None,
              device=None) -> "ShardedFrontend":
        """Round-robin partition + per-shard BAMG build on `device` (None:
        the CUDA device)."""
        vids, engines, indexes = build_shard_fleet(x, n_shards,
                                                   params=params,
                                                   config=config,
                                                   device=device)
        return cls(vids, engines, host_indexes=indexes, device=device)

    # --- legacy attribute surface (delegates to the runtime) ----------------
    @property
    def shard_vids(self) -> list[np.ndarray]:
        return self.runtime.shard_vids

    @property
    def engines(self) -> list[BatchedANNEngine]:
        return self.runtime.engines

    @property
    def host_indexes(self):
        return self.runtime.host_indexes

    @property
    def _lut(self) -> list[np.ndarray]:
        return self.runtime._lut

    @property
    def _health(self) -> list[ShardHealth]:
        return self.runtime.placement.shard_health

    @property
    def n_shards(self) -> int:
        return self.runtime.n_shards

    # --- shard health -------------------------------------------------------
    def mark_down(self, shard: int, reason: str = "marked down") -> None:
        self.runtime.mark_down(shard, reason)

    def mark_up(self, shard: int) -> None:
        self.runtime.mark_up(shard)

    def health(self) -> dict:
        """Snapshot: overall up/down counts plus per-shard state."""
        return self.runtime.health()

    def search_batch(self, queries: np.ndarray, k: int,
                     with_status: bool = False, exclude=None):
        """(B, D) queries -> global (ids (B, k) int64, dists (B, k)).

        One walk of the runtime's compiled program: scatter, one batched
        call per live shard, local->global gather, single top-k merge.
        Marked-down shards are skipped by instruction masking; a shard
        whose engine raises is auto-marked down (skip-and-continue, never
        crash).  With every shard down the answer is all -1/+inf.
        `with_status=True` additionally returns a `ServeStatus` whose
        `degraded` flags mark answers that missed at least one shard.
        `exclude` forwards global tombstoned ids to the runtime.
        """
        return self.runtime.serve_batch(queries, k, with_status=with_status,
                                        exclude=exclude)
