"""ServeRuntime: placement + compiled instruction stream + interpreter
(port of `repro.serve.runtime.runtime`).

The distributed serving entry point.  Construction binds the fleet onto a
device mesh (`ShardPlacement.plan`) and compiles the static serving
program for its topology (`compile_program`); `serve_batch` then just
hands batches to the interpreter.  The legacy `ShardedFrontend` is a thin
compatibility shim over this class -- every query it serves flows through
the instruction stream.

Shard-level administration (`mark_down` / `mark_up` / `health`) keeps the
frontend's semantics and report shape; the `health()` snapshot additionally
carries the replica map and worker count so a fleet operator can see
*where* a shard is running, not just whether it is up.

Where the card comes in: `build_shard_fleet` builds each shard with
`BAMGIndex.build(..., device)` (the NSG frontier is the exact-L2 hop
kernel) and serves it with `BatchedANNEngine.from_index`; placement puts
the engines on the mesh's devices (`device=None`: every CUDA device).
Every shard-batch is one engine call on the card; GATHER and MERGE are
the host's, on the numpy arrays the engines return.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ...core.engine import BAMGIndex, BAMGParams

from ..ann_engine import BatchedANNEngine, EngineConfig
from .instructions import InstructionInterpreter, compile_program
from .placement import ShardPlacement


def build_shard_fleet(x: np.ndarray, n_shards: int,
                      params: Optional[BAMGParams] = None,
                      config: Optional[EngineConfig] = None,
                      device=None):
    """Round-robin partition + per-shard BAMG build on `device` (None:
    the CUDA device).

    Returns (shard_vids, engines, host_indexes): the raw fleet pieces a
    `ServeRuntime` or `ShardedFrontend` is assembled from."""
    params = params or BAMGParams()
    config = config if config is not None else EngineConfig()
    owner = np.arange(len(x)) % n_shards
    vids, engines, indexes = [], [], []
    if len(x) < 3 * n_shards:
        raise ValueError(
            f"n_shards={n_shards} leaves <3 points per shard for a "
            f"{len(x)}-point corpus; a graph sub-index needs >=3 points")
    for s in range(n_shards):
        ids = np.nonzero(owner == s)[0]
        ns = len(ids)
        # small shards: graph-build degree/knn params cannot exceed n-1
        # (same clamp as navgraph's recursive layer builds)
        p = dataclasses.replace(
            params, seed=s, r=min(params.r, ns - 1),
            knn_k=min(params.knn_k, ns - 1),
            l_build=min(params.l_build, max(4, ns)))
        idx = BAMGIndex.build(x[ids], p, device=device)
        vids.append(ids)
        indexes.append(idx)
        engines.append(BatchedANNEngine.from_index(idx, config))
    return vids, engines, indexes


class ServeRuntime:
    """Distributed scatter-gather serving over a placed shard fleet.

    `shard_vids[s]` maps shard-local row ids back to global corpus ids.
    `mesh` (a `launch.mesh` host mesh) and `n_replicas` control
    placement; with neither, every shard gets one replica on a worker of
    `device` (None: every CUDA device, round-robin) -- on one device,
    exactly the legacy single-process fleet.
    """

    def __init__(self, shard_vids: Sequence[np.ndarray],
                 engines: Sequence[BatchedANNEngine],
                 host_indexes: Optional[Sequence[BAMGIndex]] = None,
                 mesh=None, n_replicas: int = 1, device=None):
        assert len(shard_vids) == len(engines)
        self.shard_vids = [np.asarray(v, np.int64) for v in shard_vids]
        # host BAMGIndex per shard (comparisons / persistence); None when
        # the runtime was assembled from bare engine arrays
        self.host_indexes = list(host_indexes) if host_indexes else None
        # -1 (absent) local ids pass through as global -1 via a sentinel row
        self._lut = [np.concatenate([v, [-1]]) for v in self.shard_vids]
        self.placement = ShardPlacement.plan(engines, mesh=mesh,
                                             n_replicas=n_replicas,
                                             device=device)
        self.program = compile_program(len(engines))
        self.interpreter = InstructionInterpreter(self.placement, self._lut)

    @classmethod
    def build(cls, x: np.ndarray, n_shards: int,
              params: Optional[BAMGParams] = None,
              config: Optional[EngineConfig] = None,
              mesh=None, n_replicas: int = 1,
              device=None) -> "ServeRuntime":
        """Partition + build + place a fleet in one call, on `device`
        (None: the CUDA device)."""
        vids, engines, indexes = build_shard_fleet(x, n_shards,
                                                   params=params,
                                                   config=config,
                                                   device=device)
        return cls(vids, engines, host_indexes=indexes, mesh=mesh,
                   n_replicas=n_replicas, device=device)

    @property
    def n_shards(self) -> int:
        return self.placement.n_shards

    @property
    def engines(self) -> list[BatchedANNEngine]:
        """Replica-0 engines in shard order (the caller's own objects)."""
        return self.placement.engines

    # --- shard health -------------------------------------------------------
    def mark_down(self, shard: int, reason: str = "marked down") -> None:
        self.placement.mark_down(shard, reason)

    def mark_up(self, shard: int) -> None:
        self.placement.mark_up(shard)

    def health(self) -> dict:
        """Snapshot: up/down counts, per-shard state, replica/worker map."""
        health = self.placement.shard_health
        down = [s for s, h in enumerate(health) if not h.up]
        return {"n_shards": self.n_shards,
                "shards_up": self.n_shards - len(down),
                "shards_down": down,
                "per_shard": [dataclasses.asdict(h) for h in health],
                "replicas": [[r.up for r in group]
                             for group in self.placement.shard_replicas],
                "n_workers": len(self.placement.workers)}

    # --- serving ------------------------------------------------------------
    def _scatter_exclude(self, exclude) -> Optional[list]:
        """Global tombstone ids -> per-shard local bool masks (None when a
        shard holds no tombstoned point, so its engine skips the merge)."""
        if exclude is None:
            return None
        ex = np.asarray(list(exclude), np.int64)
        if len(ex) == 0:
            return None
        out = []
        for vids in self.shard_vids:
            m = np.isin(vids, ex)
            out.append(m if m.any() else None)
        return out

    def serve_batch(self, queries: np.ndarray, k: int,
                    with_status: bool = False, *,
                    l: Optional[int] = None,
                    max_hops: Optional[int] = None,
                    exclude=None):
        """(B, D) queries -> global (ids (B, k) int64, dists (B, k)).

        One walk of the compiled program: SCATTER stages the batch and
        snapshots the shard mask, each live RUN makes one batched engine
        call on a round-robin replica (GATHER remaps local->global ids),
        and MERGE takes the global top-k in a single pass.  Masked shards
        are skipped without an engine call; a replica that raises is
        marked down and its RUN retried on the next replica.  With every
        shard down the answer is all -1/+inf.  `with_status=True`
        additionally returns a `ServeStatus` whose `degraded` flags mark
        answers that missed at least one shard.  `l`/`max_hops` shrink the
        beam for this batch only (deadline-pressed micro-batches).
        `exclude` is an iterable of *global* tombstoned ids (streaming
        freshness); they are scattered to shard-local masks and never
        appear in the merged top-k.
        """
        ids, dists, status = self.interpreter.execute(
            self.program, queries, k, l=l, max_hops=max_hops,
            exclude=self._scatter_exclude(exclude))
        if not with_status:
            return ids, dists
        return ids, dists, status
