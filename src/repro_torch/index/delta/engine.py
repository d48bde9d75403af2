"""Unified base+delta search: one query, two structures, one top-k (port
of `repro.index.delta.engine`).

Every query fans out to (a) the frozen BAMG index -- the host Alg-4
block-first path through the I/O simulator, or the fixed-shape batched
serve engine -- and (b) the in-memory delta overlay.  Both sides return
*exact* distances (the base path reranks through raw vectors, the overlay
is exact by construction), so the merge is a straight pool merge through
`build.pool.pool_merge`: base results seed the sorted pool, delta
candidates insert, duplicate ids collapse to the incumbent.  Tombstones
are masked on every path before the merge ever sees them:

- host base path: `exclude=` on `BAMGIndex.search` (masked at rerank);
- batched base path: the engine's tombstone mask (masked at rerank,
  which also covers the fused `backend="fused"` hop kernel -- the kernel
  only builds pools, rerank happens outside it);
- delta path: filtered from the overlay beam's result set.

A tombstoned id therefore never reaches the pool merge, the rerank, or
the final top-k on any path.

Where the card comes in: the batched base path is the engine's (the
`pq_adc` and beam-hop kernels on a CUDA engine); the host path's base
search builds its ADC table on the index's device.  The overlay, the
delta scan (`_delta_candidates`, numpy `einsum` as the reference, so its
ties stay the reference's) and the merge (`pool_merge` on CPU tensors)
are the host's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...build.pool import pool_merge

from .layer import DeltaLayer


def _merge_topk(base_ids, base_d, cand_ids, cand_d, k: int):
    """(B, Cb) sorted-unique base results + (B, Cc) candidates -> (B, k).

    Base rows satisfy the pool contract (ascending unique, -1/+inf pads);
    candidates may duplicate them (the host delta beam walks base nodes
    too) -- `pool_merge` collapses duplicates to the incumbent."""
    width = max(base_ids.shape[1], k)
    pad = width - base_ids.shape[1]
    if pad:
        base_ids = np.pad(base_ids, ((0, 0), (0, pad)), constant_values=-1)
        base_d = np.pad(base_d, ((0, 0), (0, pad)), constant_values=np.inf)
    ids, d, _ = pool_merge(
        torch.from_numpy(np.array(base_ids, np.int32)),
        torch.from_numpy(np.array(base_d, np.float32)),
        torch.zeros(base_ids.shape, dtype=torch.bool),
        torch.from_numpy(np.array(cand_ids, np.int32)),
        torch.from_numpy(np.array(cand_d, np.float32)), width)
    ids, d = ids.numpy(), d.numpy()
    ids = np.asarray(ids[:, :k], np.int64)
    d = np.asarray(d[:, :k], np.float64)
    return np.where(np.isfinite(d), ids, -1), d


class FreshBAMGEngine:
    """Serves base+delta unified top-k over a frozen index and its overlay.

    `base_index` is the frozen `BAMGIndex` (host path); `engine` is an
    optional `BatchedANNEngine` over the same index for the fixed-shape
    batched/fused path (`search_batch`).  The delta overlay is shared.
    """

    def __init__(self, base_index, delta: DeltaLayer,
                 engine=None):
        self.base = base_index
        self.delta = delta
        self.engine = engine

    # --- host path ----------------------------------------------------------
    def search(self, q: np.ndarray, k: int, l: int = 48,
               ef: Optional[int] = None):
        """One query through Alg-4 + the overlay beam; merged exact top-k.

        Returns (ids (k,) int64 with -1 pad, dists (k,) ascending)."""
        q = np.asarray(q, np.float32)
        tomb = self.delta.tombstones
        res = self.base.search(q, k=min(k, l), l=l,
                               exclude=tomb if tomb else None)
        d_ids, d_d = self.delta.search(q, k=k, ef=ef)
        ids, dists = _merge_topk(
            res.ids[None, :].astype(np.int64), res.dists[None, :],
            d_ids[None, :] if len(d_ids) else np.full((1, 1), -1, np.int64),
            d_d[None, :] if len(d_ids) else np.full((1, 1), np.inf), k)
        return ids[0], dists[0]

    # --- batched path -------------------------------------------------------
    def _delta_candidates(self, queries: np.ndarray, k: int):
        """Exact brute-force top-k over the live delta points (vectorized;
        the overlay holds one epoch of writes, so this is a small dense
        scan, the fixed-shape analog of the host overlay beam)."""
        live = self.delta.live_delta_ids()
        if len(live) == 0:
            b = len(queries)
            return (np.full((b, 1), -1, np.int64),
                    np.full((b, 1), np.inf, np.float64))
        xd = self.delta.vectors(live)                      # (Nd, D)
        diff = queries[:, None, :] - xd[None, :, :]
        d = np.einsum("bnd,bnd->bn", diff, diff)           # (B, Nd)
        kk = min(k, len(live))
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        pd = np.take_along_axis(d, part, axis=1)
        o = np.argsort(pd, axis=1, kind="stable")
        return (live[np.take_along_axis(part, o, axis=1)],
                np.take_along_axis(pd, o, axis=1))

    def search_batch(self, queries: np.ndarray, k: int, *,
                     l: Optional[int] = None,
                     max_hops: Optional[int] = None):
        """(B, D) -> merged (ids (B, k) int64, dists (B, k)) over
        base (batched/fused engine, tombstones masked at rerank) + delta
        (exact scan, tombstones filtered)."""
        if self.engine is None:
            raise RuntimeError("no BatchedANNEngine attached; construct "
                               "FreshBAMGEngine(..., engine=...) for the "
                               "batched path")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        tomb = self.delta.tombstones
        base_tomb = [t for t in tomb if t < self.delta.n_base]
        b_ids, b_d = self.engine.search_batch(
            queries, k, l=l, max_hops=max_hops,
            exclude=base_tomb if base_tomb else None)
        c_ids, c_d = self._delta_candidates(queries, k)
        return _merge_topk(b_ids, b_d, c_ids, c_d, k)
