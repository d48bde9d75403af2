"""The in-memory delta layer: insert graph + tombstones over a frozen base
(port of `repro.index.delta.layer`: host numpy and heapq, the reference's
code).

FreshDiskANN's central idea, adapted to BAMG: the disk-resident index
never mutates.  Writes land in a small in-memory overlay --

- **Inserts** get a global id past the frozen corpus (`n_base + slot`)
  and are wired into the graph by incremental RobustPrune: a beam search
  over the *overlay* graph collects candidates, `robust_prune_inc`
  selects the new point's out-edges, and reverse edges are added to
  copy-on-write copies of the neighbors' adjacency rows (the frozen rows
  are never touched -- an overridden row shadows its base row only in
  the overlay).  Overflowing reverse rows are re-pruned with the same
  rule, so overlay degrees stay bounded by R like the base graph.
- **Deletes** are tombstones.  A tombstoned node stays fully navigable
  (removing it would sever monotonic paths through it); it is masked
  from results by every search path and physically removed at
  consolidation.

The overlay is exact-distance and RAM-resident by design: it holds the
write traffic of one consolidation epoch, not the corpus.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import heapq

import numpy as np

from ...build.prune import robust_prune_inc

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DeltaParams:
    """Knobs of the overlay insert graph."""
    r: int = 32                # max overlay out-degree (default: base R)
    ef: int = 64               # beam width of the insert candidate search
    prune_alpha: float = 1.2   # RobustPrune slack for insert wiring
    max_steps: Optional[int] = None   # insert-beam hop cap (None = none)
    grow: float = 1.5          # geometric growth factor of the vector buffer
    # overlay pressure guard: warn (once per crossing) when the write
    # traffic -- inserts + tombstones -- exceeds this fraction of the
    # frozen base, the signal that a consolidation epoch is overdue
    warn_fraction: float = 0.25


class DeltaLayer:
    """Copy-on-write graph overlay + tombstone set over a frozen BAMGIndex.

    Global id space: base rows keep their ids `0..n_base-1`; the i-th
    inserted point is `n_base + i`.  `overrides` maps any id (base or
    delta) to its overlay adjacency row; ids without an override resolve
    to the frozen base row.
    """

    def __init__(self, base_index, params: Optional[DeltaParams] = None):
        base_x = np.asarray(base_index.x, np.float32)
        self.n_base, self.d = base_x.shape
        p = params or DeltaParams(r=base_index.params.r)
        self.params = p
        self._base_adj = np.asarray(base_index.graph.adj)
        self._base_blocks = np.asarray(base_index.graph.blocks)
        self._base_members = np.asarray(base_index.graph.members)
        self.entry = int(base_index.graph.entry)
        # growing vector buffer: base copy + delta appends (geometric)
        self._x = np.empty((int(self.n_base * p.grow) + 8, self.d), np.float32)
        self._x[:self.n_base] = base_x
        self._n = self.n_base
        self.overrides: dict[int, np.ndarray] = {}
        self.tombstones: set[int] = set()
        self._pressure_warned = False

    # --- structure ----------------------------------------------------------
    @property
    def n_total(self) -> int:
        """Ids in the global space (base + delta, tombstones included)."""
        return self._n

    @property
    def n_delta(self) -> int:
        return self._n - self.n_base

    def delta_ids(self) -> np.ndarray:
        """All delta-layer ids, tombstoned or not."""
        return np.arange(self.n_base, self._n, dtype=np.int64)

    def live_delta_ids(self) -> np.ndarray:
        ids = self.delta_ids()
        if not self.tombstones:
            return ids
        return ids[~np.isin(ids, np.fromiter(self.tombstones, np.int64,
                                             len(self.tombstones)))]

    def vector(self, vid: int) -> np.ndarray:
        return self._x[vid]

    def vectors(self, vids) -> np.ndarray:
        return self._x[np.asarray(vids, np.int64)]

    def neighbors(self, vid: int) -> np.ndarray:
        """Overlay adjacency row of `vid` (int64, no -1 padding)."""
        row = self.overrides.get(vid)
        if row is not None:
            return row
        nn = self._base_adj[vid]
        return nn[nn >= 0].astype(np.int64)

    def memory_bytes(self) -> int:
        ov = sum(r.nbytes for r in self.overrides.values())
        return self._x[:self._n].nbytes + ov + 8 * len(self.tombstones)

    @property
    def overlay_fraction(self) -> float:
        """Write traffic held by the overlay as a fraction of the frozen
        base: (inserts + tombstones) / n_base.  The overlay is sized for
        one consolidation epoch; past `params.warn_fraction` its exact-
        distance RAM search starts to dominate and freshness claims the
        blue/green consolidation was supposed to bound stop holding."""
        return (self.n_delta + len(self.tombstones)) / max(1, self.n_base)

    @property
    def overlay_pressure(self) -> bool:
        """Whether the overlay exceeds the configured pressure fraction."""
        return self.overlay_fraction > self.params.warn_fraction

    def _check_pressure(self) -> None:
        """Warn once per crossing (re-arms if the overlay shrinks, i.e.
        after consolidation swaps in a fresh layer)."""
        if not self.overlay_pressure:
            self._pressure_warned = False
            return
        if not self._pressure_warned:
            self._pressure_warned = True
            _LOG.warning(
                "delta overlay holds %d inserts + %d tombstones = %.1f%% of "
                "the %d-point base (warn_fraction=%.0f%%); consolidate soon",
                self.n_delta, len(self.tombstones),
                100.0 * self.overlay_fraction, self.n_base,
                100.0 * self.params.warn_fraction)

    # --- writes -------------------------------------------------------------
    def _grow_to(self, n: int) -> None:
        if n <= len(self._x):
            return
        cap = max(n, int(len(self._x) * self.params.grow) + 8)
        nx = np.empty((cap, self.d), np.float32)
        nx[:self._n] = self._x[:self._n]
        self._x = nx

    def insert(self, vec: np.ndarray) -> int:
        return int(self.insert_batch(np.asarray(vec)[None, :])[0])

    def insert_batch(self, vecs: np.ndarray) -> np.ndarray:
        """Wire a batch of new points into the overlay; returns their ids.

        Each point: beam-search the overlay for candidates, RobustPrune
        them into the point's out-edges, then add the reverse edges
        (copy-on-write; overflowing rows re-pruned).  Points of the same
        batch see their already-inserted batch-mates -- the overlay grows
        like a Vamana insert stream.
        """
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        if vecs.shape[1] != self.d:
            raise ValueError(f"insert dim {vecs.shape[1]} != corpus {self.d}")
        p = self.params
        out = np.empty(len(vecs), np.int64)
        self._grow_to(self._n + len(vecs))
        for i, v in enumerate(vecs):
            vid = self._n
            self._x[vid] = v
            self._n += 1
            cand_ids, _ = self._beam(v, ef=p.ef, max_steps=p.max_steps)
            kept = robust_prune_inc(v, cand_ids, self._x[cand_ids],
                                    r=p.r, alpha=p.prune_alpha)
            self.overrides[vid] = kept
            for u in kept.tolist():
                row = self.neighbors(u)
                if vid in row:
                    continue
                row = np.append(row, vid)
                if len(row) > p.r:
                    row = robust_prune_inc(self._x[u], row, self._x[row],
                                           r=p.r, alpha=p.prune_alpha)
                self.overrides[u] = row
            out[i] = vid
        self._check_pressure()
        return out

    def delete(self, vid: int) -> None:
        """Tombstone an id (base or delta).  Navigability is preserved;
        the point just can never surface in a result again."""
        if not (0 <= vid < self._n):
            raise KeyError(f"delete: id {vid} not in [0, {self._n})")
        self.tombstones.add(int(vid))
        self._check_pressure()

    def delete_batch(self, vids) -> None:
        for v in np.asarray(vids, np.int64).tolist():
            self.delete(v)

    # --- reads --------------------------------------------------------------
    def _beam(self, q: np.ndarray, ef: int,
              max_steps: Optional[int] = None,
              entries: Optional[list] = None):
        """Block-aware best-first beam over the overlay with exact distances.

        Returns (visited_ids, visited_dists) in visit order -- the same
        contract as `core.graph_build.greedy_search`, but (a)
        adjacency resolves through the copy-on-write overlay, so delta
        points are reachable and overridden base rows take effect, and
        (b) visiting a *base* node also expands its block siblings,
        matching Alg-4's block-first semantics: the refined BAMG
        adjacency is deliberately sparse because a block read scores
        every member for free, and a beam that ignores siblings loses
        the navigability the block layout provides.
        """
        seeds = entries if entries else [self.entry]
        cand: list[tuple[float, int]] = []
        seen = set()
        for e in seeds:
            dv = self._x[e] - q
            d0 = float(np.dot(dv, dv))
            if e not in seen:
                heapq.heappush(cand, (d0, int(e)))
                seen.add(int(e))
        visited: dict[int, float] = {}
        results: list[tuple[float, int]] = []   # max-heap via negation
        steps = 0
        while cand:
            d, v = heapq.heappop(cand)
            if len(results) >= ef and d > -results[0][0]:
                break
            visited[v] = d
            heapq.heappush(results, (-d, v))
            if len(results) > ef:
                heapq.heappop(results)
            nn = self.neighbors(v).tolist()
            if v < self.n_base:         # block siblings ride along (Alg-4)
                sib = self._base_members[self._base_blocks[v]]
                nn += [int(u) for u in sib[sib >= 0] if u != v]
            fresh = [u for u in nn if u not in seen]
            if fresh:
                diff = self._x[fresh] - q[None, :]
                dd = np.einsum("nd,nd->n", diff, diff)
                for u, du in zip(fresh, dd.tolist()):
                    seen.add(u)
                    heapq.heappush(cand, (float(du), u))
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        ids = np.fromiter(visited.keys(), np.int64, len(visited))
        ds = np.fromiter(visited.values(), np.float64, len(visited))
        return ids, ds

    def search(self, q: np.ndarray, k: int, ef: Optional[int] = None):
        """Top-k over the overlay graph (exact distances), tombstones
        masked.  Returns (ids (k,), dists (k,)) ascending -- may include
        *base* ids (the overlay contains the base graph), which the
        unified engine dedupes at merge."""
        q = np.asarray(q, np.float32)
        ids, ds = self._beam(q, ef=ef or max(self.params.ef, k))
        if self.tombstones:
            live = ~np.isin(ids, np.fromiter(self.tombstones, np.int64,
                                             len(self.tombstones)))
            ids, ds = ids[live], ds[live]
        o = np.argsort(ds, kind="stable")[:k]
        return ids[o], ds[o]
