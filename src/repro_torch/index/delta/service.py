"""FreshService: the read-write serving facade over base + delta (port of
`repro.index.delta.service`).

One object owns the whole freshness lifecycle:

    svc = FreshService(root)
    svc.bootstrap(x0)                  # gen-0 build, published + promoted
    eid = svc.insert(vec)              # lands in the delta overlay
    svc.delete(eid)                    # tombstone
    svc.search_batch(queries, k)       # base+delta unified, always correct
    svc.consolidate("gen-1")           # fold -> publish -> validate ->
                                       # promote -> hot swap -> fresh delta

External ids are stable for the lifetime of a point: the bootstrap corpus
gets `0..n0-1`, every insert gets the next integer, and consolidation --
which compacts the *internal* id space -- remaps the bookkeeping through
`old2new` so the same external id resolves to the same vector before and
after the swap.  Searches return external ids.

Consolidated builds flow through the exact blue/green lifecycle offline
builds use (`serve.deploy`): publish writes a checksummed artifact,
`validate` smoke-tests recall against exact ground truth computed on the
*live* corpus (inserts present, deletes gone), promote atomically moves
the ACTIVE pointer, and `BlueGreenEngine.refresh()` swaps the serving
engine only after the new index is fully constructed -- reads before the
swap see base+delta, reads after see the consolidated index, and there is
no point in between where a delete resurfaces.  An insert stays stored
across the swap, but after it the batched path finds it only as well as
its search budget lets: before it the overlay's exact delta scan returns
every insert, after it the approximate search does, and inserts from a
region far from the old corpus can lie beyond the served `EngineConfig`
budget (`l`, `max_hops`; the reference behaves the same, and an engine
with a larger budget reaches them).

`device` (None: the CUDA device) goes to the deployment manager (builds
and loads), the consolidation and the validation's exact ground truth;
`timings` holds the wall seconds of the last `consolidate`'s stages:
its own ("fold", "publish", "verify", "validate", "promote", "swap") and
the fold's (`consolidate_timed`'s "repair" to "index").
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..._device import resolve_device, to_device, to_numpy
from ...core.distances import exact_knn
from ...core.engine import BAMGIndex, BAMGParams
from ...serve.ann_engine import EngineConfig
from ...serve.deploy import BlueGreenEngine, DeploymentManager

from .consolidate import consolidate_timed
from .engine import FreshBAMGEngine
from .layer import DeltaLayer, DeltaParams


class FreshService:
    """Insert/delete/search over a blue/green-deployed BAMG index."""

    def __init__(self, root: str,
                 params: Optional[BAMGParams] = None,
                 config: Optional[EngineConfig] = None,
                 delta_params: Optional[DeltaParams] = None, device=None):
        self.device = device
        self.manager = DeploymentManager(root, device)
        self.params = params if params is not None else BAMGParams()
        self.config = config if config is not None else EngineConfig()
        self.delta_params = delta_params
        self.bg: Optional[BlueGreenEngine] = None
        self.delta: Optional[DeltaLayer] = None
        self.fresh: Optional[FreshBAMGEngine] = None
        self._ext_of_int = np.empty(0, np.int64)
        self._int_of_ext: dict[int, int] = {}
        self._next_ext = 0
        self.last_validation_recall: Optional[float] = None
        self.timings: dict[str, float] = {}

    # --- lifecycle ----------------------------------------------------------
    def _wire(self) -> None:
        """(Re)attach the delta overlay + unified engine to the ACTIVE
        build; called at bootstrap and after every hot swap."""
        self.delta = DeltaLayer(self.bg.index, self.delta_params)
        self.fresh = FreshBAMGEngine(self.bg.index, self.delta,
                                     engine=self.bg.engine)

    def bootstrap(self, x0: Optional[np.ndarray] = None,
                  build_id: str = "gen-0", *,
                  index: Optional[BAMGIndex] = None) -> str:
        """Build + publish + promote generation 0; start an empty delta.

        Pass either the corpus `x0` (built here with `self.params`) or a
        pre-built `index` (reused as-is, e.g. a cached benchmark build)."""
        if self.bg is not None:
            raise RuntimeError("bootstrap: service already running")
        if (x0 is None) == (index is None):
            raise ValueError("bootstrap: pass exactly one of x0 / index")
        idx = (index if index is not None
               else BAMGIndex.build(np.asarray(x0, np.float32), self.params,
                                    device=self.device))
        self.manager.publish(idx, build_id, meta={"generation": 0})
        self.manager.promote(build_id)   # promote() verifies the checksum
        self.bg = BlueGreenEngine(self.manager, self.config, keep_index=True)
        n0 = len(idx.x)
        self._ext_of_int = np.arange(n0, dtype=np.int64)
        self._int_of_ext = {e: e for e in range(n0)}
        self._next_ext = n0
        self._wire()
        return build_id

    @property
    def n_live(self) -> int:
        return self.delta.n_total - len(self.delta.tombstones)

    def stats(self) -> dict:
        """Freshness health snapshot: overlay size vs the frozen base,
        plus whether the overlay-pressure guard has tripped (the operator
        signal that a `consolidate()` epoch is overdue)."""
        d = self.delta
        return {
            "generation": len(self.manager.history()) - 1,
            "n_base": d.n_base,
            "n_delta": d.n_delta,
            "n_tombstones": len(d.tombstones),
            "n_live": self.n_live,
            "overlay_fraction": d.overlay_fraction,
            "overlay_pressure": d.overlay_pressure,
            "warn_fraction": d.params.warn_fraction,
            "overlay_memory_bytes": d.memory_bytes(),
        }

    def live_corpus(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors, external ids) of every live point, internal order --
        the corpus an equivalent from-scratch build would be given."""
        n = self.delta.n_total
        ids = np.arange(n, dtype=np.int64)
        if self.delta.tombstones:
            dead = np.fromiter(self.delta.tombstones, np.int64,
                               len(self.delta.tombstones))
            ids = ids[~np.isin(ids, dead)]
        return self.delta.vectors(ids), self._ext_of_int[ids]

    # --- writes -------------------------------------------------------------
    def insert_batch(self, vecs: np.ndarray) -> np.ndarray:
        """Insert vectors; returns their (stable) external ids."""
        int_ids = self.delta.insert_batch(vecs)
        ext = np.arange(self._next_ext, self._next_ext + len(int_ids),
                        dtype=np.int64)
        self._next_ext += len(int_ids)
        self._ext_of_int = np.concatenate([self._ext_of_int, ext])
        for e, i in zip(ext.tolist(), int_ids.tolist()):
            self._int_of_ext[e] = i
        return ext

    def insert(self, vec: np.ndarray) -> int:
        return int(self.insert_batch(np.asarray(vec)[None, :])[0])

    def delete(self, ext_id: int) -> None:
        """Tombstone by external id; takes effect on the next search."""
        i = self._int_of_ext.get(int(ext_id))
        if i is None:
            raise KeyError(f"delete: unknown or already-deleted external id "
                           f"{ext_id}")
        self.delta.delete(i)
        del self._int_of_ext[int(ext_id)]

    # --- reads --------------------------------------------------------------
    def _to_ext(self, ids: np.ndarray) -> np.ndarray:
        return np.where(ids >= 0, self._ext_of_int[np.clip(ids, 0, None)], -1)

    def search(self, q: np.ndarray, k: int, l: int = 48):
        """Host-path unified search; returns (external ids, exact dists)."""
        ids, d = self.fresh.search(q, k, l=l)
        return self._to_ext(ids), d

    def search_batch(self, queries: np.ndarray, k: int, *,
                     l: Optional[int] = None,
                     max_hops: Optional[int] = None):
        """Batched-path unified search; returns (external ids, dists)."""
        ids, d = self.fresh.search_batch(queries, k, l=l, max_hops=max_hops)
        return self._to_ext(ids), d

    # --- consolidation ------------------------------------------------------
    def consolidate(self, build_id: str,
                    queries: Optional[np.ndarray] = None,
                    k: int = 10, min_recall: float = 0.8,
                    keep_builds: Optional[int] = None) -> str:
        """Fold the delta into a fresh build and swap it live.

        publish -> verify -> validate (recall against exact ground truth
        on the live corpus, when `queries` given) -> promote ->
        `refresh()` hot swap -> new empty delta.  A build that fails
        validation raises and changes nothing: ACTIVE keeps serving the
        old base and the delta overlay stays in place, so reads never
        regress.  `keep_builds` prunes old artifacts afterwards (the
        ACTIVE build and rollback target are always retained)."""
        gen = len(self.manager.history())
        self.timings = {}
        idx, old2new, stages = self._timed(
            "fold", consolidate_timed, self.bg.index, self.delta,
            self.params, device=self.device)
        self.timings.update(stages)
        self._timed("publish", self.manager.publish, idx, build_id,
                    meta={"generation": gen,
                          "n_delta": int(self.delta.n_delta),
                          "n_deleted": len(self.delta.tombstones)})
        self._timed("verify", self.manager.verify, build_id)
        if queries is not None:
            self.last_validation_recall = self._timed(
                "validate", self._validate, build_id, idx, queries, k,
                min_recall)
        self._timed("promote", self.manager.promote, build_id)
        self._timed("swap", self.bg.refresh)
        # remap external-id bookkeeping onto the compacted id space
        live = np.nonzero(old2new >= 0)[0]
        self._ext_of_int = self._ext_of_int[live]
        self._int_of_ext = {int(e): i
                            for i, e in enumerate(self._ext_of_int.tolist())}
        self._wire()
        if keep_builds is not None:
            self.manager.prune(keep=keep_builds)
        return build_id

    def _timed(self, stage: str, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.timings[stage] = time.perf_counter() - t0
        return out

    def _validate(self, build_id: str, idx: BAMGIndex, queries, k: int,
                  min_recall: float) -> float:
        """`DeploymentManager.validate` against exact ground truth on the
        consolidated (live) corpus, computed on the service's device."""
        dev = resolve_device(self.device)
        queries = np.asarray(queries, np.float32)
        _, gt = exact_knn(to_device(idx.x, dev, torch.float32),
                          to_device(queries, dev), k)
        return self.manager.validate(build_id, queries, to_numpy(gt), k=k,
                                     min_recall=min_recall,
                                     config=self.config)
