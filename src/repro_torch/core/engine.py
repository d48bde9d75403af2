"""Public index API of the port (from `repro.core.engine`): build / save /
load / search for the three compared systems (DiskANN, Starling-style,
BAMG), all on the same I/O simulator.

    idx = BAMGIndex.build(x, BAMGParams(alpha=3, beta=1.05))  # on the card
    res = idx.search(q, k=10, l=64)          # one query
    out = idx.search_batch(queries, k=10, l=64)  # stats aggregated
    idx.save("idx.npz"); idx = BAMGIndex.load("idx.npz")
    eng = BatchedANNEngine.from_index(idx)   # the same index, batched

Where the card comes in:

* **Builds** (`build`, `from_graph`, `load`) take ``device=None``, which
  means the CUDA device (`_device.resolve_device` raises without one);
  tests pass ``device="cpu"``.  The graph goes through `build.GraphBuilder`
  (`_builder_for`), whose batched backend runs the construction frontier
  as the exact-L2 hop kernel; PQ trains and encodes on the device.
* **Search tables**: `search_batch` builds every query's (M, K) ADC table
  in one `core.pq.adc_tables` call on the index's device and copies the
  (B, M, K) block to the host once; `search` does the same for one query.
  A caller may pass its own tables (`table=` / `tables=`).
* **The disk search itself** (`core.search`) is the host's: one Python
  query at a time, every block fetch routed through the I/O simulator so
  NIO/recall match the paper's accounting.  The indexes therefore keep
  ``x`` and ``codes`` as numpy arrays on the host; only the codec's
  codebooks live on the device.

Every params dataclass keeps every field of the reference, with one
difference: ``build_backend`` defaults to ``"batched"`` (the card's path,
as `build.BuildConfig` does) where the reference defaults to ``"host"``.

I/O knobs (all three systems; see `core.io_sim` for the two metric
domains):

* ``cache_policy`` ('lru' | 'fifo' | 'clock' | '2q') and ``cache_blocks``
  select the block-cache replacement policy and capacity; BAMG additionally
  has ``vec_cache_blocks`` for the decoupled vector region and
  ``pin_nav_blocks`` -- a budget of hot navigation-entry graph blocks pinned
  in memory forever (Starling-style; pins count against ``cache_blocks``).
* ``qd`` is the io_uring-style queue depth of the pipelined `IOScheduler`;
  ``batch_io=True`` makes search issue batched submissions (per-hop frontier
  prefetch + one-shot re-rank reads).  Accounting (NIO, recall, cache hits)
  is bit-identical to the serial path -- only `BatchStats.mean_service_us`
  (pipelined) vs `mean_serial_us` (sequential) and the derived
  `qps_pipelined` change.
* ``search_batch(..., warm_cache=True)`` keeps the block cache warm across
  the queries of a batch (cross-query serving mode); the default cold cache
  per query matches the paper's NIO accounting.

The interchange format is the `BAMGIndex.save` npz: the reference's keys,
dtypes and nav layout, read by either package's `load`.  `batch_arrays` /
`load_batch_arrays` give `serve.BatchedANNEngine` its arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device, to_device, to_numpy
from ..build import BuildConfig, GraphBuilder
from ..utils.faults import FaultPlan, FaultSpec, RetryPolicy
from .bamg import BAMGGraph
from .block_assign import block_members, bnf_blocks
from .distances import recall_at_k
from .graph_build import build_vamana, degree_stats
from .io_sim import CostModel
from .navgraph import (NavGraph, NavLayer, _greedy_layer, build_navgraph,
                       nav_pin_gblocks, search_nav)
from .pq import PQCodec, train_pq
from .search import SearchResult, search_bamg, search_coupled
from .storage import (CoupledStorage, DecoupledStorage,
                      coupled_nodes_per_block, max_capacity_for)


def _pick_pq_m(d: int, target: int | None = None) -> int:
    """Largest M <= target dividing d (PQ subspace count).  The default
    target scales with dimension (~d/16, clamped to [16, 64])."""
    if target is None:
        target = min(64, max(16, d // 16))
    for m in range(min(target, d), 0, -1):
        if d % m == 0:
            return m
    return 1


def entry_candidates(nav_vids, n: int, n_entry_cands: int = 256) -> np.ndarray:
    """The engine's entry-candidate pool: the finest nav layer's vids when
    the index has a nav graph (`nav_vids`, else None: every vid of the n),
    cut to `n_entry_cands` by even striding so candidates stay spread
    across the corpus.  (E,) int64."""
    if nav_vids is not None:
        cands = np.asarray(nav_vids, np.int64)
    else:
        cands = np.arange(n, dtype=np.int64)
    if len(cands) > n_entry_cands:
        cands = cands[np.linspace(0, len(cands) - 1, n_entry_cands,
                                  dtype=np.int64)]
    return cands


def batch_arrays(x, graph, codes, codebooks, nav=None,
                 n_entry_cands: int = 256) -> dict:
    """Fixed-shape numpy arrays for `serve.BatchedANNEngine`, from a built
    BAMG (`core.bamg.BAMGGraph`), its PQ codes and codebooks (arrays or
    tensors) and its nav graph (`core.navgraph.NavGraph` or None): exactly
    the dict of `BAMGIndex.batch_arrays(n_entry_cands)` -- x (N, D) f32,
    adj (N, R) int32 with -1 pad, codes (N, M) uint8, codebooks
    (M, K, dsub) f32, entry_cands (E,) int64."""
    nav_vids = nav.layers[-1].vids if nav is not None and nav.layers else None
    return {
        "x": to_numpy(x, np.float32),
        "adj": np.asarray(graph.adj, np.int32),
        "codes": to_numpy(codes, np.uint8),
        "codebooks": to_numpy(codebooks, np.float32),
        "entry_cands": entry_candidates(nav_vids, len(x), n_entry_cands),
    }


def load_batch_arrays(path: str, n_entry_cands: int = 256) -> dict:
    """Read a `BAMGIndex.save` npz into exactly the dict that
    `BAMGIndex.batch_arrays(n_entry_cands)` returns (see `batch_arrays`)."""
    with np.load(path) as z:
        n_nav = int(z["n_nav"])
        nav_vids = z[f"nav{n_nav - 1}_vids"] if n_nav > 0 else None
        return {
            "x": np.asarray(z["x"], np.float32),
            "adj": np.asarray(z["adj"], np.int32),
            "codes": np.asarray(z["codes"], np.uint8),
            "codebooks": np.asarray(z["codebooks"], np.float32),
            "entry_cands": entry_candidates(nav_vids, len(z["x"]),
                                            n_entry_cands),
        }


# ---------------------------------------------------------------------------
# Shared machinery
# ---------------------------------------------------------------------------
def _tables(codec: PQCodec, queries) -> np.ndarray:
    """(B, d) queries -> their (B, M, K) ADC tables: one `adc_tables` call
    on the codebooks' device, one copy to the host."""
    q = to_device(np.atleast_2d(to_numpy(queries, np.float32)),
                  codec.codebooks.device, torch.float32)
    return to_numpy(codec.adc_tables(q), np.float32)


def _train_codec(x: np.ndarray, pq_m: Optional[int], seed: int,
                 device: torch.device) -> tuple[PQCodec, np.ndarray]:
    """PQ trained and x encoded on `device`; codes come back to the host
    (the disk search reads them there)."""
    xt = to_device(x, device, torch.float32)
    codec = train_pq(xt, m=pq_m or _pick_pq_m(x.shape[1]), seed=seed)
    return codec, to_numpy(codec.encode(xt), np.uint8)


def _batch(search_one, queries, tables, gt, k: int, cost: CostModel,
           warm_cache: bool) -> BatchStats:
    """Shared batch loop: `search_one(i, q, table, drop_cache)` per query;
    a warm cache drops only before the first query (cross-query serving
    mode)."""
    res = [search_one(i, q, t, (not warm_cache) or i == 0)
           for i, (q, t) in enumerate(zip(queries, tables))]
    return _aggregate(res, gt, k, cost)


# configure_io sentinel: None is a meaningful value for the fault/deadline
# knobs (it *disables* them), so "leave unchanged" needs its own marker
_KEEP = object()


def _update_io_params(p, updates: dict, keep_updates: dict | None = None) -> None:
    """None-means-unchanged in-place update of an index's params; entries in
    `keep_updates` use the _KEEP sentinel instead (None is meaningful)."""
    for name, val in updates.items():
        if val is not None:
            setattr(p, name, val)
    for name, val in (keep_updates or {}).items():
        if val is not _KEEP:
            setattr(p, name, val)


def _fault_plan(p) -> Optional[FaultPlan]:
    """The index's seeded fault plan (None when fault injection is off)."""
    return FaultPlan(p.faults, seed=p.fault_seed) if p.faults is not None else None


def _cost_for(p) -> CostModel:
    return CostModel(qd=p.qd, timeout_us=p.timeout_us, hedge_us=p.hedge_us)


def _configure_coupled_io(idx, cache_policy, cache_blocks, qd, batch_io,
                          faults=_KEEP, fault_seed=None, retry=_KEEP,
                          timeout_us=_KEEP, hedge_us=_KEEP):
    """Rebuild only the coupled storage/scheduler with new I/O knobs (the
    graph, PQ codes, and layout are untouched) -- cheap sweeps."""
    _update_io_params(idx.params, dict(
        cache_policy=cache_policy, cache_blocks=cache_blocks, qd=qd,
        batch_io=batch_io, fault_seed=fault_seed),
        dict(faults=faults, retry=retry, timeout_us=timeout_us,
             hedge_us=hedge_us))
    p = idx.params
    idx.store = CoupledStorage(idx.x, idx.adj, order=idx.store.layout,
                               policy=p.cache_policy,
                               cache_blocks=p.cache_blocks,
                               cost=_cost_for(p), faults=_fault_plan(p),
                               retry=p.retry)
    idx.cost = idx.store.scheduler.cost
    return idx


def _builder_for(params, device: torch.device) -> GraphBuilder:
    """GraphBuilder on `device` from an index params dataclass
    (`build_backend`: "batched", the default, runs the expensive stages as
    tensor programs with the exact-L2 hop kernel as the frontier; "host"
    keeps the per-node numpy reference pipeline)."""
    knn = getattr(params, "build_knn", "clustered")  # BAMG-only knob:
    # Vamana (DiskANN/Starling) has no kNN stage, so only BAMGParams
    # carries it
    return GraphBuilder(BuildConfig(backend=params.build_backend,
                                    batch_size=params.build_batch,
                                    knn_mode=knn), device=device)


@dataclasses.dataclass
class BatchStats:
    recall: float
    mean_nio: float
    mean_graph_reads: float
    mean_vector_reads: float
    mean_hops: float
    mean_n_dist: float
    mean_n_pq: float
    qps: float
    mean_service_us: float = 0.0   # pipelined I/O wall-clock (qd-overlapped)
    mean_serial_us: float = 0.0    # same demand misses, strictly serial
    cache_hit_rate: float = 0.0    # hits / (hits + NIO) over the batch
    qps_pipelined: float = 0.0     # QPS with the pipelined service time
    # resilience (fault injection; all zero on a clean run)
    degraded_fraction: float = 0.0  # queries that lost >=1 block to faults
    mean_failed_reads: float = 0.0  # undeliverable blocks skipped per query
    mean_retries: float = 0.0       # extra read attempts per query
    mean_hedges: float = 0.0        # hedged duplicate reads per query
    p99_service_us: float = 0.0     # tail of the pipelined service time


def _aggregate(results: list[SearchResult], gt: Optional[np.ndarray], k: int,
               cost: CostModel) -> BatchStats:
    nio = float(np.mean([r.nio for r in results]))
    nd = float(np.mean([r.n_dist for r in results]))
    npq = float(np.mean([r.n_pq for r in results]))
    rec = -1.0
    if gt is not None:
        idm = np.full((len(results), k), -1, np.int64)   # short results pad
        for i, r in enumerate(results):
            m = min(k, len(r.ids))
            idm[i, :m] = r.ids[:m]
        rec = recall_at_k(idm, gt, k)
    service_all = np.asarray([r.service_us for r in results], np.float64)
    service = float(service_all.mean())
    hits = float(np.sum([r.cache_hits for r in results]))
    total_nio = float(np.sum([r.nio for r in results]))
    return BatchStats(
        recall=rec, mean_nio=nio,
        mean_graph_reads=float(np.mean([r.graph_reads for r in results])),
        mean_vector_reads=float(np.mean([r.vector_reads for r in results])),
        mean_hops=float(np.mean([r.hops for r in results])),
        mean_n_dist=nd, mean_n_pq=npq, qps=cost.qps(nio, nd, npq),
        mean_service_us=service,
        mean_serial_us=float(np.mean([r.serial_us for r in results])),
        cache_hit_rate=hits / (hits + total_nio) if hits + total_nio else 0.0,
        qps_pipelined=cost.qps_from_io_us(service, nd, npq),
        degraded_fraction=float(np.mean([r.degraded for r in results])),
        mean_failed_reads=float(np.mean([r.failed_reads for r in results])),
        mean_retries=float(np.mean([r.retries for r in results])),
        mean_hedges=float(np.mean([r.hedges for r in results])),
        p99_service_us=float(np.percentile(service_all, 99)))


class _HostIndex:
    """What the three indexes share: the codec's device, the ADC tables
    of a query batch, and the batch loop over them."""

    @property
    def device(self) -> torch.device:
        return self.codec.codebooks.device

    def _codebook_bytes(self) -> int:
        cb = self.codec.codebooks
        return cb.numel() * cb.element_size()

    def _table(self, q, table) -> np.ndarray:
        return _tables(self.codec, q)[0] if table is None else table

    def _run_batch(self, search_one, queries, tables, gt, k: int,
                   warm_cache: bool) -> BatchStats:
        queries = to_numpy(queries, np.float32)
        tables = _tables(self.codec, queries) if tables is None else tables
        return _batch(search_one, queries, tables, gt, k, self.cost,
                      warm_cache)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DiskANNParams:
    r: int = 32
    l_build: int = 64
    alpha: float = 1.2
    pq_m: Optional[int] = None
    cache_policy: str = "lru"        # block-cache replacement policy
    cache_blocks: int = 256          # block-cache capacity
    qd: int = 1                      # I/O queue depth (pipelined scheduler)
    batch_io: bool = False           # batched submissions + prefetch
    build_backend: str = "batched"   # "batched" (the card) | "host"
    build_batch: int = 256           # nodes per batched-build step
    faults: Optional[FaultSpec] = None   # fault injection (None = clean disk)
    fault_seed: int = 0              # seed of the deterministic fault plan
    retry: Optional[RetryPolicy] = None  # bounded-retry policy (None = default)
    timeout_us: Optional[float] = None   # abandon an attempt past this
    hedge_us: Optional[float] = None     # duplicate-read hedge age
    seed: int = 0


class DiskANNIndex(_HostIndex):
    """Vamana graph + coupled layout in graph order + Alg. 1 search."""

    kind = "diskann"

    def __init__(self, x, adj, entry, codec, codes, store, params=None):
        self.x, self.adj, self.entry = x, adj, entry
        self.codec, self.codes, self.store = codec, codes, store
        self.params = params if params is not None else DiskANNParams()
        self.cost = store.scheduler.cost

    @classmethod
    def build(cls, x: np.ndarray, params: DiskANNParams = DiskANNParams(),
              device=None):
        dev = resolve_device(device)
        x = to_numpy(x, np.float32)
        params = dataclasses.replace(params)   # configure_io mutates in place
        adj, entry = _builder_for(params, dev).build_vamana(
            x, r=params.r, l_build=params.l_build, alpha=params.alpha,
            seed=params.seed)
        codec, codes = _train_codec(x, params.pq_m, params.seed, dev)
        store = CoupledStorage(x, adj, policy=params.cache_policy,
                               cache_blocks=params.cache_blocks,
                               cost=_cost_for(params),
                               faults=_fault_plan(params), retry=params.retry)
        return cls(x, adj, entry, codec, codes, store, params)

    def configure_io(self, cache_policy: Optional[str] = None,
                     cache_blocks: Optional[int] = None,
                     qd: Optional[int] = None,
                     batch_io: Optional[bool] = None,
                     faults=_KEEP, fault_seed: Optional[int] = None,
                     retry=_KEEP, timeout_us=_KEEP,
                     hedge_us=_KEEP) -> "DiskANNIndex":
        """Rebuild only the storage/scheduler with new I/O knobs."""
        return _configure_coupled_io(self, cache_policy, cache_blocks, qd,
                                     batch_io, faults=faults,
                                     fault_seed=fault_seed, retry=retry,
                                     timeout_us=timeout_us, hedge_us=hedge_us)

    def search(self, q: np.ndarray, k: int, l: int,
               drop_cache: bool = True,
               exclude: Optional[set] = None,
               table: Optional[np.ndarray] = None) -> SearchResult:
        q = to_numpy(q, np.float32)
        table = self._table(q, table)
        bs = max(2, self.params.qd) if self.params.batch_io else None
        return search_coupled(self.store, self.codes, table, q, self.entry,
                              k, l, block_level=False, batch_submit=bs,
                              drop_cache=drop_cache, exclude=exclude)

    def search_batch(self, queries: np.ndarray, k: int, l: int,
                     gt: Optional[np.ndarray] = None,
                     warm_cache: bool = False,
                     exclude: Optional[set] = None,
                     tables: Optional[np.ndarray] = None) -> BatchStats:
        return self._run_batch(
            lambda i, q, t, dc: self.search(q, k, l, drop_cache=dc,
                                            exclude=exclude, table=t),
            queries, tables, gt, k, warm_cache)

    def degree_stats(self):
        blocks = (self.store.pos // self.store.npb).astype(np.int64)
        return degree_stats(self.adj, blocks)

    def index_bytes(self) -> int:
        return self.store.device.total_bytes

    def memory_bytes(self) -> int:
        return self.codes.nbytes + self._codebook_bytes()


@dataclasses.dataclass
class StarlingParams:
    r: int = 32
    l_build: int = 64
    alpha: float = 1.2
    pq_m: Optional[int] = None
    nav_sample: float = 0.05     # random in-memory nav sample fraction
    cache_policy: str = "lru"
    cache_blocks: int = 256
    qd: int = 1
    batch_io: bool = False
    build_backend: str = "batched"  # "batched" (the card) | "host"
    build_batch: int = 256       # nodes per batched-build step
    faults: Optional[FaultSpec] = None   # fault injection (None = clean disk)
    fault_seed: int = 0              # seed of the deterministic fault plan
    retry: Optional[RetryPolicy] = None  # bounded-retry policy (None = default)
    timeout_us: Optional[float] = None   # abandon an attempt past this
    hedge_us: Optional[float] = None     # duplicate-read hedge age
    seed: int = 0


class StarlingIndex(_HostIndex):
    """Vamana graph + BNF block-shuffled coupled layout + block-level search
    + random-sample in-memory navigation graph (Starling [38])."""

    kind = "starling"

    def __init__(self, x, adj, entry, codec, codes, store, nav_vids, nav_adj,
                 params=None):
        self.x, self.adj, self.entry = x, adj, entry
        self.codec, self.codes, self.store = codec, codes, store
        self.nav_vids, self.nav_adj = nav_vids, nav_adj
        self.params = params if params is not None else StarlingParams()
        self.cost = store.scheduler.cost

    @classmethod
    def build(cls, x: np.ndarray, params: StarlingParams = StarlingParams(),
              device=None):
        dev = resolve_device(device)
        x = to_numpy(x, np.float32)
        params = dataclasses.replace(params)   # configure_io mutates in place
        adj, entry = _builder_for(params, dev).build_vamana(
            x, r=params.r, l_build=params.l_build, alpha=params.alpha,
            seed=params.seed)
        npb = coupled_nodes_per_block(x.shape[1], params.r)
        blocks = bnf_blocks(adj, npb, seed=params.seed)
        order = np.argsort(blocks, kind="stable").astype(np.int64)
        codec, codes = _train_codec(x, params.pq_m, params.seed, dev)
        store = CoupledStorage(x, adj, order=order,
                               policy=params.cache_policy,
                               cache_blocks=params.cache_blocks,
                               cost=_cost_for(params),
                               faults=_fault_plan(params), retry=params.retry)
        # Starling nav graph: random sample + Vamana over the sample
        rng = np.random.default_rng(params.seed)
        ns = max(16, int(len(x) * params.nav_sample))
        nav_vids = np.sort(rng.choice(len(x), size=min(ns, len(x)), replace=False))
        if len(nav_vids) > 8:
            nav_adj, _ = build_vamana(x[nav_vids], r=min(16, len(nav_vids) - 1),
                                      l_build=32, alpha=1.2, seed=params.seed,
                                      device=dev)
        else:
            nav_adj = -np.ones((len(nav_vids), 1), np.int32)
        return cls(x, adj, entry, codec, codes, store, nav_vids, nav_adj,
                   params)

    def configure_io(self, cache_policy: Optional[str] = None,
                     cache_blocks: Optional[int] = None,
                     qd: Optional[int] = None,
                     batch_io: Optional[bool] = None,
                     faults=_KEEP, fault_seed: Optional[int] = None,
                     retry=_KEEP, timeout_us=_KEEP,
                     hedge_us=_KEEP) -> "StarlingIndex":
        """Rebuild only the storage/scheduler with new I/O knobs."""
        return _configure_coupled_io(self, cache_policy, cache_blocks, qd,
                                     batch_io, faults=faults,
                                     fault_seed=fault_seed, retry=retry,
                                     timeout_us=timeout_us, hedge_us=hedge_us)

    def _nav_entries(self, table: np.ndarray, n_entry: int = 4) -> list[int]:
        # greedy over the sampled nav graph using PQ distances
        layer = NavLayer(vids=self.nav_vids.astype(np.int64), adj=self.nav_adj, entry=0)

        def pq_dist(vids):
            c = self.codes[vids].astype(np.int64)
            return table[np.arange(table.shape[0])[None, :], c].sum(1)

        ids, _ = _greedy_layer(layer, [0], pq_dist, ef=16)
        return [int(self.nav_vids[i]) for i in ids[:n_entry]] or [self.entry]

    def search(self, q: np.ndarray, k: int, l: int,
               drop_cache: bool = True,
               exclude: Optional[set] = None,
               table: Optional[np.ndarray] = None) -> SearchResult:
        q = to_numpy(q, np.float32)
        table = self._table(q, table)
        entries = self._nav_entries(table)
        bs = max(2, self.params.qd) if self.params.batch_io else None
        return search_coupled(self.store, self.codes, table, q, entries,
                              k, l, block_level=True, batch_submit=bs,
                              drop_cache=drop_cache, exclude=exclude)

    def search_batch(self, queries: np.ndarray, k: int, l: int,
                     gt: Optional[np.ndarray] = None,
                     warm_cache: bool = False,
                     exclude: Optional[set] = None,
                     tables: Optional[np.ndarray] = None) -> BatchStats:
        return self._run_batch(
            lambda i, q, t, dc: self.search(q, k, l, drop_cache=dc,
                                            exclude=exclude, table=t),
            queries, tables, gt, k, warm_cache)

    def degree_stats(self):
        blocks = (self.store.pos // self.store.npb).astype(np.int64)
        return degree_stats(self.adj, blocks)

    def index_bytes(self) -> int:
        return self.store.device.total_bytes

    def memory_bytes(self) -> int:
        # Starling keeps an id<->block map in memory (paper §5.2.5)
        return (self.codes.nbytes + self._codebook_bytes()
                + self.nav_adj.nbytes + self.nav_vids.nbytes
                + self.store.pos.nbytes + self.store.layout.nbytes
                + self.x.shape[1] * 4 * len(self.nav_vids))  # nav raw vectors


# ---------------------------------------------------------------------------
# BAMG
# ---------------------------------------------------------------------------
def _make_decoupled_store(x, graph, nav, p) -> DecoupledStorage:
    """Decoupled storage from a built graph + the I/O knobs in params."""
    pins = ()
    if p.pin_nav_blocks > 0:
        budget = min(p.pin_nav_blocks, max(0, p.cache_blocks))
        pins = nav_pin_gblocks(nav, graph.blocks, budget, entry=graph.entry)
    return DecoupledStorage(
        x, graph.adj, graph.blocks, graph.members,
        cache_blocks=p.cache_blocks, vec_cache_blocks=p.vec_cache_blocks,
        policy=p.cache_policy,
        vec_policy=p.vec_cache_policy, pinned_gblocks=pins,
        cost=_cost_for(p), faults=_fault_plan(p), retry=p.retry)


@dataclasses.dataclass
class BAMGParams:
    alpha: int = 3
    beta: float = 1.05
    r: int = 32
    l_build: int = 64
    knn_k: int = 32
    gamma: int = 256
    capacity: Optional[int] = None   # default: max for 4 KB graph block
    pq_m: Optional[int] = None
    use_nav: bool = True
    use_bmrng_prune: bool = True     # ablation: BAMG w/o BMRNG rule
    sibling_edges: bool = True
    cache_policy: str = "lru"        # graph block cache policy
    vec_cache_policy: Optional[str] = None   # default: same as cache_policy
    cache_blocks: int = 256          # graph block cache capacity
    vec_cache_blocks: int = 256      # vector block cache capacity
    qd: int = 1                      # I/O queue depth (pipelined scheduler)
    batch_io: bool = False           # batched submissions (top-alpha + rerank)
    pin_nav_blocks: int = 0          # nav-entry graph blocks pinned in memory
    build_backend: str = "batched"   # "batched" (the card) | "host"
    build_batch: int = 256           # nodes per batched-build step
    build_knn: str = "clustered"     # batched kNN stage: "clustered"|"exact"
    faults: Optional[FaultSpec] = None   # fault injection (None = clean disk)
    fault_seed: int = 0              # seed of the deterministic fault plan
    retry: Optional[RetryPolicy] = None  # bounded-retry policy (None = default)
    timeout_us: Optional[float] = None   # abandon an attempt past this
    hedge_us: Optional[float] = None     # duplicate-read hedge age
    seed: int = 0


class BAMGIndex(_HostIndex):
    """The paper's system: BAMG graph + decoupled layout + nav graph +
    block-first search (Alg. 2/3/4)."""

    kind = "bamg"

    def __init__(self, x, graph: BAMGGraph, codec, codes, store, nav, params):
        self.x, self.graph = x, graph
        self.codec, self.codes, self.store = codec, codes, store
        self.nav = nav
        self.params = params
        self.cost = store.scheduler.cost

    @classmethod
    def build(cls, x: np.ndarray, params: BAMGParams = BAMGParams(),
              device=None):
        dev = resolve_device(device)
        x = to_numpy(x, np.float32)
        p = dataclasses.replace(params)        # configure_io mutates in place
        builder = _builder_for(p, dev)
        nsg_adj, entry = builder.build_nsg(x, r=p.r, l_build=p.l_build,
                                           knn_k=p.knn_k, seed=p.seed)
        capacity = p.capacity or max_capacity_for(p.r)
        blocks = bnf_blocks(nsg_adj, capacity, seed=p.seed)
        if p.use_bmrng_prune:
            graph = builder.refine_bamg(x, nsg_adj, entry, blocks, capacity,
                                        alpha=p.alpha, beta=p.beta,
                                        sibling_edges=p.sibling_edges,
                                        max_degree=p.r)
        else:  # ablation: same layout, no block-aware pruning
            graph = BAMGGraph(adj=nsg_adj, blocks=np.asarray(blocks, np.int32),
                              members=block_members(blocks, capacity),
                              entry=entry, capacity=capacity,
                              alpha=p.alpha, beta=p.beta)
        return cls._finish(x, graph, p, capacity, dev)

    @classmethod
    def from_graph(cls, x: np.ndarray, graph: BAMGGraph,
                   params: BAMGParams = BAMGParams(),
                   device=None) -> "BAMGIndex":
        """Index from an already-built BAMG graph (streaming consolidation:
        the graph comes out of delta-fold + Alg-2 refine, not a fresh
        `build`).  Trains PQ, builds the nav graph, and lays out storage
        exactly as `build` would."""
        return cls._finish(to_numpy(x, np.float32), graph,
                           dataclasses.replace(params), graph.capacity,
                           resolve_device(device))

    @classmethod
    def _finish(cls, x, graph, p, capacity, dev) -> "BAMGIndex":
        """PQ, nav graph and storage of a built graph (`build`'s tail)."""
        codec, codes = _train_codec(x, p.pq_m, p.seed, dev)
        nav = None
        if p.use_nav:
            nav = build_navgraph(x, graph, alpha=p.alpha, beta=p.beta,
                                 gamma=p.gamma, capacity=capacity,
                                 seed=p.seed, device=dev)
        store = _make_decoupled_store(x, graph, nav, p)
        return cls(x, graph, codec, codes, store, nav, p)

    def configure_io(self, cache_policy: Optional[str] = None,
                     vec_cache_policy: Optional[str] = None,
                     cache_blocks: Optional[int] = None,
                     vec_cache_blocks: Optional[int] = None,
                     qd: Optional[int] = None,
                     batch_io: Optional[bool] = None,
                     pin_nav_blocks: Optional[int] = None,
                     faults=_KEEP, fault_seed: Optional[int] = None,
                     retry=_KEEP, timeout_us=_KEEP,
                     hedge_us=_KEEP) -> "BAMGIndex":
        """Rebuild only the storage/scheduler with new I/O knobs (graph, PQ
        codes, and nav graph untouched) -- cheap policy/QD/pinning sweeps."""
        _update_io_params(self.params, dict(
            cache_policy=cache_policy, vec_cache_policy=vec_cache_policy,
            cache_blocks=cache_blocks, vec_cache_blocks=vec_cache_blocks,
            qd=qd, batch_io=batch_io, pin_nav_blocks=pin_nav_blocks,
            fault_seed=fault_seed),
            dict(faults=faults, retry=retry, timeout_us=timeout_us,
                 hedge_us=hedge_us))
        self.store = _make_decoupled_store(self.x, self.graph, self.nav,
                                           self.params)
        self.cost = self.store.scheduler.cost
        return self

    def _pq_dist_fn(self, table: np.ndarray):
        m_sub = table.shape[0]

        def fn(vids: np.ndarray) -> np.ndarray:
            c = self.codes[np.asarray(vids, np.int64)].astype(np.int64)
            return table[np.arange(m_sub)[None, :], c].sum(1)
        return fn

    def entries_for(self, table: np.ndarray, n_entry: int = 4) -> list[int]:
        if self.nav is not None and self.nav.layers:
            seeds, _ = search_nav(self.nav, self._pq_dist_fn(table), n_entry)
            if seeds:
                return seeds
        return [self.graph.entry]

    def search(self, q: np.ndarray, k: int, l: int,
               alpha: Optional[int] = None,
               rerank_margin: Optional[float] = None,
               random_entry_seed: Optional[int] = None,
               max_hops: Optional[int] = None,
               batch_io: Optional[bool] = None,
               drop_cache: bool = True,
               exclude: Optional[set] = None,
               table: Optional[np.ndarray] = None) -> SearchResult:
        q = to_numpy(q, np.float32)
        table = self._table(q, table)
        if random_entry_seed is not None:  # ablation "BAMG w/o NG"
            rng = np.random.default_rng(random_entry_seed)
            entries = rng.choice(len(self.x), size=4, replace=False).tolist()
        else:
            entries = self.entries_for(table)
        a = alpha if alpha is not None else self.params.alpha
        batched = self.params.batch_io if batch_io is None else batch_io
        # batched mode: each pop submits the top-alpha unchecked candidates'
        # graph blocks together (demand + speculative prefetch)
        bs = max(2, a) if batched else None
        return search_bamg(self.store, self.codes, table, q, entries, k, l,
                           alpha=a, rerank_margin=rerank_margin,
                           max_hops=max_hops, batch_submit=bs,
                           drop_cache=drop_cache, exclude=exclude)

    def search_batch(self, queries: np.ndarray, k: int, l: int,
                     gt: Optional[np.ndarray] = None,
                     alpha: Optional[int] = None,
                     rerank_margin: Optional[float] = None,
                     random_entry: bool = False,
                     max_hops: Optional[int] = None,
                     batch_io: Optional[bool] = None,
                     warm_cache: bool = False,
                     exclude: Optional[set] = None,
                     tables: Optional[np.ndarray] = None) -> BatchStats:
        return self._run_batch(
            lambda i, q, t, dc: self.search(
                q, k, l, alpha=alpha, rerank_margin=rerank_margin,
                random_entry_seed=(i if random_entry else None),
                max_hops=max_hops, batch_io=batch_io, drop_cache=dc,
                exclude=exclude, table=t),
            queries, tables, gt, k, warm_cache)

    def batch_arrays(self, n_entry_cands: int = 256) -> dict:
        """Fixed-shape numpy arrays for `serve.BatchedANNEngine` (the
        module-level `batch_arrays`): adjacency as padded (N, R) neighbour
        VIDs (-1 pad), the PQ codes and codebooks, the raw vectors, and
        `entry_cands` -- the finest nav layer's vids (else every vid),
        capped at `n_entry_cands` by even striding."""
        return batch_arrays(self.x, self.graph, self.codes,
                            self.codec.codebooks, self.nav, n_entry_cands)

    def degree_stats(self):
        return degree_stats(self.graph.adj, self.graph.blocks)

    def index_bytes(self) -> int:
        return self.store.graph_bytes + self.store.vector_bytes

    def memory_bytes(self) -> int:
        nav = self.nav.memory_bytes() if self.nav else 0
        return self.codes.nbytes + self._codebook_bytes() + nav

    # --- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """The reference's npz: the same keys, dtypes and nav layout."""
        nav_layers = self.nav.layers if self.nav else []
        blobs = {
            "x": self.x, "adj": self.graph.adj, "blocks": self.graph.blocks,
            "members": self.graph.members,
            "entry": np.asarray(self.graph.entry),
            "capacity": np.asarray(self.graph.capacity),
            "alpha": np.asarray(self.params.alpha),
            "beta": np.asarray(self.params.beta),
            "codebooks": to_numpy(self.codec.codebooks),
            "codes": self.codes,
            "n_nav": np.asarray(len(nav_layers)),
        }
        for i, layer in enumerate(nav_layers):
            blobs[f"nav{i}_vids"] = layer.vids
            blobs[f"nav{i}_adj"] = layer.adj
            blobs[f"nav{i}_entry"] = np.asarray(layer.entry)
        np.savez_compressed(path, **blobs)

    @classmethod
    def load(cls, path: str, device=None) -> "BAMGIndex":
        """An index from a `save` npz (either package's), its codebooks on
        `device` (None: the CUDA device)."""
        dev = resolve_device(device)
        with np.load(path) as z:
            x = z["x"]
            graph = BAMGGraph(adj=z["adj"], blocks=z["blocks"],
                              members=z["members"], entry=int(z["entry"]),
                              capacity=int(z["capacity"]),
                              alpha=int(z["alpha"]), beta=float(z["beta"]))
            codec = PQCodec(codebooks=to_device(z["codebooks"], dev,
                                                torch.float32))
            codes = z["codes"]
            layers = [NavLayer(vids=z[f"nav{i}_vids"], adj=z[f"nav{i}_adj"],
                               entry=int(z[f"nav{i}_entry"]))
                      for i in range(int(z["n_nav"]))]
        params = BAMGParams(alpha=graph.alpha, beta=graph.beta,
                            capacity=graph.capacity)
        nav = NavGraph(layers=layers) if layers else None
        store = _make_decoupled_store(x, graph, nav, params)
        return cls(x, graph, codec, codes, store, nav, params)
