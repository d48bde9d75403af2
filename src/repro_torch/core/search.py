"""Disk-resident ANN search: Algorithm 1 (DiskANN / Starling) and
Algorithm 4 (BAMG block-first), on the I/O simulator (port of
`repro.core.search`).

All pool ordering uses in-memory PQ estimated distances (delta-hat); exact
distances come only from raw vectors fetched from disk, exactly as in the
paper.  Every block fetch is counted by the storage layer.

The per-query walk is a pointer chase over the simulated disk, one query
at a time, and stays on the host in numpy, line for line the reference's:
the PQ estimates are the same numpy expression on the same (M, K) table
(`adc_table[arange(M)[None], codes].sum(1)`), so on the same table every
read, NIO and distance equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .io_sim import READ_FAILED
from .storage import CoupledStorage, DecoupledStorage


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray          # (k,) VIDs
    dists: np.ndarray        # (k,) exact squared distances
    nio: int                 # total block reads for this query
    graph_reads: int
    vector_reads: int
    n_dist: int              # exact distance computations
    n_pq: int                # PQ estimated distance computations
    hops: int                # pool pops (search path length)
    cache_hits: int = 0      # block-cache hits (reads that cost no I/O)
    service_us: float = 0.0  # pipelined I/O service time (qd-overlapped)
    serial_us: float = 0.0   # same demand misses read strictly serially
    # degraded-result contract (fault injection): `degraded` is True iff at
    # least one block this query needed could not be delivered, i.e. the
    # returned top-k may be missing candidates the clean run would have
    # seen.  All other fields stay exact for the reads that did happen.
    degraded: bool = False
    failed_reads: int = 0    # undeliverable blocks skipped by this query
    retries: int = 0         # extra read attempts (transient faults)
    hedges: int = 0          # duplicate reads raced against stragglers
    checksum_failures: int = 0  # torn payloads caught and retried


class _Pool:
    """Fixed-capacity candidate pool sorted ascending by estimated distance."""

    __slots__ = ("cap", "ids", "d", "checked")

    def __init__(self, cap: int):
        self.cap = cap
        self.ids: list[int] = []
        self.d: list[float] = []
        self.checked: list[bool] = []

    def worst(self) -> float:
        return self.d[-1] if len(self.d) >= self.cap else np.inf

    def insert(self, vid: int, dist: float) -> bool:
        if len(self.d) >= self.cap and dist >= self.d[-1]:
            return False
        if vid in self.ids:  # pools are small (l <= few hundred)
            return False
        import bisect
        i = bisect.bisect_right(self.d, dist)
        self.ids.insert(i, vid)
        self.d.insert(i, dist)
        self.checked.insert(i, False)
        if len(self.d) > self.cap:
            self.ids.pop()
            self.d.pop()
            self.checked.pop()
        return True

    def first_unchecked(self) -> int:
        for i, c in enumerate(self.checked):
            if not c:
                return i
        return -1


def _sqd(a: np.ndarray, b: np.ndarray) -> float:
    v = a - b
    return float(np.dot(v, v))


# ---------------------------------------------------------------------------
# Algorithm 1 -- search on a coupled (DiskANN / Starling) layout
# ---------------------------------------------------------------------------
def search_coupled(
    store: CoupledStorage,
    codec_codes: np.ndarray,          # (n, M) uint8 PQ codes (in memory)
    adc_table: np.ndarray,            # (M, K) query ADC table (in memory)
    q: np.ndarray,
    entry: int | Sequence[int],
    k: int,
    l: int,
    block_level: bool = False,        # False = DiskANN, True = Starling
    max_hops: int | None = None,
    batch_submit: int | None = None,  # prefetch width (timing only)
    drop_cache: bool = True,          # False = warm cross-query cache
    exclude: set[int] | frozenset[int] | None = None,  # tombstoned VIDs
) -> SearchResult:
    """Tombstones (`exclude`, streaming freshness): excluded VIDs stay fully
    navigable -- they enter the pool and are beam-expanded like any other
    node so connectivity through deleted points survives -- but they never
    enter the exact-result set, so they cannot appear in the returned top-k.
    """
    store.reset(drop_cache=drop_cache)
    excl = exclude if exclude is not None else ()
    m_sub = adc_table.shape[0]
    n_pq = 0
    n_dist = 0

    def pq_dist(vids: np.ndarray) -> np.ndarray:
        nonlocal n_pq
        n_pq += len(vids)
        c = codec_codes[vids].astype(np.int64)
        return adc_table[np.arange(m_sub)[None, :], c].sum(1)

    pool = _Pool(l)
    entries = [entry] if np.isscalar(entry) else list(entry)
    ed = pq_dist(np.asarray(entries, np.int64))
    for v, dv in zip(entries, ed.tolist()):
        pool.insert(int(v), dv)

    results: dict[int, float] = {}
    hops = 0
    failed_blocks = 0
    while True:
        i = pool.first_unchecked()
        if i < 0 or (max_hops is not None and hops >= max_hops):
            break
        v = pool.ids[i]
        pool.checked[i] = True
        hops += 1
        pf: list[int] = []
        if batch_submit is not None and batch_submit > 1:
            pf = _prefetch_hints(pool, i, batch_submit - 1,
                                 lambda u: store.block_of(u),
                                 exclude={store.block_of(v)})
        rec = store.read_node_block(v, prefetch=pf)
        if rec is READ_FAILED:
            # degraded mode: the candidate's block is unreadable -- skip it
            # (it stays checked) and keep expanding the rest of the pool
            failed_blocks += 1
            continue
        if block_level:
            # Starling: evaluate every node of the fetched block (free once
            # the block is resident): exact distances for residents, and
            # PQ-insert each resident + its neighbors into the pool.
            mask = rec.vids >= 0
            vids = rec.vids[mask]
            for s, vv in enumerate(vids.tolist()):
                if vv not in results and vv not in excl:
                    results[vv] = _sqd(rec.vecs[mask][s], q)
                    n_dist += 1
            nbrs = rec.nbrs[mask]
            cand = np.unique(nbrs[nbrs >= 0])
            cand = np.concatenate([vids.astype(np.int64), cand.astype(np.int64)])
        else:
            s = store.slot_in_block(v)
            if v not in results and v not in excl:
                results[v] = _sqd(rec.vecs[s], q)
                n_dist += 1
            nn = rec.nbrs[s]
            cand = nn[nn >= 0].astype(np.int64)
        if len(cand):
            cand = np.unique(cand)
            dd = pq_dist(cand)
            w = pool.worst()
            for u, du in zip(cand.tolist(), dd.tolist()):
                if du < w:
                    pool.insert(int(u), du)
                    w = pool.worst()

    ids = np.fromiter(results.keys(), np.int64, len(results))
    ds = np.fromiter(results.values(), np.float64, len(results))
    o = np.argsort(ds, kind="stable")[:k]
    st = store.device.stats
    sch = store.scheduler
    return SearchResult(
        ids=ids[o], dists=ds[o], nio=st.nio, graph_reads=st.graph_reads,
        vector_reads=st.vector_reads, n_dist=n_dist, n_pq=n_pq, hops=hops,
        cache_hits=st.cache_hits, service_us=sch.service_us,
        serial_us=sch.serial_us, degraded=failed_blocks > 0,
        failed_reads=failed_blocks, retries=st.retries, hedges=st.hedges,
        checksum_failures=st.checksum_failures)


def _prefetch_hints(pool: "_Pool", popped_i: int, width: int,
                    block_of, exclude: set) -> list[int]:
    """Blocks of the next `width` unchecked pool candidates (after the one
    just popped) -- speculative hints for the same batched submission.

    Timing-domain only: the scheduler never lets these touch the cache or
    the NIO counters, so the search trajectory is bit-identical to the
    per-read path.
    """
    hints: list[int] = []
    seen = set(exclude)
    for j in range(len(pool.ids)):
        if len(hints) >= width:
            break
        if j == popped_i or pool.checked[j]:
            continue
        b = block_of(pool.ids[j])
        if b not in seen:
            seen.add(b)
            hints.append(b)
    return hints


# ---------------------------------------------------------------------------
# Algorithm 4 -- block-first search on the BAMG decoupled layout
# ---------------------------------------------------------------------------
def search_bamg(
    store: DecoupledStorage,
    codec_codes: np.ndarray,
    adc_table: np.ndarray,
    q: np.ndarray,
    entries: Sequence[int],
    k: int,
    l: int,
    alpha: int,
    rerank: int | None = None,
    rerank_margin: float | None = None,
    max_hops: int | None = None,
    batch_submit: int | None = None,
    drop_cache: bool = True,
    exclude: set[int] | frozenset[int] | None = None,
) -> SearchResult:
    """Algorithm 4: pool by PQ distance; each pop loads one graph block and
    runs a bounded (depth alpha) intra-block BFS; final phase loads raw
    vectors of the pool and re-ranks exactly.

    `rerank_margin` (beyond-paper, §Perf): early-stop the refinement scan --
    candidates are read in ascending PQ order, and once k exact distances
    are known, stop when the next PQ estimate exceeds margin * (current k-th
    exact distance).  None = paper-faithful (read all l candidates).

    `batch_submit` (beyond-paper, pipelined I/O): each pool pop submits the
    demand graph block together with the blocks of the next
    ``batch_submit - 1`` unchecked candidates as one batched submission
    (speculative, timing-domain only), and the re-rank phase submits all its
    vector-block reads at once.  Results, NIO, and cache behavior are
    bit-identical to the per-read path; only the modeled service time
    changes (see io_sim.IOScheduler).  `drop_cache=False` keeps the block
    cache warm across queries (`warm_cache` serving mode).

    Degraded-result contract (fault injection): blocks that cannot be
    delivered after retries are skipped -- the beam keeps walking, the
    re-rank drops the affected candidates, and the result carries
    ``degraded=True`` with ``failed_reads`` counting the skips.  The query
    never crashes on an unreadable block.

    Tombstones (`exclude`, streaming freshness): excluded VIDs stay fully
    navigable -- the beam walks through them so the monotonic-path property
    survives deletes -- but they are dropped before the refinement phase:
    their vectors are never read and they never enter the exact top-k.
    """
    store.reset(drop_cache=drop_cache)
    excl = exclude if exclude is not None else ()
    m_sub = adc_table.shape[0]
    n_pq = 0
    n_dist = 0

    def pq_dist(vids: np.ndarray) -> np.ndarray:
        nonlocal n_pq
        n_pq += len(vids)
        c = codec_codes[vids].astype(np.int64)
        return adc_table[np.arange(m_sub)[None, :], c].sum(1)

    pool = _Pool(l)
    ed = pq_dist(np.asarray(list(entries), np.int64))
    for v, dv in zip(entries, ed.tolist()):
        pool.insert(int(v), dv)

    explored: set[int] = set()     # nodes already BFS-expanded (per query)
    hops = 0
    failed_blocks = 0
    while True:
        i = pool.first_unchecked()
        if i < 0 or (max_hops is not None and hops >= max_hops):
            break
        v = pool.ids[i]
        pool.checked[i] = True
        if v in explored:
            continue
        hops += 1
        oid_v = int(store.vid2oid[v])
        gb = store.gblock_of_oid(oid_v)
        pf: list[int] = []
        if batch_submit is not None and batch_submit > 1:
            pf = _prefetch_hints(
                pool, i, batch_submit - 1,
                lambda u: store.gblock_of_oid(int(store.vid2oid[u])),
                exclude={gb})
        blk = store.read_graph_block(gb, prefetch=pf)
        if blk is READ_FAILED:
            # degraded mode: skip the unreadable block, keep walking from
            # the remaining pool candidates (v stays checked)
            failed_blocks += 1
            explored.add(v)
            continue
        _search_within_block(store, blk, gb, v, pool, pq_dist, explored, alpha)

    # refinement: load raw vectors for pool candidates, exact re-rank.
    # Under fault injection a candidate whose vector block is unreadable is
    # dropped (None from the storage layer) -- partial top-k, never a crash.
    # Tombstoned candidates are masked here: no vector read, no result slot.
    live_ids = [vv for vv in pool.ids if vv not in excl]
    live_d = [dv for vv, dv in zip(pool.ids, pool.d) if vv not in excl]
    n_rerank = len(live_ids) if rerank is None else min(rerank, len(live_ids))
    exact: dict[int, float] = {}
    failed_vecs = 0
    if rerank_margin is None:
        # paper-faithful: all candidates, read in OID order for contiguity;
        # in batched mode the whole read set goes down as one submission
        cand = sorted(live_ids[:n_rerank], key=lambda vv: int(store.vid2oid[vv]))
        vecs = store.read_vectors([int(store.vid2oid[vv]) for vv in cand],
                                  batched=batch_submit is not None)
        for vv, vec in zip(cand, vecs):
            if vec is None:
                failed_vecs += 1
                continue
            exact[vv] = _sqd(vec, q)
            n_dist += 1
    else:
        # beyond-paper early stop: ascending PQ order + adaptive cutoff
        import heapq
        worst_k: list[float] = []  # max-heap (negated) of best k exact dists
        for vv, dpq in zip(live_ids[:n_rerank], live_d[:n_rerank]):
            if len(worst_k) >= k and dpq > rerank_margin * (-worst_k[0]):
                break
            vec = store.read_vector(int(store.vid2oid[vv]))
            if vec is None:
                failed_vecs += 1
                continue
            dex = _sqd(vec, q)
            exact[vv] = dex
            n_dist += 1
            if len(worst_k) < k:
                heapq.heappush(worst_k, -dex)
            elif dex < -worst_k[0]:
                heapq.heapreplace(worst_k, -dex)
    ids = np.fromiter(exact.keys(), np.int64, len(exact))
    ds = np.fromiter(exact.values(), np.float64, len(exact))
    o = np.argsort(ds, kind="stable")[:k]
    gs = store.graph_dev.stats
    vs = store.vector_dev.stats
    sch = store.scheduler
    n_failed = failed_blocks + failed_vecs
    return SearchResult(
        ids=ids[o], dists=ds[o], nio=gs.nio + vs.nio, graph_reads=gs.graph_reads,
        vector_reads=vs.vector_reads, n_dist=n_dist, n_pq=n_pq, hops=hops,
        cache_hits=gs.cache_hits + vs.cache_hits,
        service_us=sch.service_us, serial_us=sch.serial_us,
        degraded=n_failed > 0, failed_reads=n_failed,
        retries=gs.retries + vs.retries, hedges=gs.hedges + vs.hedges,
        checksum_failures=gs.checksum_failures + vs.checksum_failures)


def _search_within_block(store, blk, gb, v, pool, pq_dist, explored, alpha):
    """Bounded intra-block BFS (Alg. 4 lines 9-20) over the resident block.

    Frontier expansion is depth-limited by alpha; every touched node's
    neighbors are PQ-inserted into the pool; only intra-block neighbors that
    improve on the best-seen estimate are expanded further.
    """
    c = store.capacity
    oid_lookup = {int(o): s for s, o in enumerate(blk.oids.tolist()) if o >= 0}
    slot_v = int(store.vid2oid[v]) - gb * c
    dmin = float(pq_dist(np.asarray([v], np.int64))[0])
    frontier = [slot_v]
    explored.add(v)
    depth = 0
    while frontier and depth < alpha:
        nxt: list[int] = []
        for s in frontier:
            nn = blk.nbrs[s]
            nn = nn[nn >= 0]
            if len(nn) == 0:
                continue
            nbr_vids = store.oid2vid[nn].astype(np.int64)
            dd = pq_dist(nbr_vids)
            w = pool.worst()
            for u_oid, u_vid, du in zip(nn.tolist(), nbr_vids.tolist(), dd.tolist()):
                if du < w:
                    if pool.insert(int(u_vid), float(du)):
                        w = pool.worst()
                ub = u_oid // c
                if ub == gb and u_vid not in explored and du < dmin:
                    dmin = du
                    nxt.append(oid_lookup[u_oid])
                    explored.add(int(u_vid))
                    # mark resident nodes as checked in the pool: their block
                    # is already in memory, no further I/O needed for them
                    if int(u_vid) in pool.ids:
                        pool.checked[pool.ids.index(int(u_vid))] = True
        frontier = nxt
        depth += 1
