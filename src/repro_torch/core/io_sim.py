"""Byte-accurate block-device simulator: pluggable caches, exact NIO, and a
pipelined I/O scheduler (port of `repro.core.io_sim`; pure Python and the
standard library, held by `tests/test_torch_io_sim.py` to the reference's
accounting, cache order and times on the same reads).

There is no SSD under test; the paper's primary I/O metric (NIO = blocks
read per query) is *exact* under simulation, and QPS is reported through a
calibrated cost model.  All three compared systems (DiskANN, Starling-style,
BAMG) run on this one simulator, so NIO comparisons are apples-to-apples.

Two orthogonal metric domains (never mixed):

* **Accounting** (`IOStats`): NIO = blocks transferred from the device, plus
  cache hits.  Exact, deterministic, independent of queue depth or
  speculation.  This is the paper's headline number and the one every
  benchmark keys on; nothing in the timing domain may change it.
* **Timing** (`IOScheduler` + `CostModel`): simulated wall-clock.  A batched
  submission of b outstanding reads at queue depth `qd` (the io_uring-style
  knob) completes in ``ceil(b / qd) * read_us`` -- overlapped, not serial.
  The scheduler reports both `service_us` (pipelined) and `serial_us` (the
  strictly sequential cost of the same demand misses), so speedup is
  directly readable.  Speculative prefetches only fill otherwise-idle queue
  slots of a demand submission, so they can never make the pipelined time
  exceed the serial baseline, and they *never* touch the cache or the NIO
  counters -- when the speculation is right, the later demand read is free
  in the timing domain yet still counted as one NIO.

Cache policies (`CachePolicy`): `lru`, `fifo`, `clock` (second chance),
`2q` (A1in FIFO + A1out ghost + Am LRU), plus `PinnedCache`, a wrapper that
pins a fixed set of blocks (e.g. the navigation-graph entry blocks,
Starling-style) in memory forever; pins count against capacity.

Cost model (defaults match the paper's hardware: SATA SSD, 4 KB reads):
  t_query = NIO * t_read + t_cpu          (serial, qd=1)
  t_read  ~ 100 us per 4 KB random read (SATA SSD)

Resilience (beyond-paper; `utils.faults`): a `BlockDevice` may carry a
seeded deterministic `FaultPlan` injecting read errors, dead blocks, torn
payloads, and latency spikes.  The scheduler then resolves every demand
miss through a *resilient read*: per-block CRC32 checksums catch torn
transfers, a bounded `RetryPolicy` (exponential backoff + jitter) retries
transient failures, `CostModel.timeout_us` abandons straggling attempts,
and `CostModel.hedge_us` races a duplicate (hedged) read against a spiking
one.  Accounting separation is preserved exactly: NIO still counts only
*successful* payload deliveries; wasted attempts land in the new `IOStats`
counters (`retries`, `read_errors`, `timeouts`, `checksum_failures`,
`hedges`, `hedge_wins`, `failed_reads`) and their time in the timing
domain.  With a zero-rate plan (or no plan) the resilient path is
bit-identical to the plain one -- same NIO, same cache state, same service
time (property-tested in tests/test_faults.py).  A block whose retry
budget is exhausted (or that is persistently dead) yields the
`READ_FAILED` sentinel instead of raising, so readers can degrade
(skip-and-continue) rather than crash.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable, Optional, Sequence

from ..utils.faults import (FaultPlan, RetryPolicy, corrupt_payload,
                            payload_checksum)

BLOCK_SIZE = 4096  # OS page / logical disk block

# Returned (never raised) for a block whose resilient read exhausted its
# retry budget or hit a persistently dead block: readers degrade, not crash.
READ_FAILED = object()

# Dedicated miss marker: a cached payload may legitimately be None (e.g. the
# placeholder span blocks of oversized coupled records), so None cannot mean
# "not cached".
_MISS = object()


@dataclasses.dataclass
class IOStats:
    """Per-query (or per-run) I/O accounting."""

    graph_reads: int = 0    # graph-index block fetches
    vector_reads: int = 0   # raw-vector block fetches (BAMG decoupled layout)
    cache_hits: int = 0
    # resilience counters (fault injection; all stay 0 on the clean path).
    # None of these enter `nio`: NIO counts only successful deliveries.
    retries: int = 0            # extra attempts beyond the first
    read_errors: int = 0        # attempts that failed outright
    timeouts: int = 0           # attempts abandoned at CostModel.timeout_us
    checksum_failures: int = 0  # torn payloads caught by the block checksum
    hedges: int = 0             # duplicate reads issued against stragglers
    hedge_wins: int = 0         # hedges that completed before the original
    failed_reads: int = 0       # reads that exhausted the retry budget

    @property
    def nio(self) -> int:
        """The paper's NIO: total data-block reads (graph + vector)."""
        return self.graph_reads + self.vector_reads

    @property
    def total_accesses(self) -> int:
        """Every read() call: device reads (misses) + cache hits."""
        return self.nio + self.cache_hits

    @property
    def hit_rate(self) -> float:
        t = self.total_accesses
        return self.cache_hits / t if t else 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def add(self, other: "IOStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


# ---------------------------------------------------------------------------
# Cache policies
# ---------------------------------------------------------------------------
class CachePolicy:
    """Block-cache replacement policy.

    Contract: `get` returns the payload (updating recency state) or `_MISS`;
    `put` inserts after a miss, evicting per policy; `contains` is a pure
    lookup with NO side effects on recency (used by the scheduler to cost a
    submission without perturbing replacement order); `len(policy)` is the
    resident-block count and never exceeds `capacity`.
    """

    name = "base"

    def __init__(self, capacity: int):
        self.capacity = int(capacity)

    def get(self, key: int):
        raise NotImplementedError

    def put(self, key: int, value) -> None:
        raise NotImplementedError

    def contains(self, key: int) -> bool:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def keys(self) -> list:
        """Resident block ids (diagnostics / property tests)."""
        raise NotImplementedError


class LRUCache(CachePolicy):
    """Evicts the least-recently-used block; hits refresh recency."""

    name = "lru"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._d: OrderedDict[int, object] = OrderedDict()

    def get(self, key: int):
        v = self._d.pop(key, _MISS)
        if v is _MISS:
            return _MISS
        self._d[key] = v  # most-recent position
        return v

    def put(self, key: int, value) -> None:
        if self.capacity <= 0:
            return
        if key in self._d:
            self._d.pop(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def contains(self, key: int) -> bool:
        return key in self._d

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def keys(self) -> list:
        return list(self._d.keys())


class FIFOCache(CachePolicy):
    """Evicts in insertion order; hits do not refresh."""

    name = "fifo"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._d: OrderedDict[int, object] = OrderedDict()

    def get(self, key: int):
        return self._d.get(key, _MISS)

    def put(self, key: int, value) -> None:
        if self.capacity <= 0:
            return
        if key in self._d:      # refresh payload, keep insertion position
            self._d[key] = value
            return
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def contains(self, key: int) -> bool:
        return key in self._d

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def keys(self) -> list:
        return list(self._d.keys())


class ClockCache(CachePolicy):
    """CLOCK / second-chance: a circular buffer with one reference bit per
    resident block; the hand skips (and clears) referenced blocks."""

    name = "clock"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._d: dict[int, object] = {}
        self._ref: dict[int, bool] = {}
        self._ring: list[int] = []
        self._hand = 0

    def get(self, key: int):
        v = self._d.get(key, _MISS)
        if v is not _MISS:
            self._ref[key] = True
        return v

    def put(self, key: int, value) -> None:
        if self.capacity <= 0:
            return
        if key in self._d:
            self._d[key] = value
            self._ref[key] = True
            return
        if len(self._d) >= self.capacity:
            while True:
                k = self._ring[self._hand]
                if self._ref.get(k, False):
                    self._ref[k] = False
                    self._hand = (self._hand + 1) % len(self._ring)
                else:
                    del self._d[k]
                    del self._ref[k]
                    self._ring[self._hand] = key
                    self._hand = (self._hand + 1) % len(self._ring)
                    break
        else:
            self._ring.append(key)
        self._d[key] = value
        self._ref[key] = False  # newly inserted: one full sweep to earn a ref

    def contains(self, key: int) -> bool:
        return key in self._d

    def clear(self) -> None:
        self._d.clear()
        self._ref.clear()
        self._ring.clear()
        self._hand = 0

    def __len__(self) -> int:
        return len(self._d)

    def keys(self) -> list:
        return list(self._d.keys())


class TwoQCache(CachePolicy):
    """Simplified full-2Q: A1in (FIFO, ~25% of capacity) admits first-touch
    blocks; blocks evicted from A1in leave their id in the A1out ghost list
    (no payload, ~50% of capacity in ids); a miss whose id is ghosted is
    promoted into Am (LRU).  Scan-resistant: one-shot blocks die in A1in
    without disturbing the hot Am set."""

    name = "2q"

    def __init__(self, capacity: int, kin: float = 0.25, kout: float = 0.5):
        super().__init__(capacity)
        self._kin = max(1, int(round(capacity * kin))) if capacity > 0 else 0
        self._kout = max(1, int(round(capacity * kout))) if capacity > 0 else 0
        self._a1in: OrderedDict[int, object] = OrderedDict()
        self._a1out: OrderedDict[int, None] = OrderedDict()  # ghost ids only
        self._am: OrderedDict[int, object] = OrderedDict()

    def get(self, key: int):
        if key in self._am:
            v = self._am.pop(key)
            self._am[key] = v
            return v
        return self._a1in.get(key, _MISS)  # A1in hits keep FIFO position

    def put(self, key: int, value) -> None:
        if self.capacity <= 0:
            return
        if key in self._am:
            self._am.pop(key)
            self._am[key] = value
            return
        if key in self._a1in:
            self._a1in[key] = value
            return
        if key in self._a1out:               # reused after probation: hot
            self._a1out.pop(key)
            self._am[key] = value
        else:
            self._a1in[key] = value
        self._shrink()

    def _shrink(self) -> None:
        # Reclaim on demand (canonical 2Q): free slots mean no eviction;
        # under pressure, A1in over its target share yields the victim
        # (demoted to the A1out ghost), otherwise the coldest Am page goes.
        while len(self._a1in) + len(self._am) > self.capacity:
            if self._a1in and (len(self._a1in) > self._kin or not self._am):
                k, _ = self._a1in.popitem(last=False)
                self._a1out[k] = None
                while len(self._a1out) > self._kout:
                    self._a1out.popitem(last=False)
            else:
                self._am.popitem(last=False)

    def contains(self, key: int) -> bool:
        return key in self._am or key in self._a1in

    def clear(self) -> None:
        self._a1in.clear()
        self._a1out.clear()
        self._am.clear()

    def __len__(self) -> int:
        return len(self._a1in) + len(self._am)

    def keys(self) -> list:
        return list(self._a1in.keys()) + list(self._am.keys())


class PinnedCache(CachePolicy):
    """Wrapper pinning a fixed block set in memory forever (Starling-style
    in-memory navigation pinning).  Pins count against `capacity`; the
    remainder backs an inner policy for unpinned blocks.  Pinned payloads
    are loaded at device construction / reset (startup cost, amortized
    across queries -- not counted in per-query NIO)."""

    name = "pinned"

    def __init__(self, capacity: int, pins: Iterable[int],
                 inner: str | CachePolicy = "lru"):
        super().__init__(capacity)
        self.pins = frozenset(int(p) for p in pins)
        if len(self.pins) > capacity:
            raise ValueError(
                f"{len(self.pins)} pinned blocks exceed cache capacity "
                f"{capacity}")
        if isinstance(inner, CachePolicy):
            # rebuild at the clamped capacity so pins + inner residency never
            # exceed the total; mutating .capacity in place would leave
            # capacity-derived internals (2Q shares, CLOCK ring) stale
            self.inner = type(inner)(min(inner.capacity,
                                         max(0, capacity - len(self.pins))))
        else:
            self.inner = make_policy(inner, capacity - len(self.pins))
        self._pinned: dict[int, object] = {}

    def get(self, key: int):
        if key in self._pinned:
            return self._pinned[key]
        return self.inner.get(key)

    def put(self, key: int, value) -> None:
        if key in self.pins:
            self._pinned[key] = value
        else:
            self.inner.put(key, value)

    def contains(self, key: int) -> bool:
        return key in self._pinned or self.inner.contains(key)

    def clear(self) -> None:
        self._pinned.clear()
        self.inner.clear()

    def __len__(self) -> int:
        return len(self._pinned) + len(self.inner)

    def keys(self) -> list:
        return list(self._pinned.keys()) + self.inner.keys()


_POLICIES = {"lru": LRUCache, "fifo": FIFOCache, "clock": ClockCache,
             "2q": TwoQCache}


def make_policy(spec: str | CachePolicy, capacity: int,
                pins: Iterable[int] = ()) -> CachePolicy:
    """Instantiate a policy from its name ('lru'|'fifo'|'clock'|'2q'); any
    non-empty `pins` wraps it in a PinnedCache at the same total capacity."""
    pins = tuple(pins)
    if isinstance(spec, CachePolicy):
        return PinnedCache(capacity, pins, inner=spec) if pins else spec
    if spec.lower() not in _POLICIES:
        raise ValueError(f"unknown cache policy {spec!r}; "
                         f"choose from {sorted(_POLICIES)}")
    if pins:   # PinnedCache sizes the inner share (capacity - len(pins))
        return PinnedCache(capacity, pins, inner=spec.lower())
    return _POLICIES[spec.lower()](capacity)


# ---------------------------------------------------------------------------
# Block device
# ---------------------------------------------------------------------------
class BlockDevice:
    """A fixed-block-size device: a list of payload blocks + a pluggable
    block cache.

    `blocks` holds the serialized payload of each block (bytes or any
    immutable object whose serialized size is <= block_size; serialization
    size is validated by the storage layer, not here).  Reads go through a
    `CachePolicy` of `cache_blocks` entries; a miss costs one I/O.  `pinned`
    block ids are preloaded at construction and at every cache-dropping
    reset, and are never evicted (their load is startup cost, not NIO).

    `faults` attaches a seeded `FaultPlan`; fault resolution (retry,
    checksum verification, hedging) happens in `IOScheduler.submit` -- the
    plain `read` keeps its exact pre-fault contract and is what the
    scheduler calls to commit a verified delivery.  Block checksums are
    computed lazily per block (`checksum`/`verify`) so the no-fault path
    pays nothing.
    """

    def __init__(self, blocks: list, block_size: int = BLOCK_SIZE,
                 cache_blocks: int = 128, kind: str = "graph",
                 policy: str | CachePolicy = "lru",
                 pinned: Iterable[int] = (),
                 faults: Optional[FaultPlan] = None):
        self.blocks = blocks
        self.block_size = block_size
        self.kind = kind
        self.cache_blocks = cache_blocks
        self.faults = faults
        self._sums: dict[int, int] = {}
        self.pinned = tuple(sorted({int(p) for p in pinned}))
        for p in self.pinned:
            if p < 0 or p >= len(blocks):
                raise IndexError(f"pinned block {p} out of range")
        self.policy = make_policy(policy, cache_blocks, pins=self.pinned)
        self.stats = IOStats()
        self._preload_pins()

    def _preload_pins(self) -> None:
        for p in self.pinned:
            self.policy.put(p, self.blocks[p])

    def __len__(self) -> int:
        return len(self.blocks)

    @property
    def total_bytes(self) -> int:
        return len(self.blocks) * self.block_size

    def reset(self, drop_cache: bool = True) -> None:
        self.stats.reset()
        if drop_cache:
            self.policy.clear()
            self._preload_pins()

    def cached(self, block_id: int) -> bool:
        """Pure residency probe -- no recency side effects."""
        return self.policy.contains(block_id)

    def read(self, block_id: int):
        """Fetch one block; counts an I/O on cache miss."""
        if block_id < 0 or block_id >= len(self.blocks):
            raise IndexError(f"block {block_id} out of range [0,{len(self.blocks)})")
        hit = self.policy.get(block_id)
        if hit is not _MISS:
            self.stats.cache_hits += 1
            return hit
        payload = self.blocks[block_id]
        if self.kind == "graph":
            self.stats.graph_reads += 1
        else:
            self.stats.vector_reads += 1
        self.policy.put(block_id, payload)
        return payload

    def read_range(self, start: int, count: int) -> list:
        """Sequential multi-block read (each block still counted)."""
        return [self.read(b) for b in range(start, start + count)]

    # --- checksums + fault hooks (resilient reads; see IOScheduler) --------
    def checksum(self, block_id: int) -> int:
        """CRC32 of the block's true payload (memoized)."""
        s = self._sums.get(block_id)
        if s is None:
            s = payload_checksum(self.blocks[block_id])
            self._sums[block_id] = s
        return s

    def verify(self, block_id: int, payload=None) -> bool:
        """Does `payload` (default: the stored payload) match the block's
        recorded checksum?"""
        p = self.blocks[block_id] if payload is None else payload
        return payload_checksum(p) == self.checksum(block_id)

    def attempt_payload(self, block_id: int, corrupt: bool, salt: int = 0):
        """The payload one device transfer would deliver: the true payload,
        or (for a torn transfer) a deterministically perturbed copy.  Pure
        -- no accounting, no cache effects."""
        p = self.blocks[block_id]
        return corrupt_payload(p, salt) if corrupt else p


# ---------------------------------------------------------------------------
# Cost model + pipelined scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CostModel:
    """Calibrated wall-clock model for simulated QPS.

    Defaults approximate the paper's testbed (SATA SSD, o_direct 4 KB reads,
    8 search threads).  We report NIO (exact) as the primary metric and
    simulated QPS / service time as the derived ones.

    `qd` is the io_uring-style queue-depth knob: a batched submission of b
    reads completes in ceil(b/qd) serial read-times (plus `submit_us`
    syscall overhead per non-empty submission).  qd=1, submit_us=0
    reproduces the strictly serial model exactly.
    """

    read_us: float = 100.0      # per random 4 KB read
    dist_us: float = 0.05       # per full-precision distance computation
    pq_dist_us: float = 0.005   # per PQ ADC distance estimate
    threads: int = 8
    qd: int = 1                 # queue depth for batched submissions
    submit_us: float = 0.0      # per-submission overhead (io_uring ~1-2 us)
    # deadline accounting (fault injection; None disables either knob):
    timeout_us: Optional[float] = None  # abandon an attempt past this, retry
    hedge_us: Optional[float] = None    # issue a duplicate read at this age

    def submission_us(self, n_reads: int) -> float:
        """Service time of one batched submission of `n_reads` device reads."""
        if n_reads <= 0:
            return 0.0
        qd = max(1, int(self.qd))
        return -(-n_reads // qd) * self.read_us + self.submit_us

    def query_time_us(self, nio: int, n_dist: int, n_pq: int) -> float:
        return nio * self.read_us + n_dist * self.dist_us + n_pq * self.pq_dist_us

    def qps(self, nio: float, n_dist: float, n_pq: float) -> float:
        t = self.query_time_us(nio, n_dist, n_pq)
        return 1e6 * self.threads / max(t, 1e-9)

    def qps_from_io_us(self, io_us: float, n_dist: float, n_pq: float) -> float:
        """QPS when the I/O portion took `io_us` (e.g. pipelined service)."""
        t = io_us + n_dist * self.dist_us + n_pq * self.pq_dist_us
        return 1e6 * self.threads / max(t, 1e-9)


class IOScheduler:
    """Batched-submission front end over one or more `BlockDevice`s.

    The search layer hands the scheduler a *demand* list (blocks whose
    payloads it needs now) plus optional *prefetch* hints (blocks it guesses
    it will need next).  Demand reads go straight through `BlockDevice.read`
    -- cache behavior and NIO are bit-identical to issuing the reads one by
    one.  Prefetch hints are timing-domain only: they ride along in the
    queue slots the demand misses leave idle in the submission's last qd
    wave (so admitting them is free -- `service_us <= serial_us` is an
    invariant), and they are remembered so that a later demand read of a
    prefetched block costs zero *service* time while still counting one
    NIO.  At qd=1 there are never idle slots: no speculation, and batched
    timing degenerates exactly to the serial model.

    Accumulates per-reset:
      service_us -- pipelined wall-clock of all submissions (qd-overlapped)
      serial_us  -- what the same demand misses would cost strictly
                    serially, one submission each (so `submit_us` overhead
                    is charged per miss there vs once per batch here --
                    service_us <= serial_us holds for any submit_us >= 0)
      submissions / demand_reads / prefetches / prefetch_hits -- diagnostics
    """

    def __init__(self, cost: Optional[CostModel] = None,
                 retry: Optional[RetryPolicy] = None):
        self.cost = cost if cost is not None else CostModel()
        self.retry = retry if retry is not None else RetryPolicy()
        self.service_us = 0.0
        self.serial_us = 0.0
        self.submissions = 0
        self.demand_reads = 0
        self.prefetches = 0
        self.prefetch_hits = 0
        self._inflight: set[tuple[int, int]] = set()

    def reset(self) -> None:
        self.service_us = 0.0
        self.serial_us = 0.0
        self.submissions = 0
        self.demand_reads = 0
        self.prefetches = 0
        self.prefetch_hits = 0
        self._inflight.clear()

    def read(self, dev: BlockDevice, block_id: int):
        """Single demand read == submit([block_id])."""
        return self.submit(dev, [block_id])[0]

    def submit(self, dev: BlockDevice, block_ids: Sequence[int],
               prefetch: Sequence[int] = ()) -> list:
        """One batched submission; returns payloads for `block_ids` in order.

        Accounting (NIO, cache state) is exactly what serial per-block
        `dev.read` calls would produce; only the timing differs.

        When `dev.faults` is set, every demand miss runs the resilient read
        loop (checksum verify, bounded retry with backoff, timeout, hedging
        -- see `_read_resilient`); a block that cannot be delivered yields
        the `READ_FAILED` sentinel in its slot instead of raising.  Wasted
        attempts are charged as straggler time (they never overlap in the
        qd pipeline) and counted in the device's `IOStats` resilience
        fields; NIO and cache state still reflect only verified deliveries.
        """
        new_reads = 0
        payloads = []
        demand_set = set(int(b) for b in block_ids)
        for b in block_ids:
            b = int(b)
            key = (id(dev), b)
            was_cached = dev.cached(b)
            if was_cached or dev.faults is None:
                payload, ok, extra_us = dev.read(b), True, 0.0
            else:
                payload, ok, extra_us = self._read_resilient(dev, b)
            payloads.append(payload)
            if extra_us:
                # retries/backoff/spikes are stragglers: they serialize in
                # both timing views, preserving service_us <= serial_us
                self.service_us += extra_us
                self.serial_us += extra_us
            if was_cached:
                continue
            if not ok:
                # nothing was delivered: no NIO, no queue slot occupied;
                # the wasted attempts were charged above
                self._inflight.discard(key)
                continue
            self.demand_reads += 1
            # serial baseline: every miss is its own one-read submission
            self.serial_us += self.cost.read_us + self.cost.submit_us
            if key in self._inflight:
                # speculatively fetched earlier: overlapped, free *in time*;
                # the dev.read above still counted one NIO (data really moved)
                self._inflight.discard(key)
                self.prefetch_hits += 1
            else:
                new_reads += 1
        # speculation may only fill the idle queue slots of the demand
        # misses' last qd wave -- free in the timing domain, so the
        # pipelined service can never exceed the serial baseline
        qd = max(1, int(self.cost.qd))
        spec_budget = (-new_reads) % qd if new_reads else 0
        n_spec = 0
        for b in prefetch:
            if n_spec >= spec_budget:
                break
            b = int(b)
            if b < 0 or b >= len(dev.blocks) or b in demand_set:
                continue
            key = (id(dev), b)
            if dev.cached(b) or key in self._inflight:
                continue
            self._inflight.add(key)
            n_spec += 1
        self.prefetches += n_spec
        if new_reads:
            self.service_us += self.cost.submission_us(new_reads)
            self.submissions += 1
        return payloads

    # --- resilient read (fault-injected devices only) ----------------------
    _HEDGE_STREAM = 1 << 20  # attempt-index offset for hedge outcome draws

    def _read_resilient(self, dev: BlockDevice, b: int):
        """Resolve one demand miss under `dev.faults`.

        Returns ``(payload, ok, extra_us)``.  `extra_us` is the straggler
        time beyond the one base `read_us` the pipelined submission term
        charges for a successful miss: wasted attempts (errors, timeouts,
        torn transfers), backoff waits, and the hedge-capped remainder of a
        latency spike.  On success the delivery is committed through the
        plain `dev.read` (one NIO + cache fill), keeping accounting
        identical to the clean path; on failure nothing touches the cache
        or the NIO counters and `READ_FAILED` is returned.

        With a zero-rate plan every attempt resolves clean with no spike,
        so extra_us == 0 and the path is bit-identical to `dev.read`.
        """
        plan, cost, rp, st = dev.faults, self.cost, self.retry, dev.stats
        extra = 0.0

        def backoff(attempt: int) -> float:
            if attempt >= rp.budget:
                return 0.0  # budget exhausted: no further wait
            st.retries += 1
            return rp.backoff(attempt, plan.jitter(dev.kind, b, attempt))

        for attempt in range(rp.budget + 1):
            out = plan.outcome(dev.kind, b, attempt)
            if out.error:
                st.read_errors += 1
                extra += cost.read_us + backoff(attempt)
                continue
            # data transferred; resolve its latency (spike, hedge, timeout)
            lat = cost.read_us + out.spike_us
            corrupt = out.corrupt
            salt_attempt = attempt
            if cost.hedge_us is not None and lat > cost.hedge_us + cost.read_us:
                st.hedges += 1
                hout = plan.outcome(dev.kind, b, self._HEDGE_STREAM + attempt)
                if not hout.error:
                    hlat = cost.hedge_us + cost.read_us + hout.spike_us
                    if hlat < lat:   # the duplicate read wins the race
                        st.hedge_wins += 1
                        lat = hlat
                        corrupt = hout.corrupt
                        salt_attempt = self._HEDGE_STREAM + attempt
            if cost.timeout_us is not None and lat > cost.timeout_us:
                st.timeouts += 1
                extra += cost.timeout_us + backoff(attempt)
                continue
            if corrupt:
                # the checksum mechanism is load-bearing: really perturb the
                # payload and let verification catch it
                torn = dev.attempt_payload(
                    b, True, plan.corruption_salt(dev.kind, b, salt_attempt))
                if not dev.verify(b, torn):
                    st.checksum_failures += 1
                    extra += lat + backoff(attempt)
                    continue
                # payload had no bytes to tear (None placeholder): fall
                # through as a clean delivery
            # clean verified delivery: the base read_us is charged by the
            # pipelined submission term; only the remainder is a straggler
            extra += lat - cost.read_us
            return dev.read(b), True, extra

        st.failed_reads += 1
        return READ_FAILED, False, extra
