"""The port's block-device simulator, fault plans and on-disk layouts
(`repro_torch.core.io_sim`, `utils.faults`, `core.storage`) against the
JAX package's (`repro.core.io_sim`, `repro.utils.faults`,
`repro.core.storage`).

The first parts mirror tests/test_storage.py, tests/test_io_properties.py
(its hypothesis variants under the same guard) and the two plan tests of
tests/test_faults.py on the port's classes.  The last part feeds the same
numpy-seeded read and submit sequences to both packages, under every cache
policy, with and without pins, prefetch hints and a fault plan, and holds
them *identical* -- no tolerance anywhere: `IOStats` field by field, the
cache's `keys()` order, the returned payloads, service and serial
microseconds, and every `FaultPlan` draw.  The simulator is pure Python on
both sides, so equal inputs must give equal floats.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import io_sim as ref_io
from repro.core import storage as ref_storage
from repro.utils import faults as ref_faults
from repro_torch.core.io_sim import (_MISS, BLOCK_SIZE, READ_FAILED,
                                     BlockDevice, CostModel, IOScheduler,
                                     IOStats, LRUCache, PinnedCache,
                                     make_policy)
from repro_torch.core.storage import (CoupledStorage, DecoupledStorage,
                                      coupled_nodes_per_block,
                                      max_capacity_for)
from repro_torch.utils.faults import (FaultPlan, FaultSpec, RetryPolicy,
                                      corrupt_payload, payload_checksum)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as hst
    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover - container without dev deps
    HAS_HYPOTHESIS = False

POLICIES = ("lru", "fifo", "clock", "2q")
SEEDS = (0, 1, 2, 3, 4)


# ---------------------------------------------------------------------------
# tests/test_storage.py on the port
# ---------------------------------------------------------------------------
def _graph(n, r, seed=0):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.2] = -1
    return adj


def test_block_device_lru_and_counting():
    dev = BlockDevice(list(range(10)), cache_blocks=2, kind="graph")
    dev.read(0); dev.read(1)
    assert dev.stats.graph_reads == 2
    dev.read(0)                      # hit
    assert dev.stats.cache_hits == 1
    dev.read(2)                      # evicts 1
    dev.read(1)                      # miss again
    assert dev.stats.graph_reads == 4
    with pytest.raises(IndexError):
        dev.read(99)


def test_coupled_storage_roundtrip():
    n, d, r = 50, 16, 8
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    adj = _graph(n, r)
    st = CoupledStorage(x, adj)
    assert st.npb == BLOCK_SIZE // (4 * d + 4 + 4 * r)
    for vid in (0, 17, 49):
        rec = st.read_node_block(vid)
        s = st.slot_in_block(vid)
        assert rec.vids[s] == vid
        np.testing.assert_array_equal(rec.vecs[s], x[vid])
        np.testing.assert_array_equal(rec.nbrs[s], adj[vid])


def test_coupled_large_record_spans_blocks():
    n, d, r = 10, 1500, 8          # 6 KB record > 4 KB block
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    st = CoupledStorage(x, _graph(n, r))
    assert st.blocks_per_record == 2
    st.device.reset()
    st.read_node_block(3)
    assert st.device.stats.graph_reads == 2   # both span blocks counted


def _decoupled(n=60, d=32, r=6, cap=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    adj = _graph(n, r, seed)
    cap = cap or max_capacity_for(r)
    blocks = (np.arange(n) // cap).astype(np.int32)
    m = int(blocks.max()) + 1
    members = -np.ones((m, cap), np.int32)
    for b in range(m):
        mem = np.nonzero(blocks == b)[0]
        members[b, :len(mem)] = mem
    return x, adj, blocks, members, cap


def test_decoupled_graph_block_capacity_respects_block_size():
    x, adj, blocks, members, cap = _decoupled()
    st = DecoupledStorage(x, adj, blocks, members)
    assert cap * st.record_bytes <= BLOCK_SIZE
    with pytest.raises(ValueError):
        DecoupledStorage(x, adj, blocks, members, block_size=cap * 4)


def test_decoupled_oid_addressing_and_vectors():
    x, adj, blocks, members, cap = _decoupled()
    st = DecoupledStorage(x, adj, blocks, members)
    for vid in (0, 31, 59):
        oid = int(st.vid2oid[vid])
        assert int(st.oid2vid[oid]) == vid
        vec = st.read_vector(oid)
        np.testing.assert_allclose(vec, x[vid], rtol=1e-6)
        gb = st.gblock_of_oid(oid)
        blk = st.read_graph_block(gb)
        s = oid - gb * cap
        assert blk.vids[s] == vid
        nn = adj[vid][adj[vid] >= 0]
        got = blk.nbrs[s][blk.nbrs[s] >= 0]
        np.testing.assert_array_equal(np.sort(st.oid2vid[got]), np.sort(nn))


def test_vector_alignment_no_straddle():
    """d=960 (GIST regime): one 3840 B vector per 4 KB block, 1 read each."""
    x, adj, blocks, members, cap = _decoupled(n=30, d=960, r=6, cap=10)
    st = DecoupledStorage(x, adj, blocks, members)
    assert st.vecs_per_vblock == 1
    st.reset()
    st.read_vector(int(st.vid2oid[7]))
    assert st.vector_dev.stats.vector_reads == 1
    np.testing.assert_allclose(st.read_vector(int(st.vid2oid[7])), x[7],
                               rtol=1e-6)


def test_vector_larger_than_block():
    x, adj, blocks, members, cap = _decoupled(n=20, d=1100, r=4, cap=8)
    st = DecoupledStorage(x, adj, blocks, members)
    assert st.vblocks_per_vec == 2
    st.reset()
    v = st.read_vector(int(st.vid2oid[5]))
    assert st.vector_dev.stats.vector_reads == 2
    np.testing.assert_allclose(v, x[5], rtol=1e-6)


def test_cost_model_monotone():
    cm = CostModel()
    assert cm.qps(10, 100, 1000) > cm.qps(20, 100, 1000)
    assert cm.query_time_us(10, 0, 0) == pytest.approx(10 * cm.read_us)


# ---------------------------------------------------------------------------
# tests/test_io_properties.py on the port
# ---------------------------------------------------------------------------
def _trace(seed: int, n_blocks: int | None = None, length: int | None = None):
    """Random skewed read trace: half uniform, half over a small hot set
    (re-references are what distinguish the policies)."""
    rng = np.random.default_rng(seed)
    n_blocks = n_blocks or int(rng.integers(2, 40))
    length = length or int(rng.integers(1, 300))
    hot = rng.integers(0, n_blocks, size=max(1, n_blocks // 4))
    out = []
    for _ in range(length):
        if rng.random() < 0.5:
            out.append(int(rng.choice(hot)))
        else:
            out.append(int(rng.integers(0, n_blocks)))
    return n_blocks, out


def _run_trace(dev: BlockDevice, trace, check_occupancy=True):
    for b in trace:
        dev.read(b)
        if check_occupancy:
            assert len(dev.policy) <= dev.policy.capacity


# ---------------------------------------------------------------------------
# Accounting identities
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_hits_plus_misses_equals_total_reads(policy, seed):
    n_blocks, trace = _trace(seed)
    cap = int(np.random.default_rng(seed + 100).integers(1, n_blocks + 4))
    dev = BlockDevice(list(range(n_blocks)), cache_blocks=cap, kind="graph",
                      policy=policy)
    _run_trace(dev, trace)
    assert dev.stats.cache_hits + dev.stats.nio == len(trace)
    assert dev.stats.vector_reads == 0        # graph device counts as graph
    assert dev.stats.total_accesses == len(trace)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_infinite_cache_nio_is_distinct_blocks(policy, seed):
    n_blocks, trace = _trace(seed)
    dev = BlockDevice(list(range(n_blocks)), cache_blocks=n_blocks + 1,
                      kind="vector", policy=policy)
    _run_trace(dev, trace)
    assert dev.stats.nio == len(set(trace))
    assert dev.stats.vector_reads == dev.stats.nio   # kind routes the counter


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_nio_is_graph_plus_vector_reads(seed):
    """End-to-end over the decoupled layout: graph + vector devices."""
    rng = np.random.default_rng(seed)
    n, d, r = 40, 12, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    cap = max_capacity_for(r)
    blocks = (np.arange(n) // cap).astype(np.int32)
    m = int(blocks.max()) + 1
    members = -np.ones((m, cap), np.int32)
    for b in range(m):
        mem = np.nonzero(blocks == b)[0]
        members[b, :len(mem)] = mem
    st = DecoupledStorage(x, adj, blocks, members, cache_blocks=2,
                          vec_cache_blocks=2)
    for _ in range(60):
        if rng.random() < 0.5:
            st.read_graph_block(int(rng.integers(0, m)))
        else:
            st.read_vector(int(st.vid2oid[int(rng.integers(0, n))]))
    g, v = st.graph_dev.stats, st.vector_dev.stats
    assert g.nio == g.graph_reads and g.vector_reads == 0
    assert v.nio == v.vector_reads and v.graph_reads == 0
    assert (g.nio + v.nio) == (g.graph_reads + v.vector_reads)


def test_none_payload_counts_as_hit():
    """Regression: a cached payload of None must register as a hit (the old
    `_cache.pop(id, None)` miss marker re-read span placeholders forever)."""
    dev = BlockDevice([None, None, b"x"], cache_blocks=4, kind="graph")
    assert dev.read(0) is None
    assert dev.read(0) is None
    assert dev.stats.graph_reads == 1 and dev.stats.cache_hits == 1


def test_miss_sentinel_is_not_none():
    p = LRUCache(4)
    p.put(1, None)
    assert p.get(1) is None and p.get(1) is not _MISS
    assert p.get(2) is _MISS


# ---------------------------------------------------------------------------
# Policy behavior
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_lru_evicts_exactly_least_recently_used(seed):
    """Model-based check: the resident set must match a reference LRU after
    every read of a random trace."""
    from collections import OrderedDict
    n_blocks, trace = _trace(seed)
    cap = int(np.random.default_rng(seed + 7).integers(1, n_blocks + 2))
    dev = BlockDevice(list(range(n_blocks)), cache_blocks=cap, policy="lru")
    ref: OrderedDict[int, None] = OrderedDict()
    for b in trace:
        dev.read(b)
        if b in ref:
            ref.move_to_end(b)
        else:
            ref[b] = None
            while len(ref) > cap:
                ref.popitem(last=False)      # exactly the LRU entry
        assert set(dev.policy.keys()) == set(ref)


def test_lru_eviction_order_direct():
    dev = BlockDevice(list(range(8)), cache_blocks=3, policy="lru")
    dev.read(0); dev.read(1); dev.read(2)
    dev.read(0)                     # 1 is now least-recently-used
    dev.read(3)                     # evicts exactly 1
    assert set(dev.policy.keys()) == {0, 2, 3}
    dev.read(1)
    assert dev.stats.graph_reads == 5       # 1 was truly evicted


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_reset_keep_cache_preserves_hit_behavior(policy, seed):
    n_blocks, trace = _trace(seed)
    dev = BlockDevice(list(range(n_blocks)), cache_blocks=max(2, n_blocks // 2),
                      policy=policy)
    _run_trace(dev, trace)
    resident = [b for b in range(n_blocks) if dev.cached(b)]
    dev.reset(drop_cache=False)
    assert dev.stats.nio == 0 and dev.stats.cache_hits == 0
    for b in resident:
        dev.read(b)
    assert dev.stats.nio == 0                      # all still hits
    assert dev.stats.cache_hits == len(resident)
    dev.reset(drop_cache=True)
    if resident:
        dev.read(resident[0])
        assert dev.stats.nio == 1                  # cold again


def test_fifo_does_not_refresh_on_hit():
    dev = BlockDevice(list(range(8)), cache_blocks=2, policy="fifo")
    dev.read(0); dev.read(1)
    dev.read(0)                  # hit; FIFO keeps 0 the oldest anyway
    dev.read(2)                  # evicts 0 (oldest insertion), not 1
    assert set(dev.policy.keys()) == {1, 2}


def test_clock_second_chance():
    dev = BlockDevice(list(range(8)), cache_blocks=2, policy="clock")
    dev.read(0); dev.read(1)
    dev.read(0)                  # sets 0's reference bit
    dev.read(2)                  # hand clears 0's bit, evicts 1
    assert set(dev.policy.keys()) == {0, 2}


def test_2q_scan_resistance():
    """Blocks re-referenced after their A1in probation land in Am and then
    survive a long one-pass scan (which only churns A1in)."""
    dev = BlockDevice(list(range(64)), cache_blocks=8, policy="2q")
    for b in range(10):          # fill + overflow A1in: 0,1 demoted to ghost
        dev.read(b)
    dev.read(0); dev.read(1)     # ghosted -> promoted into Am (hot)
    for b in range(20, 50):      # long cold scan through A1in
        dev.read(b)
    assert dev.cached(0) and dev.cached(1)   # Am survived the scan
    dev.reset(drop_cache=False)
    dev.read(0); dev.read(1)
    assert dev.stats.nio == 0


# ---------------------------------------------------------------------------
# Pinned cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_pinned_blocks_never_miss_and_never_evict(seed):
    n_blocks, trace = _trace(seed, n_blocks=30)
    pins = (0, 5, 7)
    dev = BlockDevice(list(range(n_blocks)), cache_blocks=8, policy="lru",
                      pinned=pins)
    _run_trace(dev, trace)
    for p in pins:
        assert dev.cached(p)
    before = dev.stats.nio
    for p in pins:
        dev.read(p)
    assert dev.stats.nio == before           # pinned reads are always hits
    assert len(dev.policy) <= 8              # pins count against capacity
    dev.reset(drop_cache=True)               # re-pins on reset
    dev.read(5)
    assert dev.stats.nio == 0


def test_pins_exceeding_capacity_raise():
    with pytest.raises(ValueError):
        PinnedCache(2, pins=(0, 1, 2))


def test_make_policy_rejects_unknown():
    with pytest.raises(ValueError):
        make_policy("arc", 8)


# ---------------------------------------------------------------------------
# Scheduler: timing never changes accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_batched_submissions_identical_accounting(policy, seed):
    """The same demand trace, issued per-read vs in random batches, must
    produce bit-identical NIO, hits, and resident sets."""
    rng = np.random.default_rng(seed + 50)
    n_blocks, trace = _trace(seed)
    cap = max(1, n_blocks // 2)
    dev_a = BlockDevice(list(range(n_blocks)), cache_blocks=cap, policy=policy)
    dev_b = BlockDevice(list(range(n_blocks)), cache_blocks=cap, policy=policy)
    sch_a = IOScheduler(CostModel(qd=1))
    sch_b = IOScheduler(CostModel(qd=4))
    for b in trace:
        sch_a.read(dev_a, b)
    i = 0
    while i < len(trace):
        step = int(rng.integers(1, 6))
        sch_b.submit(dev_b, trace[i: i + step])
        i += step
    assert dev_a.stats.nio == dev_b.stats.nio
    assert dev_a.stats.cache_hits == dev_b.stats.cache_hits
    assert set(dev_a.policy.keys()) == set(dev_b.policy.keys())
    assert sch_a.serial_us == sch_b.serial_us
    assert sch_a.service_us == sch_a.serial_us        # qd=1: no overlap
    assert sch_b.service_us <= sch_b.serial_us        # qd=4: overlapped


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_speculative_prefetch_never_touches_accounting(seed):
    """Random prefetch hints alongside each demand read: NIO, hits, and the
    resident set must be bit-identical to the hint-free run."""
    rng = np.random.default_rng(seed + 9)
    n_blocks, trace = _trace(seed, n_blocks=24)
    dev_a = BlockDevice(list(range(n_blocks)), cache_blocks=6)
    dev_b = BlockDevice(list(range(n_blocks)), cache_blocks=6)
    sch_a, sch_b = IOScheduler(), IOScheduler()
    for b in trace:
        sch_a.submit(dev_a, [b])
        hints = rng.integers(0, n_blocks, size=int(rng.integers(0, 4)))
        sch_b.submit(dev_b, [b], prefetch=hints.tolist())
    assert dev_a.stats.nio == dev_b.stats.nio
    assert dev_a.stats.cache_hits == dev_b.stats.cache_hits
    assert set(dev_a.policy.keys()) == set(dev_b.policy.keys())
    assert sch_a.serial_us == sch_b.serial_us         # accounting domain
    assert sch_b.service_us >= sch_a.service_us - 1e-9  # qd=1: hints only add


def test_prefetch_hit_makes_later_demand_free():
    dev = BlockDevice(list(range(8)), cache_blocks=4)
    sch = IOScheduler(CostModel(qd=2, read_us=100.0))
    sch.submit(dev, [0], prefetch=[1])      # 2 reads overlapped at qd=2
    assert sch.service_us == 100.0 and sch.serial_us == 100.0
    sch.submit(dev, [1])                    # prefetched: free in time...
    assert sch.service_us == 100.0
    assert dev.stats.nio == 2               # ...but still one NIO (data moved)
    assert sch.prefetch_hits == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_service_never_exceeds_serial(seed):
    """Invariant: speculation only fills idle queue slots, so the pipelined
    service time can never exceed the serial baseline -- for any qd, any
    prefetch hints, any trace."""
    rng = np.random.default_rng(seed + 1234)
    n_blocks, trace = _trace(seed, n_blocks=24)
    qd = int(rng.integers(1, 9))
    submit_us = float(rng.choice([0.0, 2.0]))
    dev = BlockDevice(list(range(n_blocks)), cache_blocks=6)
    sch = IOScheduler(CostModel(qd=qd, submit_us=submit_us))
    for b in trace:
        hints = rng.integers(0, n_blocks, size=int(rng.integers(0, 5)))
        sch.submit(dev, [b], prefetch=hints.tolist())
    assert sch.service_us <= sch.serial_us + 1e-9
    if qd == 1 and submit_us == 0.0:
        assert sch.service_us == sch.serial_us   # no idle slots: no overlap


def test_make_policy_instance_with_pins_respects_capacity():
    """A caller-supplied policy instance + pins must still bound total
    residency (pins + inner) by the requested capacity."""
    pol = make_policy(LRUCache(8), 8, pins=(0, 1))
    assert isinstance(pol, PinnedCache)
    for b in range(20):
        pol.put(b, b)
    pol.put(0, 0); pol.put(1, 1)     # preload pins
    assert len(pol) <= 8
    assert pol.contains(0) and pol.contains(1)


def test_submission_time_ceil_model():
    cm = CostModel(read_us=100.0, qd=4)
    assert cm.submission_us(0) == 0.0
    assert cm.submission_us(1) == 100.0
    assert cm.submission_us(4) == 100.0
    assert cm.submission_us(5) == 200.0
    assert CostModel(read_us=100.0, qd=1).submission_us(5) == 500.0


# ---------------------------------------------------------------------------
# Hypothesis variants (run when the dev deps are installed)
# ---------------------------------------------------------------------------
if HAS_HYPOTHESIS:
    trace_strategy = hst.lists(hst.integers(min_value=0, max_value=31),
                               min_size=1, max_size=200)

    @settings(max_examples=30, deadline=None)
    @given(trace=trace_strategy, cap=hst.integers(min_value=1, max_value=40),
           policy=hst.sampled_from(POLICIES))
    def test_hyp_occupancy_and_accounting(trace, cap, policy):
        dev = BlockDevice(list(range(32)), cache_blocks=cap, policy=policy)
        for b in trace:
            dev.read(b)
            assert len(dev.policy) <= cap
        assert dev.stats.cache_hits + dev.stats.nio == len(trace)
        if cap >= 32:
            assert dev.stats.nio == len(set(trace))

    @settings(max_examples=30, deadline=None)
    @given(trace=trace_strategy, cap=hst.integers(min_value=1, max_value=40))
    def test_hyp_lru_reference_model(trace, cap):
        from collections import OrderedDict
        dev = BlockDevice(list(range(32)), cache_blocks=cap, policy="lru")
        ref: OrderedDict[int, None] = OrderedDict()
        for b in trace:
            dev.read(b)
            if b in ref:
                ref.move_to_end(b)
            else:
                ref[b] = None
                while len(ref) > cap:
                    ref.popitem(last=False)
            assert set(dev.policy.keys()) == set(ref)

    @settings(max_examples=30, deadline=None)
    @given(trace=trace_strategy, policy=hst.sampled_from(POLICIES),
           qd=hst.integers(min_value=1, max_value=8),
           chunks=hst.lists(hst.integers(min_value=1, max_value=7),
                            min_size=1, max_size=50))
    def test_hyp_scheduler_accounting_invariant(trace, policy, qd, chunks):
        dev_a = BlockDevice(list(range(32)), cache_blocks=8, policy=policy)
        dev_b = BlockDevice(list(range(32)), cache_blocks=8, policy=policy)
        sch_a = IOScheduler(CostModel(qd=1))
        sch_b = IOScheduler(CostModel(qd=qd))
        for b in trace:
            sch_a.read(dev_a, b)
        i = ci = 0
        while i < len(trace):
            step = chunks[ci % len(chunks)]
            sch_b.submit(dev_b, trace[i: i + step])
            i += step
            ci += 1
        assert dev_a.stats.nio == dev_b.stats.nio
        assert dev_a.stats.cache_hits == dev_b.stats.cache_hits
        assert set(dev_a.policy.keys()) == set(dev_b.policy.keys())
        assert sch_b.service_us <= sch_a.service_us + 1e-9


# ---------------------------------------------------------------------------
# tests/test_faults.py (plan determinism, checksums) on the port
# ---------------------------------------------------------------------------
def test_fault_plan_reproducible_and_order_independent():
    spec = FaultSpec(read_error_rate=0.1, dead_rate=0.05, corrupt_rate=0.05,
                     spike_rate=0.1)
    keys = [(k, b, a) for k in ("graph", "vector")
            for b in range(64) for a in range(3)]
    p1, p2 = FaultPlan(spec, seed=11), FaultPlan(spec, seed=11)
    draws1 = [p1.outcome(*kk) for kk in keys]
    # same seed, reversed issue order -> identical schedule
    draws2 = list(reversed([p2.outcome(*kk) for kk in reversed(keys)]))
    assert draws1 == draws2
    assert [p1.dead(k, b) for k, b, _ in keys] == \
           [p2.dead(k, b) for k, b, _ in keys]
    # a different seed gives a different schedule
    p3 = FaultPlan(spec, seed=12)
    assert draws1 != [p3.outcome(*kk) for kk in keys]
    # zero-rate spec never draws anything
    p0 = FaultPlan(FaultSpec(), seed=11)
    assert not any(o.error or o.persistent or o.corrupt or o.spike_us
                   for o in (p0.outcome(*kk) for kk in keys))
    assert not FaultSpec().any_io


def test_checksum_roundtrip_and_corruption():
    rng = np.random.default_rng(0)
    payload = rng.standard_normal(32).astype(np.float32)
    c0 = payload_checksum(payload)
    assert c0 == payload_checksum(payload.copy())        # content-addressed
    bad = corrupt_payload(payload, salt=3)
    assert payload_checksum(bad) != c0                   # flips are visible
    assert c0 == payload_checksum(payload)               # original untouched
    bad2 = corrupt_payload(payload, salt=3)
    np.testing.assert_array_equal(bad, bad2)             # deterministic salt
    assert payload_checksum(None) == 0


# ---------------------------------------------------------------------------
# Parity with the reference: identical draws, accounting, order and times
# ---------------------------------------------------------------------------
_SPECS = (FaultSpec(read_error_rate=0.1, dead_rate=0.05, corrupt_rate=0.05,
                    spike_rate=0.1),
          FaultSpec(read_error_rate=0.3, spike_rate=0.5, spike_us=700.0,
                    step_fail_rate=0.2))


def _ref_spec(spec):
    return ref_faults.FaultSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("spec", _SPECS)
@pytest.mark.parametrize("seed", (0, 7))
def test_fault_plan_draws_equal_reference(spec, seed):
    """Every draw of a plan -- outcome, dead, jitter, salt, step failure --
    equals the reference's for the same (seed, kind, block, attempt)."""
    mine, ref = FaultPlan(spec, seed=seed), ref_faults.FaultPlan(
        _ref_spec(spec), seed=seed)
    assert repr(mine) == repr(ref)
    assert spec.any_io == _ref_spec(spec).any_io
    for kind in ("graph", "vector"):
        for b in range(48):
            assert mine.dead(kind, b) == ref.dead(kind, b)
            for a in (0, 1, 2, 1 << 20):
                assert dataclasses.asdict(mine.outcome(kind, b, a)) == \
                    dataclasses.asdict(ref.outcome(kind, b, a))
                assert mine.jitter(kind, b, a) == ref.jitter(kind, b, a)
                assert (mine.corruption_salt(kind, b, a)
                        == ref.corruption_salt(kind, b, a))
    assert [mine.fail_step(s, a) for s in range(64) for a in range(3)] == \
        [ref.fail_step(s, a) for s in range(64) for a in range(3)]
    rp = RetryPolicy(budget=4, backoff_us=30.0, jitter=0.25)
    rrp = ref_faults.RetryPolicy(budget=4, backoff_us=30.0, jitter=0.25)
    assert [rp.backoff(r, u) for r in range(5) for u in (0.0, 0.3, 0.99)] \
        == [rrp.backoff(r, u) for r in range(5) for u in (0.0, 0.3, 0.99)]


def test_checksums_and_corruption_equal_reference():
    """The same CRC32 and the same torn bytes for every payload kind the
    storage layer stores: arrays, the layout dataclasses, bytes, None."""
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((4, 9)).astype(np.float32)
    nb = rng.integers(-1, 50, (6, 5)).astype(np.int32)
    blocks = [
        (arr, arr),
        (ref_storage.GraphBlock(oids=nb[:, 0].copy(), vids=nb[:, 1].copy(),
                                nbrs=nb),
         __import__("repro_torch.core.storage", fromlist=["GraphBlock"])
         .GraphBlock(oids=nb[:, 0].copy(), vids=nb[:, 1].copy(), nbrs=nb)),
        (b"block bytes", b"block bytes"),
        (None, None),
    ]
    for ref_p, my_p in blocks:
        assert payload_checksum(my_p) == ref_faults.payload_checksum(ref_p)
        for salt in (0, 5, 2 ** 31 - 1):
            torn = corrupt_payload(my_p, salt)
            ref_torn = ref_faults.corrupt_payload(ref_p, salt)
            assert payload_checksum(torn) == \
                ref_faults.payload_checksum(ref_torn)


def _devices(policy, pins, faults, n_blocks, cap, kind="graph"):
    """The same block device in both packages (payloads: small arrays, so
    torn transfers really change bytes)."""
    payloads = [np.full(4, b, np.float32) for b in range(n_blocks)]
    spec = faults if faults is None else (faults, _ref_spec(faults))
    mine = BlockDevice(payloads, cache_blocks=cap, kind=kind, policy=policy,
                       pinned=pins, faults=None if spec is None
                       else FaultPlan(spec[0], seed=5))
    ref = ref_io.BlockDevice(payloads, cache_blocks=cap, kind=kind,
                             policy=policy, pinned=pins,
                             faults=None if spec is None
                             else ref_faults.FaultPlan(spec[1], seed=5))
    return mine, ref


def _same_state(mine_dev, ref_dev, mine_sch, ref_sch):
    assert dataclasses.asdict(mine_dev.stats) == \
        dataclasses.asdict(ref_dev.stats)
    assert mine_dev.stats.nio == ref_dev.stats.nio
    assert mine_dev.policy.keys() == ref_dev.policy.keys()   # order too
    assert len(mine_dev.policy) == len(ref_dev.policy)
    for f in ("service_us", "serial_us", "submissions", "demand_reads",
              "prefetches", "prefetch_hits"):
        assert getattr(mine_sch, f) == getattr(ref_sch, f), f


def _same_payloads(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a is READ_FAILED) == (b is ref_io.READ_FAILED)
        if a is not READ_FAILED:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pins", ((), (0, 3, 11)))
@pytest.mark.parametrize("prefetch", (False, True))
@pytest.mark.parametrize("faults", (None, _SPECS[0]))
def test_device_and_scheduler_identical_to_reference(policy, pins, prefetch,
                                                     faults):
    """One seeded trace of single reads, batched submissions (with
    prefetch hints), resets that keep and drop the cache, through a
    deadline-armed cost model: both packages end every step in the same
    state and return the same payloads."""
    rng = np.random.default_rng(len(policy) * 31 + len(pins)
                                + 2 * prefetch + 4 * (faults is not None))
    n_blocks, cap = 40, 9
    mine_dev, ref_dev = _devices(policy, pins, faults, n_blocks, cap)
    cost = dict(qd=4, submit_us=1.5, timeout_us=900.0, hedge_us=150.0)
    retry = dict(budget=2, backoff_us=20.0)
    mine_sch = IOScheduler(CostModel(**cost), RetryPolicy(**retry))
    ref_sch = ref_io.IOScheduler(ref_io.CostModel(**cost),
                                 ref_faults.RetryPolicy(**retry))
    _, trace = _trace(11, n_blocks=n_blocks, length=240)

    def fired():
        st = mine_dev.stats
        return st.retries + st.read_errors + st.checksum_failures

    i = n_fired = 0
    while i < len(trace):
        step = int(rng.integers(1, 6))
        ids = trace[i:i + step]
        hints = (rng.integers(-2, n_blocks + 2, int(rng.integers(0, 6)))
                 .tolist() if prefetch else [])
        if step == 1 and not hints:
            got, want = [mine_sch.read(mine_dev, ids[0])], \
                [ref_sch.read(ref_dev, ids[0])]
        else:
            got = mine_sch.submit(mine_dev, ids, prefetch=hints)
            want = ref_sch.submit(ref_dev, ids, prefetch=hints)
        _same_payloads(got, want)
        _same_state(mine_dev, ref_dev, mine_sch, ref_sch)
        assert mine_sch.service_us <= mine_sch.serial_us + 1e-9
        if rng.random() < 0.05:
            n_fired += fired()
            drop = bool(rng.random() < 0.5)
            mine_dev.reset(drop)
            ref_dev.reset(drop)
            _same_state(mine_dev, ref_dev, mine_sch, ref_sch)
        i += step
    if faults is not None:
        assert n_fired + fired() > 0        # the plan really fired


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_objects_identical_to_reference(policy):
    """The policies alone (and `PinnedCache` around each, built from a
    name and from an instance): the same get/put/contains trace gives the
    same hits, the same `keys()` order and the same length."""
    rng = np.random.default_rng(21)
    pairs = [(make_policy(policy, 7), ref_io.make_policy(policy, 7)),
             (make_policy(policy, 7, pins=(2, 5)),
              ref_io.make_policy(policy, 7, pins=(2, 5))),
             (make_policy(make_policy(policy, 9), 7, pins=(1,)),
              ref_io.make_policy(ref_io.make_policy(policy, 9), 7,
                                 pins=(1,)))]
    for mine, ref in pairs:
        assert type(mine).__name__ == type(ref).__name__
        for _ in range(300):
            key = int(rng.integers(0, 20))
            op = rng.random()
            if op < 0.5:
                a, b = mine.get(key), ref.get(key)
                assert (a is _MISS) == (b is ref_io._MISS)
                if a is not _MISS:
                    assert a == b
            elif op < 0.9:
                mine.put(key, key)
                ref.put(key, key)
            else:
                assert mine.contains(key) == ref.contains(key)
            assert mine.keys() == ref.keys()
            assert len(mine) <= mine.capacity
        mine.clear()
        ref.clear()
        assert mine.keys() == ref.keys() == []


def test_sentinels_are_identities():
    """`READ_FAILED` and `_MISS` are identity sentinels, neither None nor
    the reference's objects; a cached None is a hit."""
    assert READ_FAILED is not None and _MISS is not None
    assert READ_FAILED is not _MISS
    assert READ_FAILED is not ref_io.READ_FAILED
    assert BLOCK_SIZE == ref_io.BLOCK_SIZE == 4096
    p = LRUCache(2)
    p.put(0, None)
    assert p.get(0) is None and p.get(1) is _MISS


def _layout(n, d, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    adj = _graph(n, r, seed)
    cap = max_capacity_for(r)
    blocks = rng.permutation(np.arange(n) // cap).astype(np.int32)
    m = int(blocks.max()) + 1
    members = -np.ones((m, cap), np.int32)
    for b in range(m):
        mem = np.nonzero(blocks == b)[0]
        members[b, :len(mem)] = mem
    return x, adj, blocks, members


def _same_blocks(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            continue
        for f in dataclasses.fields(a):
            u, v = getattr(a, f.name), getattr(b, f.name)
            assert u.dtype == v.dtype, f.name
            np.testing.assert_array_equal(u, v, err_msg=f.name)


@pytest.mark.parametrize("d", (16, 1100))
def test_decoupled_layout_identical_to_reference(d):
    """The same graph and vector blocks, addressing and byte counts; then
    the same seeded mix of graph-block and vector reads (batched and not,
    pinned graph blocks, a fault plan) leaves both in the same state."""
    n, r = 150, 24                 # capacity 37: five graph blocks
    x, adj, blocks, members = _layout(n, d, r, seed=d)
    spec = FaultSpec(read_error_rate=0.1, corrupt_rate=0.1)
    kw = dict(cache_blocks=3, vec_cache_blocks=4, policy="clock",
              vec_policy="2q", pinned_gblocks=(0, 2))
    mine = DecoupledStorage(x, adj, blocks, members,
                            cost=CostModel(qd=3),
                            faults=FaultPlan(spec, seed=1), **kw)
    ref = ref_storage.DecoupledStorage(
        x, adj, blocks, members, cost=ref_io.CostModel(qd=3),
        faults=ref_faults.FaultPlan(_ref_spec(spec), seed=1), **kw)
    for f in ("record_bytes", "vecs_per_vblock", "vblocks_per_vec",
              "vblocks_per_gblock", "graph_bytes", "vector_bytes", "m",
              "capacity"):
        assert getattr(mine, f) == getattr(ref, f), f
    np.testing.assert_array_equal(mine.vid2oid, ref.vid2oid)
    np.testing.assert_array_equal(mine.oid2vid, ref.oid2vid)
    _same_blocks(mine.graph_dev.blocks, ref.graph_dev.blocks)
    _same_blocks(mine.vector_dev.blocks, ref.vector_dev.blocks)
    rng = np.random.default_rng(d)
    for _ in range(120):
        u = rng.random()
        if u < 0.4:
            gb = int(rng.integers(0, mine.m))
            pf = rng.integers(0, mine.m, 2).tolist()
            a, b = (mine.read_graph_block(gb, prefetch=pf),
                    ref.read_graph_block(gb, prefetch=pf))
            assert (a is READ_FAILED) == (b is ref_io.READ_FAILED)
            if a is not READ_FAILED:
                _same_blocks([a], [b])
        else:
            oids = mine.vid2oid[rng.integers(0, n, 3)].tolist()
            batched = u < 0.7
            for a, b in zip(mine.read_vectors(oids, batched=batched),
                            ref.read_vectors(oids, batched=batched)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        for dm, dr in ((mine.graph_dev, ref.graph_dev),
                       (mine.vector_dev, ref.vector_dev)):
            _same_state(dm, dr, mine.scheduler, ref.scheduler)
    mine.reset()
    ref.reset()
    assert mine.graph_dev.policy.keys() == ref.graph_dev.policy.keys()


@pytest.mark.parametrize("d", (16, 1500))
def test_coupled_layout_identical_to_reference(d):
    """The coupled layout in a shuffled order: the same records, span
    blocks and positions; the same reads give the same records, stats,
    cache order and times."""
    n, r = 70, 8
    x, adj, blocks, _ = _layout(n, d, r, seed=d + 1)
    order = np.argsort(blocks, kind="stable").astype(np.int64)
    assert coupled_nodes_per_block(d, r) == ref_storage \
        .coupled_nodes_per_block(d, r)
    spec = FaultSpec(read_error_rate=0.1, dead_rate=0.05)
    mine = CoupledStorage(x, adj, order=order, cache_blocks=5, policy="fifo",
                          cost=CostModel(qd=2),
                          faults=FaultPlan(spec, seed=2))
    ref = ref_storage.CoupledStorage(
        x, adj, order=order, cache_blocks=5, policy="fifo",
        cost=ref_io.CostModel(qd=2),
        faults=ref_faults.FaultPlan(_ref_spec(spec), seed=2))
    for f in ("npb", "blocks_per_record", "record_bytes", "n_blocks"):
        assert getattr(mine, f) == getattr(ref, f), f
    np.testing.assert_array_equal(mine.pos, ref.pos)
    np.testing.assert_array_equal(mine.layout, ref.layout)
    _same_blocks(mine.device.blocks, ref.device.blocks)
    rng = np.random.default_rng(d)
    nb = -(-n // mine.npb)
    for _ in range(100):
        v = int(rng.integers(0, n))
        pf = rng.integers(0, nb, 2).tolist()
        assert mine.block_of(v) == ref.block_of(v)
        assert mine.slot_in_block(v) == ref.slot_in_block(v)
        a, b = (mine.read_node_block(v, prefetch=pf),
                ref.read_node_block(v, prefetch=pf))
        assert (a is READ_FAILED) == (b is ref_io.READ_FAILED)
        if a is not READ_FAILED:
            _same_blocks([a], [b])
        _same_state(mine.device, ref.device, mine.scheduler, ref.scheduler)
        if rng.random() < 0.1:
            mine.reset(drop_cache=False)
            ref.reset(drop_cache=False)


def test_cost_model_and_stats_identical_to_reference():
    kw = dict(read_us=90.0, dist_us=0.07, pq_dist_us=0.004, threads=6,
              qd=3, submit_us=1.25)
    mine, ref = CostModel(**kw), ref_io.CostModel(**kw)
    for n in range(12):
        assert mine.submission_us(n) == ref.submission_us(n)
    for args in ((10, 100, 1000), (0.5, 3.25, 17.0), (0, 0, 0)):
        assert mine.query_time_us(*args) == ref.query_time_us(*args)
        assert mine.qps(*args) == ref.qps(*args)
        assert mine.qps_from_io_us(*args) == ref.qps_from_io_us(*args)
    a, b = IOStats(graph_reads=3, cache_hits=2), ref_io.IOStats(
        graph_reads=3, cache_hits=2)
    a.add(IOStats(vector_reads=4, retries=1))
    b.add(ref_io.IOStats(vector_reads=4, retries=1))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.nio, a.total_accesses, a.hit_rate) == \
        (b.nio, b.total_accesses, b.hit_rate)
