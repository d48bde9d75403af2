"""The port's serving fleet (`repro_torch.serve.runtime`, `serve.frontend`,
`launch.mesh`) against the JAX package's.

- **Parity through the reference's arrays**: PQ training is not
  bit-identical across frameworks, so the JAX fleet
  (`ShardedFrontend.build`, 3 shards) hands each shard's `batch_arrays()`
  to the port's engines, and the port's `ServeRuntime` over them must
  answer as the JAX fleet does -- ids equal, dists within rtol = atol =
  1e-5 (the engines' ADC and re-rank sums run in another order in XLA) --
  clean, with a shard down, through a replica failover and with every
  shard down.
- **Host logic bit for bit**: the compiled program, `merge_topk` /
  `pad_cols`, `RequestQueue`'s EDF and FIFO order and a seeded
  `make_requests` timeline equal the reference's exactly.
- **The port's own builds**: `build_shard_fleet` on the integer corpus
  gives the reference's shard graphs bit for bit on paired construction
  frontiers; the two fleets' recall@10 agree within 0.05 (their PQ
  codebooks differ).
- **Mirrors**: every test of tests/test_runtime.py, the frontend tests of
  tests/test_faults.py and tests/test_serve_engine.py, on the port alone,
  with ``device="cpu"``.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.build import BuildConfig as JaxBuildConfig
from repro.build import GraphBuilder as JaxGraphBuilder
from repro.core import engine as ref_engine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import ShardedFrontend as JaxFrontend
from repro.serve import runtime as ref_rt
from repro.serve.frontend import _merge_topk as jax_merge_topk
from repro.serve.frontend import _pad_cols as jax_pad_cols
from repro_torch.core.distances import exact_knn, recall_at_k
from repro_torch.core.engine import BAMGParams
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import (BatchedANNEngine, BeamTier, EngineConfig,
                               Scheduler, SchedulerConfig, ServeRuntime,
                               ShardedFrontend, build_shard_fleet,
                               make_requests)
from repro_torch.serve.frontend import _merge_topk, _pad_cols
from repro_torch.serve.runtime import (Opcode, Request, RequestQueue,
                                       compile_program, merge_topk,
                                       open_loop_arrivals, pad_cols)

CPU = "cpu"
K = 10
_CFG = EngineConfig(l=48, max_hops=24, backend="ref")
_JCFG = JaxConfig(l=48, max_hops=24, backend="ref")
_R16 = dict(r=16, l_build=32, seed=0)


def _engines(host_indexes, config=_CFG):
    """The port's engines on the reference shards' arrays."""
    return [BatchedANNEngine(idx.batch_arrays(), config, device=CPU)
            for idx in host_indexes]


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _legacy_scatter_gather(engines, luts, queries, k, skip=()):
    """The pre-runtime ShardedFrontend loop (tests/test_runtime.py's
    oracle) on the port's engines and merge."""
    queries = np.atleast_2d(queries)
    b = len(queries)
    all_ids, all_d = [], []
    for s, (lut, eng) in enumerate(zip(luts, engines)):
        if s in skip:
            continue
        ks = min(k, eng.rerank_capacity)
        ids_s, d_s = eng.search_batch(queries, ks)
        if ks < k:
            ids_s = np.concatenate(
                [ids_s, np.full((b, k - ks), -1, ids_s.dtype)], axis=1)
            d_s = np.concatenate(
                [d_s, np.full((b, k - ks), np.inf, d_s.dtype)], axis=1)
        all_ids.append(lut[ids_s])
        all_d.append(d_s)
    if all_ids:
        ids = np.concatenate(all_ids, axis=1)
        d = np.concatenate(all_d, axis=1)
    else:
        ids = np.full((b, k), -1, np.int64)
        d = np.full((b, k), np.inf, np.float64)
    gd, gi = _merge_topk(d, k)
    ids = _pad_cols(ids, k, -1)
    gids = np.take_along_axis(ids, gi, axis=1)
    return np.where(np.isfinite(gd), gids, -1), gd


@pytest.fixture(scope="module")
def jax_fleet(small_corpus):
    """The JAX fleet, built once: 3 shards of BAMGParams(r=16, l_build=32)."""
    return JaxFrontend.build(small_corpus.base, n_shards=3,
                             params=ref_engine.BAMGParams(**_R16),
                             config=_JCFG)


@pytest.fixture(scope="module")
def fleet(small_corpus, jax_fleet):
    """The port's frontend over the JAX shards' arrays."""
    fe = ShardedFrontend(jax_fleet.shard_vids,
                         _engines(jax_fleet.host_indexes), device=CPU)
    return small_corpus, fe


# ---------------------------------------------------------------------------
# parity with the JAX fleet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["clean", "shard_down", "failover",
                                  "all_down"])
def test_runtime_matches_jax_fleet(small_corpus, jax_fleet, case):
    ds = small_corpus
    n_rep = 2 if case == "failover" else 1
    jrt = ref_rt.ServeRuntime(jax_fleet.shard_vids, jax_fleet.engines,
                              n_replicas=n_rep)
    prt = ServeRuntime(jax_fleet.shard_vids,
                       _engines(jax_fleet.host_indexes), n_replicas=n_rep,
                       device=CPU)
    try:
        for rt in (jrt, prt):
            if case == "shard_down":
                rt.engines[1].inject_fault()
            elif case == "failover":
                rt.engines[0].inject_fault()
            elif case == "all_down":
                for s in range(rt.n_shards):
                    rt.mark_down(s)
        for _ in range(2 if case == "failover" else 1):
            got = prt.serve_batch(ds.queries, K, with_status=True)
            want = jrt.serve_batch(ds.queries, K, with_status=True)
            _assert_same(got, want)
            np.testing.assert_array_equal(got[2].degraded, want[2].degraded)
            assert got[2].shards_up == want[2].shards_up
            assert got[2].shards_down == want[2].shards_down
        hp, hj = prt.health(), jrt.health()
        for key in ("n_shards", "shards_up", "shards_down", "replicas",
                    "n_workers"):
            assert hp[key] == hj[key], key
        assert ([h["errors"] for h in hp["per_shard"]]
                == [h["errors"] for h in hj["per_shard"]])
        if case == "all_down":
            assert (got[0] == -1).all() and np.isinf(got[1]).all()
    finally:
        jax_fleet.engines[0].heal()
        jax_fleet.engines[1].heal()


def test_merge_and_pad_match_reference():
    rng = np.random.default_rng(0)
    for b, c, k in ((4, 30, 10), (3, 2, 5), (5, 12, 12), (2, 1, 1)):
        d = rng.integers(0, 6, (b, c)).astype(np.float64)   # ties
        d[rng.random((b, c)) < 0.2] = np.inf
        for got, want in zip(merge_topk(d, k), jax_merge_topk(d, k)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        ids = rng.integers(-1, 50, (b, c))
        np.testing.assert_array_equal(pad_cols(ids, k, -1),
                                      jax_pad_cols(ids, k, -1))
    for s in (1, 3, 7):
        assert ([(i.op.value, i.shard) for i in compile_program(s)]
                == [(i.op.value, i.shard)
                    for i in ref_rt.compile_program(s)])
        assert repr(compile_program(s)) == repr(ref_rt.compile_program(s))


def test_queue_order_matches_reference():
    """EDF with FIFO tie-breaks: the same pushes pop in the same order."""
    rng = np.random.default_rng(3)
    qs, jqs = RequestQueue(), ref_rt.RequestQueue()
    for i in range(60):
        a = float(rng.integers(0, 10))
        dl = a + float(rng.integers(1, 4))           # many equal deadlines
        rid = int(rng.integers(0, 1000))
        qs.push(Request(rid=rid, query=np.zeros(2), arrival=a, deadline=dl))
        jqs.push(ref_rt.Request(rid=rid, query=np.zeros(2), arrival=a,
                                deadline=dl))
    while len(jqs):
        assert qs.min_deadline() == jqs.min_deadline()
        got, want = qs.pop_batch(7), jqs.pop_batch(7)
        assert ([(r.rid, r.arrival, r.deadline) for r in got]
                == [(r.rid, r.arrival, r.deadline) for r in want])
    assert len(qs) == 0


@pytest.mark.parametrize("process", ["poisson", "uniform"])
def test_request_timeline_matches_reference(small_corpus, process):
    got = make_requests(small_corpus.queries, qps=250.0, slo=0.05, n=40,
                        seed=7, process=process)
    want = ref_rt.make_requests(small_corpus.queries, qps=250.0, slo=0.05,
                                n=40, seed=7, process=process)
    assert len(got) == len(want) == 40
    for a, b in zip(got, want):
        assert (a.rid, a.arrival, a.deadline) == (b.rid, b.arrival,
                                                  b.deadline)
        np.testing.assert_array_equal(a.query, b.query)
    np.testing.assert_array_equal(open_loop_arrivals(9, 3.0, seed=1),
                                  ref_rt.open_loop_arrivals(9, 3.0, seed=1))
    with pytest.raises(ValueError):
        open_loop_arrivals(3, 0.0)
    with pytest.raises(ValueError, match="process"):
        open_loop_arrivals(3, 1.0, process="bursty")


def _pair_frontier(monkeypatch, frontier):
    """Both packages' shard builds on one construction frontier (the
    pairing of tests/test_torch_disk_search.py): "fused_ref" leaves the
    port at its default ("fused", whose plain version runs on the CPU)
    and moves the reference to "fused_ref"; "batched" moves the port."""
    from repro_torch.build import BuildConfig, GraphBuilder
    from repro_torch.core import engine
    if frontier == "batched":
        def port_builder(p, device):
            return GraphBuilder(BuildConfig(
                backend=p.build_backend, batch_size=p.build_batch,
                knn_mode=p.build_knn, frontier_backend="batched"),
                device=device)
        monkeypatch.setattr(engine, "_builder_for", port_builder)
    else:
        def ref_builder(p):
            return JaxGraphBuilder(JaxBuildConfig(
                backend=p.build_backend, batch_size=p.build_batch,
                knn_mode=p.build_knn, frontier_backend="fused_ref"))
        monkeypatch.setattr(ref_engine, "_builder_for", ref_builder)


@pytest.mark.parametrize("frontier", ["fused_ref", "batched"])
def test_build_shard_fleet_graph_for_graph(small_corpus, monkeypatch,
                                           frontier):
    """The port's `build_shard_fleet` on the integer corpus: every shard's
    graph, blocks, members and entry equal the reference's -- 600 points
    in 3 shards, then 40 points in 4 shards, where r, knn_k and l_build
    clamp to the shard's size."""
    _pair_frontier(monkeypatch, frontier)
    x = np.round(small_corpus.base).astype(np.float32)
    kw = dict(r=12, l_build=24, knn_k=12, gamma=32, pq_m=8)
    for xs, s in ((x, 3), (x[:40], 4)):
        vids, engines, idxs = build_shard_fleet(
            xs, s, params=BAMGParams(**kw), config=_CFG, device=CPU)
        jv, je, jidx = ref_rt.build_shard_fleet(
            xs, s, params=ref_engine.BAMGParams(build_backend="batched",
                                                **kw), config=_JCFG)
        for a, b in zip(vids, jv):
            np.testing.assert_array_equal(a, b)
        for got, want in zip(idxs, jidx):
            assert got.params.r == want.params.r
            assert got.params.knn_k == want.params.knn_k
            assert got.params.l_build == want.params.l_build
            assert got.params.seed == want.params.seed
            for f in ("adj", "blocks", "members", "entry", "capacity"):
                np.testing.assert_array_equal(getattr(got.graph, f),
                                              getattr(want.graph, f))
        assert all(e.device.type == "cpu" for e in engines)
    # served: the two fleets' recall@10 on the float corpus within 0.05
    ds = small_corpus
    vids, engines, _ = build_shard_fleet(ds.base, 3,
                                         params=BAMGParams(**_R16),
                                         config=_CFG, device=CPU)
    ids, _ = ServeRuntime(vids, engines, device=CPU).serve_batch(
        ds.queries, K)
    jfe = JaxFrontend.build(ds.base, 3, params=ref_engine.BAMGParams(
        build_backend="batched", **_R16), config=_JCFG)
    jids, _ = jfe.search_batch(ds.queries, K)
    assert abs(recall_at_k(ids, ds.gt, K) - recall_at_k(jids, ds.gt, K)) \
        <= 0.05


def test_entry_points_default_to_the_card(small_corpus, jax_fleet):
    """`device=None` means the CUDA device: without one, placement and
    the mesh raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeRuntime(jax_fleet.shard_vids, _engines(jax_fleet.host_indexes))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_shard_fleet(small_corpus.base[:30], 2)


# ---------------------------------------------------------------------------
# mirrors of tests/test_runtime.py: instruction stream
# ---------------------------------------------------------------------------
def test_program_structure():
    prog = compile_program(3)
    ops = [ins.op for ins in prog]
    assert ops == [Opcode.SCATTER,
                   Opcode.RUN, Opcode.GATHER,
                   Opcode.RUN, Opcode.GATHER,
                   Opcode.RUN, Opcode.GATHER,
                   Opcode.MERGE]
    assert [ins.shard for ins in prog[1:-1]] == [0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError):
        compile_program(0)


def test_runtime_bit_identical_clean(fleet):
    ds, fe = fleet
    ids, dists = fe.search_batch(ds.queries, K)
    oids, od = _legacy_scatter_gather(fe.engines, fe._lut, ds.queries, K)
    np.testing.assert_array_equal(ids, oids)
    np.testing.assert_array_equal(dists, od)


def test_runtime_bit_identical_one_shard_down(fleet):
    ds, fe = fleet
    clean_ids, _ = fe.search_batch(ds.queries, K)
    fe.engines[1].inject_fault()
    try:
        ids, dists, st = fe.search_batch(ds.queries, K, with_status=True)
        assert st.degraded.all() and st.shards_down == (1,)
        fe.engines[1].heal()
        oids, od = _legacy_scatter_gather(fe.engines, fe._lut, ds.queries, K,
                                          skip={1})
        np.testing.assert_array_equal(ids, oids)
        np.testing.assert_array_equal(dists, od)
    finally:
        fe.engines[1].heal()
        fe.mark_up(1)
    rids, _ = fe.search_batch(ds.queries, K)
    np.testing.assert_array_equal(rids, clean_ids)


def test_masked_shard_engine_not_called(fleet):
    ds, fe = fleet
    calls = {"n": 0}
    orig = fe.engines[0].search_batch

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    fe.engines[0].search_batch = counting
    fe.mark_down(0)
    try:
        ids, _, st = fe.search_batch(ds.queries, K, with_status=True)
        assert calls["n"] == 0 and 0 in st.shards_down
        assert (ids >= -1).all()
    finally:
        del fe.engines[0].search_batch
        fe.mark_up(0)


def test_replica_failover_keeps_shard_up(fleet):
    ds, fe = fleet
    rt = ServeRuntime(fe.shard_vids, fe.engines,
                      host_indexes=fe.host_indexes, n_replicas=2, device=CPU)
    clean_ids, clean_d = rt.serve_batch(ds.queries, K)
    rt.engines[0].inject_fault()
    try:
        for _ in range(2):
            ids, dists, st = rt.serve_batch(ds.queries, K, with_status=True)
            assert not st.degraded.any() and st.shards_up == rt.n_shards
            np.testing.assert_array_equal(ids, clean_ids)
            np.testing.assert_array_equal(dists, clean_d)
        h = rt.health()
        assert h["shards_up"] == rt.n_shards
        assert h["per_shard"][0]["errors"] >= 1
        assert h["replicas"][0] == [False, True]
        # one CPU device: every replica sits on the one worker and shares
        # its shard's arrays (the copy costs no memory)
        assert h["n_workers"] == 1
        a, b = rt.placement.shard_replicas[0]
        assert a.engine is not b.engine and a.engine.x is b.engine.x
    finally:
        rt.engines[0].heal()
        rt.mark_up(0)


def test_runtime_all_shards_down(fleet):
    ds, fe = fleet
    rt = fe.runtime
    for s in range(rt.n_shards):
        rt.mark_down(s)
    try:
        ids, d, st = rt.serve_batch(ds.queries, K, with_status=True)
        assert (ids == -1).all() and np.isinf(d).all() and st.shards_up == 0
    finally:
        for s in range(rt.n_shards):
            rt.mark_up(s)


# ---------------------------------------------------------------------------
# mirrors of tests/test_runtime.py: continuous-batching scheduler
# ---------------------------------------------------------------------------
def test_queue_no_deadline_inversion():
    rng = np.random.default_rng(0)
    q = RequestQueue()
    for i in range(50):
        a = float(rng.uniform(0, 1))
        q.push(Request(rid=i, query=np.zeros(4), arrival=a,
                       deadline=a + float(rng.uniform(0.01, 2.0))))
    popped = q.pop_batch(16)
    assert len(popped) == 16 and len(q) == 34
    assert max(r.deadline for r in popped) <= q.min_deadline()


def test_formation_urgent_tier_first(fleet):
    _, fe = fleet
    sched = Scheduler(fe.runtime, SchedulerConfig(k=K, max_batch=8, slo=1.0,
                                                  shrink_slack=0.5))
    for i, dl in enumerate((0.1, 2.0, 0.2, 3.0)):
        sched.queue.push(Request(rid=i, query=np.zeros(4), arrival=0.0,
                                 deadline=dl))
    batches = sched.form_microbatches(0.0)
    assert [t for t, _ in batches] == [1, 0]
    assert sorted(r.rid for r in batches[0][1]) == [0, 2]
    assert sorted(r.rid for r in batches[1][1]) == [1, 3]


def test_slo_shrunk_beam_valid_topk(fleet):
    ds, fe = fleet
    sched = Scheduler(fe.runtime,
                      SchedulerConfig(k=K, max_batch=8, slo=1e-6,
                                      tiers=(BeamTier(),
                                             BeamTier(l=16, max_hops=4))))
    reqs = [Request(rid=i, query=q, arrival=0.0, deadline=0.0)
            for i, q in enumerate(ds.queries[:8])]
    done = sched.run(reqs)
    assert len(done) == 8
    for c in done:
        assert c.tier == 1 and c.degraded
        assert c.ids.shape == (K,) and (c.ids >= 0).all()
        assert (c.ids < len(ds.base)).all()
        assert (np.diff(c.dists) >= 0).all()


def test_low_load_matches_unscheduled(fleet):
    ds, fe = fleet
    ref_ids, ref_d = fe.runtime.serve_batch(ds.queries, K)
    sched = Scheduler(fe.runtime, SchedulerConfig(k=K, max_batch=4,
                                                  slo=1e4))
    reqs = make_requests(ds.queries, qps=50.0, slo=1e4,
                         n=len(ds.queries), seed=2)
    done = sched.run(reqs)
    assert all(c.tier == 0 and not c.degraded for c in done)
    np.testing.assert_array_equal(np.stack([c.ids for c in done]), ref_ids)
    np.testing.assert_array_equal(np.stack([c.dists for c in done]), ref_d)


# ---------------------------------------------------------------------------
# mirrors of tests/test_runtime.py: mesh validation, default instances
# ---------------------------------------------------------------------------
def test_make_host_mesh_validates_axis_sizes():
    n = 1                                   # "cpu": one device
    with pytest.raises(ValueError, match="zero-sized"):
        make_host_mesh(model=n + 1, device=CPU)
    with pytest.raises(ValueError, match="axis sizes must be >= 1"):
        make_host_mesh(model=1, data=0, device=CPU)
    with pytest.raises(ValueError, match="axis sizes must be >= 1"):
        make_host_mesh(model=0, device=CPU)
    with pytest.raises(ValueError, match="needs"):
        make_host_mesh(model=1, data=n + 1, device=CPU)
    mesh = make_host_mesh(device=CPU)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (1, 1)
    assert mesh.devices[0, 0] == torch.device("cpu")


def test_no_shared_dataclass_instance_defaults(tiny_points):
    from repro_torch.serve.deploy import BlueGreenEngine, DeploymentManager
    targets = [ShardedFrontend.build, BatchedANNEngine.__init__,
               BatchedANNEngine.from_index, DeploymentManager.validate,
               DeploymentManager.deploy, BlueGreenEngine.__init__,
               ServeRuntime.build, Scheduler.__init__]
    for fn in targets:
        for name, p in inspect.signature(fn).parameters.items():
            if p.default is inspect.Parameter.empty:
                continue
            assert not dataclasses.is_dataclass(p.default), \
                f"{fn.__qualname__}({name}=...) shares one dataclass " \
                f"instance across calls; default to None instead"
    kw = dict(params=BAMGParams(r=8, l_build=16, knn_k=8), device=CPU)
    a = ShardedFrontend.build(tiny_points, 2, **kw)
    b = ShardedFrontend.build(tiny_points, 2, **kw)
    assert a.engines[0].config is not b.engines[0].config


def test_compiled_merge_fewer_candidates_than_k(fleet):
    ds, fe = fleet
    rt = fe.runtime
    small_l = 4
    n_valid = rt.engines[0].effective_rerank(small_l)
    assert n_valid < K
    for s in (1, 2):
        rt.mark_down(s)
    try:
        ids, d, st = rt.serve_batch(ds.queries, K, with_status=True,
                                    l=small_l)
        assert st.shards_up == 1 and st.degraded.all()
        assert ids.shape == (len(ds.queries), K)
        assert (ids[:, :n_valid] >= 0).all()
        assert (ids[:, n_valid:] == -1).all()
        assert np.isinf(d[:, n_valid:]).all()
        assert (np.diff(d[:, :n_valid], axis=1) >= 0).all()
        oids, od = fe.engines[0].search_batch(ds.queries, n_valid, l=small_l)
        np.testing.assert_array_equal(ids[:, :n_valid],
                                      fe._lut[0][np.asarray(oids)])
        np.testing.assert_array_equal(d[:, :n_valid], od)
    finally:
        rt.mark_up(1)
        rt.mark_up(2)


def test_queue_same_deadline_fifo_by_arrival():
    q = RequestQueue()
    rids = [5, 3, 9, 1, 7, 0, 8, 2]
    for i, rid in enumerate(rids):
        q.push(Request(rid=rid, query=np.zeros(4, np.float32),
                       arrival=float(i), deadline=1.0))
    out = q.pop_batch(len(rids))
    assert [r.rid for r in out] == rids


def test_queue_edf_dominates_then_fifo_breaks_ties():
    q = RequestQueue()
    seq = [(9, 2.0), (4, 1.0), (7, 2.0), (1, 1.0), (8, 3.0), (0, 2.0)]
    for i, (rid, dl) in enumerate(seq):
        q.push(Request(rid=rid, query=np.zeros(2, np.float32),
                       arrival=float(i), deadline=dl))
    got = [(r.deadline, r.rid) for r in q.pop_batch(len(seq))]
    assert got == [(1.0, 4), (1.0, 1), (2.0, 9), (2.0, 7), (2.0, 0),
                   (3.0, 8)]
    assert len(q) == 0


# ---------------------------------------------------------------------------
# mirrors of the frontend tests of tests/test_faults.py and
# tests/test_serve_engine.py
# ---------------------------------------------------------------------------
def test_merge_topk_fewer_candidates_than_k():
    d = np.array([[3.0, 1.0], [np.inf, 2.0]])
    gd, gi = _merge_topk(d, 5)
    assert gd.shape == (2, 5)
    assert gd[0, 0] == 1.0 and gd[0, 1] == 3.0 and np.isinf(gd[0, 2:]).all()
    assert gd[1, 0] == 2.0 and np.isinf(gd[1, 1:]).all()


@pytest.fixture(scope="module")
def frontend(jax_fleet):
    """tests/test_faults.py's frontend config (l = 32, 16 hops) on the
    reference shards' arrays."""
    cfg = EngineConfig(l=32, max_hops=16, backend="ref")
    return ShardedFrontend(jax_fleet.shard_vids,
                           _engines(jax_fleet.host_indexes, cfg), device=CPU)


def test_frontend_small_shards_padded():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    fe = ShardedFrontend.build(x, n_shards=4,
                               config=EngineConfig(l=5, max_hops=8,
                                                   backend="ref"),
                               device=CPU)
    k = 12
    ids, d = fe.search_batch(q, k)
    assert ids.shape == (4, k) and d.shape == (4, k)
    gt = exact_knn(torch.from_numpy(x), torch.from_numpy(q), k)[1].numpy()
    assert recall_at_k(ids, gt, k) >= 0.9
    order = np.argsort(d, axis=1, kind="stable")
    np.testing.assert_array_equal(order, np.tile(np.arange(k), (4, 1)))


def test_frontend_dead_shard_skip_and_recover(frontend, small_corpus):
    ds = small_corpus
    clean_ids, _ = frontend.search_batch(ds.queries, K)
    clean_rec = recall_at_k(clean_ids, ds.gt, K)
    frontend.engines[1].inject_fault()
    ids, d, st = frontend.search_batch(ds.queries, K, with_status=True)
    assert st.degraded.all() and st.shards_down == (1,)
    assert frontend.health()["shards_down"] == [1]
    assert frontend.health()["per_shard"][1]["errors"] == 1
    deg_rec = recall_at_k(ids, ds.gt, K)
    assert 0 < deg_rec < clean_rec
    ids2, _, st2 = frontend.search_batch(ds.queries, K, with_status=True)
    assert frontend.health()["per_shard"][1]["errors"] == 1
    np.testing.assert_array_equal(ids, ids2)
    frontend.engines[1].heal()
    frontend.mark_up(1)
    ids3, _, st3 = frontend.search_batch(ds.queries, K, with_status=True)
    assert not st3.degraded.any()
    np.testing.assert_array_equal(ids3, clean_ids)


def test_frontend_all_shards_down(frontend, small_corpus):
    for s in range(frontend.n_shards):
        frontend.mark_down(s)
    ids, d, st = frontend.search_batch(small_corpus.queries, K,
                                       with_status=True)
    assert (ids == -1).all() and np.isinf(d).all() and st.shards_up == 0
    for s in range(frontend.n_shards):
        frontend.mark_up(s)


def test_frontend_shard_smaller_than_k(small_corpus):
    ds = small_corpus
    small = ds.base[:75]
    fe = ShardedFrontend.build(
        small, n_shards=8,
        params=BAMGParams(alpha=3, beta=1.05, r=8, l_build=16, knn_k=8),
        config=EngineConfig(l=75, max_hops=75), device=CPU)
    ids, dists = fe.search_batch(ds.queries, K)
    assert ids.shape == (len(ds.queries), K)
    assert (ids >= 0).all() and np.isfinite(dists).all()
    _, gi = exact_knn(torch.from_numpy(small), torch.from_numpy(ds.queries),
                      K)
    np.testing.assert_array_equal(ids, gi.numpy())


def test_sharded_frontend_matches_global_brute_force(small_corpus):
    ds = small_corpus
    n = len(ds.base)
    fe = ShardedFrontend.build(
        ds.base, n_shards=2,
        params=BAMGParams(alpha=3, beta=1.05, r=16, l_build=32, knn_k=16),
        config=EngineConfig(l=n, max_hops=n), device=CPU)
    ids, dists = fe.search_batch(ds.queries, K)
    _, gi = exact_knn(torch.from_numpy(ds.base),
                      torch.from_numpy(ds.queries), K)
    np.testing.assert_array_equal(ids, gi.numpy())
    assert (np.diff(dists, axis=1) >= 0).all()
