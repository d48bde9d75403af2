"""The port's disk-resident index (`repro_torch.core.{search,engine}`,
`serve.BatchedANNEngine.from_index`) against the JAX package's.

- **Mirrors**: tests/test_search.py, the engine parts of
  tests/test_faults.py and test_build_parity.py's backend-knob test, on
  the port's own indexes built with ``device="cpu"``.
- **Parity through the npz**: the reference builds and saves a BAMG; the
  port loads it.  Every query's `SearchResult` and the `BatchStats` must
  be *identical* (no tolerance: ids, dists bitwise, NIO, reads, hops,
  n_dist, n_pq, cache hits, service and serial microseconds) in every
  search mode and I/O configuration.  Both searches get the reference's
  ADC tables: tables computed by torch and by JAX may differ in the last
  bit, and one ulp can reorder a pool.  Where codebooks and queries are
  integers the port computes its own tables, and those equal the
  reference's bitwise.
- **DiskANN and Starling** cross through the constructors both packages
  share (the reference's arrays, the port's `CoupledStorage`), same bar.
- **Builds**: on the integer corpus the port's `build` gives the
  reference's graph, blocks, members, entry and nav layers bit for bit,
  when both sides run the same construction frontier (the pairing of
  test_torch_build.py): the port's default "fused" frontier runs its plain
  version on the CPU and is paired with the reference's "fused_ref"; the
  reference's default "batched" is paired with the port's "batched".  PQ
  training is not bit-identical across frameworks, so codebooks are held
  only to quantization error <= 1.02x the reference's, and recall on the
  float corpus to the reference's own budget (0.01).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.build import BuildConfig as JaxBuildConfig
from repro.build import GraphBuilder as JaxGraphBuilder
from repro.core import engine as ref_engine
from repro.serve.ann_engine import BatchedANNEngine as JaxEngine
from repro.serve.ann_engine import EngineConfig as JaxEngineConfig
from repro.utils import faults as ref_faults
from repro_torch.build import BuildConfig, GraphBuilder
from repro_torch.core import engine
from repro_torch.core.engine import (BAMGIndex, BAMGParams, DiskANNIndex,
                                     DiskANNParams, StarlingIndex,
                                     StarlingParams)
from repro_torch.core.pq import PQCodec
from repro_torch.core.storage import CoupledStorage
from repro_torch.serve import BatchedANNEngine, EngineConfig
from repro_torch.utils.faults import FaultSpec, RetryPolicy

CPU = "cpu"
K, L = 10, 48


def _same_result(a, b, what=""):
    """Two `SearchResult`s (either package's) equal field by field, with
    equal dtypes; floats bitwise."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for key in da:
        u, v = np.asarray(da[key]), np.asarray(db[key])
        assert u.dtype == v.dtype, (what, key)
        np.testing.assert_array_equal(u, v, err_msg=f"{what} {key}")


def _same_stats(a, b, what=""):
    """Two `BatchStats` equal field by field (floats bitwise)."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b), what


def _codec(ref_idx):
    """The port's codec on the CPU with the reference index's codebooks."""
    return PQCodec(codebooks=torch.from_numpy(ref_idx.codec.codebooks.copy()))


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def int_corpus(small_corpus):
    """The shared clustered corpus rounded to integers: every squared
    distance is exact in f32, and rounding makes ties."""
    return np.round(small_corpus.base).astype(np.float32)


_R16 = dict(alpha=3, beta=1.05, r=16, l_build=32, knn_k=16)


@pytest.fixture(scope="module")
def indexes(small_corpus):
    """The port's BAMG as tests/test_search.py builds it."""
    return small_corpus, BAMGIndex.build(small_corpus.base,
                                         BAMGParams(**_R16), device=CPU)


@pytest.fixture(scope="module")
def r16_baselines(small_corpus):
    x = small_corpus.base
    return (DiskANNIndex.build(x, DiskANNParams(r=16, l_build=32),
                               device=CPU),
            StarlingIndex.build(x, StarlingParams(r=16, l_build=32),
                                device=CPU))


@pytest.fixture(scope="module")
def bamg(small_corpus):
    return BAMGIndex.build(small_corpus.base, BAMGParams(seed=0), device=CPU)


# The coupled fault mirrors reuse the R = 16 baselines above (each test
# puts the I/O settings back as it found them): two Vamana builds at the
# reference's R = 32 took most of this module's time.
@pytest.fixture(scope="module")
def diskann(r16_baselines):
    return r16_baselines[0]


@pytest.fixture(scope="module")
def starling(r16_baselines):
    return r16_baselines[1]


@pytest.fixture(scope="module")
def ref_pair(small_corpus, tmp_path_factory):
    """A reference BAMG, its npz, the port's index loaded from it, and the
    reference's ADC tables of the shared queries."""
    ds = small_corpus
    ref = ref_engine.BAMGIndex.build(ds.base, ref_engine.BAMGParams(**_R16))
    path = str(tmp_path_factory.mktemp("npz") / "ref.npz")
    ref.save(path)
    port = BAMGIndex.load(path, device=CPU)
    return ref, port, path, ref.codec.adc_tables(ds.queries)


@pytest.fixture(scope="module")
def ref_coupled(small_corpus):
    """Reference DiskANN and Starling indexes and the port's, carried
    across through the shared constructors."""
    x = small_corpus.base
    rd = ref_engine.DiskANNIndex.build(
        x, ref_engine.DiskANNParams(r=16, l_build=32))
    rs = ref_engine.StarlingIndex.build(
        x, ref_engine.StarlingParams(r=16, l_build=32))
    pd = DiskANNIndex(rd.x, rd.adj, rd.entry, _codec(rd), rd.codes,
                      CoupledStorage(rd.x, rd.adj),
                      DiskANNParams(r=16, l_build=32))
    ps = StarlingIndex(rs.x, rs.adj, rs.entry, _codec(rs), rs.codes,
                       CoupledStorage(rs.x, rs.adj, order=rs.store.layout),
                       rs.nav_vids, rs.nav_adj,
                       StarlingParams(r=16, l_build=32))
    return {"diskann": (rd, pd), "starling": (rs, ps)}


def _batch(idx, ds, **kw):
    return idx.search_batch(ds.queries, k=K, l=L, gt=ds.gt, **kw)


def _ids(idx, ds):
    return np.stack([np.pad(r.ids[:K], (0, K - min(K, len(r.ids))),
                            constant_values=-1)
                     for r in (idx.search(q, k=K, l=L) for q in ds.queries)])


# ---------------------------------------------------------------------------
# tests/test_search.py on the port
# ---------------------------------------------------------------------------
def test_bamg_recall_and_io_accounting(indexes):
    ds, idx = indexes
    st = idx.search_batch(ds.queries, k=10, l=48, gt=ds.gt)
    assert st.recall >= 0.9, st
    assert st.mean_graph_reads > 0 and st.mean_vector_reads > 0
    assert st.mean_nio == pytest.approx(
        st.mean_graph_reads + st.mean_vector_reads)


def test_bamg_recall_improves_with_l(indexes):
    ds, idx = indexes
    lo = idx.search_batch(ds.queries, k=10, l=12, gt=ds.gt)
    hi = idx.search_batch(ds.queries, k=10, l=64, gt=ds.gt)
    assert hi.recall >= lo.recall
    assert hi.mean_nio >= lo.mean_nio


def test_early_stop_rerank_cuts_vector_reads(indexes):
    ds, idx = indexes
    base = idx.search_batch(ds.queries, k=10, l=64, gt=ds.gt)
    es = idx.search_batch(ds.queries, k=10, l=64, gt=ds.gt,
                          rerank_margin=1.3)
    assert es.mean_vector_reads <= base.mean_vector_reads
    assert es.recall >= base.recall - 0.1


def test_nav_graph_beats_random_entry(indexes):
    ds, idx = indexes
    nav = idx.search_batch(ds.queries, k=10, l=24, gt=ds.gt)
    rnd = idx.search_batch(ds.queries, k=10, l=24, gt=ds.gt,
                           random_entry=True)
    assert nav.mean_hops <= rnd.mean_hops + 2


def test_ablation_no_bmrng_prune_denser_graph(small_corpus, indexes):
    ds, pruned = indexes
    dense = BAMGIndex.build(ds.base, BAMGParams(r=16, l_build=32, knn_k=16,
                                                use_bmrng_prune=False),
                            device=CPU)
    assert (pruned.degree_stats()["total"]
            <= dense.degree_stats()["total"] + 1e-9)
    st = dense.search_batch(ds.queries, k=10, l=48, gt=ds.gt)
    assert st.recall > 0.85


def test_baselines_recall(small_corpus, r16_baselines):
    ds = small_corpus
    da, sl = r16_baselines
    for idx in (da, sl):
        st = idx.search_batch(ds.queries, k=10, l=48, gt=ds.gt)
        assert st.recall >= 0.9, type(idx).__name__
    s_st = sl.search_batch(ds.queries, k=10, l=48, gt=ds.gt)
    d_st = da.search_batch(ds.queries, k=10, l=48, gt=ds.gt)
    assert s_st.mean_nio <= d_st.mean_nio


def test_bamg_fewer_graph_reads_than_starling_total(small_corpus, indexes,
                                                    r16_baselines):
    """Decoupling multiplies nodes/block, so BAMG needs fewer *graph* I/Os
    than Starling needs total I/Os."""
    ds, bamg16 = indexes
    b = bamg16.search_batch(ds.queries, k=10, l=48, gt=ds.gt)
    s = r16_baselines[1].search_batch(ds.queries, k=10, l=48, gt=ds.gt)
    assert b.mean_graph_reads < s.mean_nio


def test_save_load_roundtrip(indexes, tmp_path):
    ds, idx = indexes
    path = os.path.join(tmp_path, "idx.npz")
    idx.save(path)
    idx2 = BAMGIndex.load(path, device=CPU)
    r1 = idx.search(ds.queries[0], k=5, l=24)
    r2 = idx2.search(ds.queries[0], k=5, l=24)
    np.testing.assert_array_equal(r1.ids, r2.ids)
    assert r1.nio == r2.nio
    _same_result(r1, r2)


def test_alpha_controls_intra_block_depth(indexes):
    ds, idx = indexes
    a1 = idx.search_batch(ds.queries, k=10, l=32, gt=ds.gt, alpha=1)
    a4 = idx.search_batch(ds.queries, k=10, l=32, gt=ds.gt, alpha=4)
    assert a4.mean_graph_reads <= a1.mean_graph_reads + 3


def test_engine_builds_accept_backend_knob(small_corpus):
    """test_build_parity.py's knob test on the port: the batched build
    without a nav graph recalls as the reference demands of its own."""
    ds = small_corpus
    idx = BAMGIndex.build(ds.base, BAMGParams(
        alpha=3, beta=1.05, r=16, l_build=32, knn_k=16, use_nav=False,
        build_backend="batched"), device=CPU)
    st = idx.search_batch(ds.queries, k=10, l=64, gt=ds.gt)
    assert st.recall >= 0.9, st
    assert BAMGParams().build_backend == "batched"
    assert ref_engine.BAMGParams().build_backend == "host"


# ---------------------------------------------------------------------------
# tests/test_faults.py (engine parts) on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["bamg", "diskann", "starling"])
def test_zero_rate_plan_bit_identical(which, small_corpus, request):
    idx = request.getfixturevalue(which)
    ds = small_corpus
    idx.configure_io(faults=None, retry=None, timeout_us=None, hedge_us=None)
    clean, clean_ids = _batch(idx, ds), _ids(idx, ds)
    idx.configure_io(faults=FaultSpec(), retry=RetryPolicy(budget=4),
                     timeout_us=10_000.0, hedge_us=200.0)
    z, z_ids = _batch(idx, ds), _ids(idx, ds)
    assert (z.recall, z.mean_nio, z.cache_hit_rate) == \
           (clean.recall, clean.mean_nio, clean.cache_hit_rate)
    assert (z.mean_service_us, z.mean_serial_us) == \
           (clean.mean_service_us, clean.mean_serial_us)
    assert z.mean_retries == 0 and z.mean_hedges == 0
    assert z.degraded_fraction == 0 and z.mean_failed_reads == 0
    np.testing.assert_array_equal(z_ids, clean_ids)
    idx.configure_io(faults=None, retry=None, timeout_us=None, hedge_us=None)


def test_transient_errors_retried_to_identical_answers(bamg, small_corpus):
    ds = small_corpus
    bamg.configure_io(faults=None, retry=None, timeout_us=None, hedge_us=None)
    clean, clean_ids = _batch(bamg, ds), _ids(bamg, ds)
    bamg.configure_io(faults=FaultSpec(read_error_rate=0.01), fault_seed=5)
    a = _batch(bamg, ds)
    assert a.degraded_fraction <= 0.05
    assert a.recall == clean.recall
    bamg.configure_io(faults=FaultSpec(read_error_rate=0.05), fault_seed=5)
    f, f_ids = _batch(bamg, ds), _ids(bamg, ds)
    assert f.degraded_fraction <= 0.05
    assert f.mean_retries > 0
    assert f.mean_nio == clean.mean_nio
    assert f.recall == clean.recall
    np.testing.assert_array_equal(f_ids, clean_ids)
    assert f.mean_service_us > clean.mean_service_us
    bamg.configure_io(faults=None)


def test_corruption_detected_and_reread(bamg, small_corpus):
    ds = small_corpus
    bamg.configure_io(faults=FaultSpec(corrupt_rate=0.05), fault_seed=9)
    r = bamg.search_batch(ds.queries, k=K, l=L, gt=ds.gt)
    total_csf = sum(bamg.search(q, k=K, l=L).checksum_failures
                    for q in ds.queries)
    assert total_csf > 0
    assert r.degraded_fraction <= 0.05
    bamg.configure_io(faults=None)


def test_dead_blocks_degrade_not_crash(bamg, small_corpus):
    ds = small_corpus
    bamg.configure_io(faults=FaultSpec(dead_rate=0.05, read_error_rate=0.02),
                      fault_seed=1, retry=RetryPolicy(budget=2))
    r = _batch(bamg, ds)
    assert r.mean_failed_reads > 0
    assert r.degraded_fraction > 0
    assert r.recall > 0.5
    res = bamg.search(ds.queries[0], k=K, l=L)
    assert res.degraded == (res.failed_reads > 0)
    bamg.configure_io(faults=None, retry=None)


def test_hedge_and_timeout_counters(bamg, small_corpus):
    ds = small_corpus
    bamg.configure_io(faults=FaultSpec(spike_rate=0.3, spike_us=5000.0),
                      fault_seed=2, hedge_us=100.0)
    r = _batch(bamg, ds)
    assert r.mean_hedges > 0
    assert r.degraded_fraction == 0
    bamg.configure_io(faults=FaultSpec(spike_rate=0.3, spike_us=5000.0),
                      fault_seed=2, hedge_us=None, timeout_us=500.0)
    t = _batch(bamg, ds)
    assert t.mean_retries > 0
    bamg.configure_io(faults=None, timeout_us=None)


def test_service_time_invariant_holds_under_faults(bamg, small_corpus):
    ds = small_corpus
    bamg.configure_io(faults=FaultSpec(read_error_rate=0.05, spike_rate=0.2),
                      fault_seed=4, qd=8, batch_io=True)
    for q in ds.queries:
        r = bamg.search(q, k=K, l=L)
        assert r.service_us <= r.serial_us + 1e-6
    bamg.configure_io(faults=None, qd=1, batch_io=False)


def test_device_checksums_verify_both_layouts(bamg, diskann):
    gdev = bamg.store.graph_dev
    for b in range(min(8, len(gdev))):
        assert gdev.verify(b)
        assert not gdev.verify(b, gdev.attempt_payload(b, corrupt=True,
                                                       salt=1))
    vdev = bamg.store.vector_dev
    for b in range(min(8, len(vdev))):
        assert vdev.verify(b)
        assert not vdev.verify(b, vdev.attempt_payload(b, corrupt=True))
    cdev = diskann.store.device
    for b in range(min(8, len(cdev))):
        assert cdev.verify(b)
        assert not cdev.verify(b, cdev.attempt_payload(b, corrupt=True))


@pytest.mark.parametrize("which", ["bamg", "diskann", "starling"])
def test_deleted_ids_never_surface_under_faults(which, small_corpus, request):
    idx = request.getfixturevalue(which)
    ds = small_corpus
    dead = set(ds.gt[:, 0].astype(int).tolist())
    idx.configure_io(faults=FaultSpec(dead_rate=0.15, read_error_rate=0.05),
                     fault_seed=3)
    try:
        n_degraded = 0
        for q in ds.queries:
            r = idx.search(q, k=K, l=L, exclude=dead)
            assert not (set(r.ids.tolist()) & dead)
            n_degraded += bool(r.degraded)
        assert n_degraded > 0
    finally:
        idx.configure_io(faults=None, retry=None)
    r = idx.search(ds.queries[0], k=K, l=L, exclude=dead)
    assert not r.degraded and not (set(r.ids.tolist()) & dead)


# ---------------------------------------------------------------------------
# Parity with the reference: the same index, the same tables
# ---------------------------------------------------------------------------
_MODES = {
    "plain": ({}, False),
    "rerank_margin": (dict(rerank_margin=1.3), False),
    "batch_io": (dict(batch_io=True), False),
    "warm_cache": ({}, True),
    "exclude": (dict(exclude="gt0"), False),
    "random_entry": (dict(random_entry=True), False),
    "max_hops_alpha": (dict(max_hops=6, alpha=1), False),
}


def _mode_kwargs(mode, ds):
    kw, warm = _MODES[mode]
    kw = dict(kw)
    if kw.get("exclude") == "gt0":
        kw["exclude"] = set(ds.gt[:, 0].astype(int).tolist())
    return kw, warm


def _per_query(idx, ds, tables, l, kw, warm, ref: bool):
    """Every query through `search`, with the pattern of cache drops and
    random-entry seeds that `search_batch` uses."""
    kw = dict(kw)
    random_entry = kw.pop("random_entry", False)
    out = []
    for i, (q, t) in enumerate(zip(ds.queries, tables)):
        extra = dict(random_entry_seed=i if random_entry else None,
                     drop_cache=(not warm) or i == 0)
        if not ref:
            extra["table"] = t
        out.append(idx.search(q, K, l, **kw, **extra))
    return out


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("l", (16, 64))
def test_bamg_search_identical_to_reference(ref_pair, small_corpus, mode, l):
    """The reference's npz loaded into the port: each query's
    `SearchResult` and the batch's `BatchStats` are the reference's, in
    every search mode, at L = 16 and 64."""
    ref, port, _, tables = ref_pair
    ds = small_corpus
    kw, warm = _mode_kwargs(mode, ds)
    # the reference's `search` computes its own table: the same values as
    # `tables`, which the port is handed
    assert np.array_equal(ref.codec.adc_table(ds.queries[0]), tables[0])
    want = _per_query(ref, ds, tables, l, kw, warm, ref=True)
    got = _per_query(port, ds, tables, l, kw, warm, ref=False)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_result(a, b, f"{mode} query {i}")
    _same_stats(port.search_batch(ds.queries, K, l, gt=ds.gt, tables=tables,
                                  warm_cache=warm, **kw),
                ref.search_batch(ds.queries, K, l, gt=ds.gt,
                                 warm_cache=warm, **kw), mode)


_IO = {
    "fifo_qd4_batched": dict(cache_policy="fifo", qd=4, batch_io=True),
    "clock_pins_small": dict(cache_policy="clock", cache_blocks=6,
                             pin_nav_blocks=3),
    "2q_vec_lru": dict(cache_policy="2q", vec_cache_policy="lru",
                       vec_cache_blocks=5, qd=2),
    "lru_faults": dict(cache_policy="lru", cache_blocks=8, qd=3,
                       batch_io=True,
                       faults=dict(read_error_rate=0.05, dead_rate=0.02,
                                   corrupt_rate=0.03, spike_rate=0.2),
                       fault_seed=6, retry=dict(budget=2),
                       hedge_us=300.0, timeout_us=4000.0),
}


def _io_kwargs(cfg, ref: bool):
    """`configure_io` arguments for one package (its own FaultSpec and
    RetryPolicy classes)."""
    kw = dict(cfg)
    if "faults" in kw:
        kw["faults"] = (ref_faults.FaultSpec if ref else FaultSpec)(
            **kw["faults"])
    if "retry" in kw:
        kw["retry"] = (ref_faults.RetryPolicy if ref else RetryPolicy)(
            **kw["retry"])
    return kw


def _restore_io(idx, coupled=False):
    kw = dict(cache_policy="lru", cache_blocks=256, qd=1, batch_io=False,
              faults=None, retry=None, timeout_us=None, hedge_us=None)
    if not coupled:
        kw.update(vec_cache_policy="lru", vec_cache_blocks=256,
                  pin_nav_blocks=0)
    idx.configure_io(**kw)


@pytest.mark.parametrize("cfg", list(_IO))
def test_bamg_configure_io_identical_to_reference(ref_pair, small_corpus,
                                                  cfg):
    """`configure_io` sweeps (cache policy, qd, pins, a fault plan with
    retries, hedges and timeouts) leave the two indexes answering alike."""
    ref, port, _, tables = ref_pair
    ds = small_corpus
    ref.configure_io(**_io_kwargs(_IO[cfg], ref=True))
    port.configure_io(**_io_kwargs(_IO[cfg], ref=False))
    try:
        assert port.store.graph_dev.pinned == ref.store.graph_dev.pinned
        for i, (q, t) in enumerate(zip(ds.queries, tables)):
            _same_result(port.search(q, K, L, table=t), ref.search(q, K, L),
                         f"{cfg} query {i}")
        _same_stats(port.search_batch(ds.queries, K, L, gt=ds.gt,
                                      tables=tables),
                    ref.search_batch(ds.queries, K, L, gt=ds.gt), cfg)
    finally:
        _restore_io(ref)
        _restore_io(port)


def test_port_tables_equal_reference_on_integer_codebooks(ref_pair,
                                                          small_corpus):
    """With integer codebooks and queries every table entry is exact, so
    the port's own tables (one `adc_tables` call on its device) equal the
    reference's and the whole search matches without handing tables
    over."""
    ref, _, path, _ = ref_pair
    ds = small_corpus
    port = BAMGIndex.load(path, device=CPU)
    r2 = ref_engine.BAMGIndex.load(path)
    cb = np.round(r2.codec.codebooks).astype(np.float32)
    r2.codec.codebooks = cb
    port.codec = PQCodec(codebooks=torch.from_numpy(cb.copy()))
    qs = np.round(ds.queries).astype(np.float32)
    np.testing.assert_array_equal(engine._tables(port.codec, qs),
                                  r2.codec.adc_tables(qs))
    for q in qs:
        _same_result(port.search(q, K, L), r2.search(q, K, L))
    _same_stats(port.search_batch(qs, K, L, gt=ds.gt),
                r2.search_batch(qs, K, L, gt=ds.gt))


def test_search_batch_makes_one_table_call(ref_pair, small_corpus,
                                           monkeypatch):
    """`search_batch` builds all the batch's tables in one `adc_tables`
    call and copies them to the host once; `search` makes one call."""
    _, port, _, _ = ref_pair
    calls = []
    real = PQCodec.adc_tables

    def counted(self, qs):
        calls.append(tuple(qs.shape))
        return real(self, qs)

    monkeypatch.setattr(PQCodec, "adc_tables", counted)
    ds = small_corpus
    port.search_batch(ds.queries, K, L)
    assert calls == [ds.queries.shape]
    port.search(ds.queries[0], K, L)
    assert calls[1:] == [(1, ds.queries.shape[1])]


def test_reference_npz_roundtrips_through_the_port(ref_pair, tmp_path):
    """The port's `save` of a loaded reference npz has the same keys,
    dtypes and values; the reference's `load` reads it back to the same
    arrays, and the port's own builds cross the other way too."""
    ref, port, path, _ = ref_pair
    out = str(tmp_path / "port.npz")
    port.save(out)
    with np.load(path) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    back = ref_engine.BAMGIndex.load(out)
    for f in ("adj", "blocks", "members", "entry", "capacity", "alpha",
              "beta"):
        np.testing.assert_array_equal(getattr(back.graph, f),
                                      getattr(ref.graph, f), err_msg=f)
    np.testing.assert_array_equal(back.x, ref.x)
    np.testing.assert_array_equal(back.codes, ref.codes)
    np.testing.assert_array_equal(back.codec.codebooks, ref.codec.codebooks)
    assert len(back.nav.layers) == len(ref.nav.layers)
    for u, v in zip(back.nav.layers, ref.nav.layers):
        np.testing.assert_array_equal(u.vids, v.vids)
        np.testing.assert_array_equal(u.adj, v.adj)
        assert u.entry == v.entry
    # PQCodec.save / load cross too (the same `codebooks` key)
    cpath = str(tmp_path / "codec.npz")
    port.codec.save(cpath)
    np.testing.assert_array_equal(
        ref_engine.PQCodec.load(cpath).codebooks, ref.codec.codebooks)
    ref.codec.save(cpath)
    np.testing.assert_array_equal(PQCodec.load(cpath, device=CPU)
                                  .codebooks.numpy(), ref.codec.codebooks)


def test_port_built_index_read_by_reference(indexes, tmp_path):
    """An index the port built (codebooks on its device) saves an npz the
    reference loads to the same arrays, and both then search alike."""
    ds, idx = indexes
    out = str(tmp_path / "built.npz")
    idx.save(out)
    back = ref_engine.BAMGIndex.load(out)
    np.testing.assert_array_equal(back.graph.adj, idx.graph.adj)
    np.testing.assert_array_equal(back.codes, idx.codes)
    np.testing.assert_array_equal(back.codec.codebooks,
                                  idx.codec.codebooks.numpy())
    tables = back.codec.adc_tables(ds.queries)
    for q, t in zip(ds.queries, tables):
        _same_result(idx.search(q, K, L, table=t), back.search(q, K, L))


def test_pq_decode_equals_reference(ref_pair):
    ref, port, _, _ = ref_pair
    np.testing.assert_array_equal(port.codec.decode(ref.codes).numpy(),
                                  ref.codec.decode(ref.codes))
    np.testing.assert_array_equal(
        port.codec.decode(torch.from_numpy(ref.codes[:5])).numpy(),
        ref.codec.decode(ref.codes[:5]))


@pytest.mark.parametrize("which", ["diskann", "starling"])
@pytest.mark.parametrize("mode", ["plain", "batch_io", "warm_cache",
                                  "exclude"])
@pytest.mark.parametrize("l", (16, 64))
def test_coupled_search_identical_to_reference(ref_coupled, small_corpus,
                                               which, mode, l):
    ref, port = ref_coupled[which]
    ds = small_corpus
    tables = ref.codec.adc_tables(ds.queries)
    kw, warm = _mode_kwargs(mode, ds)
    if kw.pop("batch_io", False):
        ref.configure_io(batch_io=True, qd=4)
        port.configure_io(batch_io=True, qd=4)
    try:
        for i, (q, t) in enumerate(zip(ds.queries, tables)):
            dc = (not warm) or i == 0
            _same_result(port.search(q, K, l, drop_cache=dc, table=t, **kw),
                         ref.search(q, K, l, drop_cache=dc, **kw),
                         f"{which} {mode} query {i}")
        _same_stats(port.search_batch(ds.queries, K, l, gt=ds.gt,
                                      warm_cache=warm, tables=tables, **kw),
                    ref.search_batch(ds.queries, K, l, gt=ds.gt,
                                     warm_cache=warm, **kw))
    finally:
        _restore_io(ref, coupled=True)
        _restore_io(port, coupled=True)
    assert port.memory_bytes() == ref.memory_bytes()
    assert port.index_bytes() == ref.index_bytes()
    assert port.degree_stats() == ref.degree_stats()


@pytest.mark.parametrize("which", ["diskann", "starling"])
@pytest.mark.parametrize("cfg", ["fifo_qd4_batched", "clock_pins_small",
                                 "2q_vec_lru", "lru_faults"])
def test_coupled_configure_io_identical_to_reference(ref_coupled,
                                                     small_corpus, which,
                                                     cfg):
    ref, port = ref_coupled[which]
    ds = small_corpus
    io = {k: v for k, v in _IO[cfg].items()
          if k not in ("vec_cache_policy", "vec_cache_blocks",
                       "pin_nav_blocks")}
    ref.configure_io(**_io_kwargs(io, ref=True))
    port.configure_io(**_io_kwargs(io, ref=False))
    try:
        tables = ref.codec.adc_tables(ds.queries)
        for i, (q, t) in enumerate(zip(ds.queries, tables)):
            _same_result(port.search(q, K, L, table=t), ref.search(q, K, L),
                         f"{which} {cfg} query {i}")
        _same_stats(port.search_batch(ds.queries, K, L, gt=ds.gt,
                                      tables=tables),
                    ref.search_batch(ds.queries, K, L, gt=ds.gt))
    finally:
        _restore_io(ref, coupled=True)
        _restore_io(port, coupled=True)


def test_bamg_index_metrics_equal_reference(ref_pair):
    ref, port, _, _ = ref_pair
    assert port.memory_bytes() == ref.memory_bytes()
    assert port.index_bytes() == ref.index_bytes()
    assert port.degree_stats() == ref.degree_stats()
    for n in (16, 10_000):
        got, want = port.batch_arrays(n), ref.batch_arrays(n)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------
def _pair_frontier(monkeypatch, frontier):
    """Run both packages' index builds on the same construction frontier:
    "fused_ref" leaves the port at its default ("fused", whose plain
    version runs on the CPU) and moves the reference to "fused_ref";
    "batched" leaves the reference at its default and moves the port."""
    if frontier == "batched":
        def port_builder(p, device):
            return GraphBuilder(BuildConfig(
                backend=p.build_backend, batch_size=p.build_batch,
                knn_mode=getattr(p, "build_knn", "clustered"),
                frontier_backend="batched"), device=device)
        monkeypatch.setattr(engine, "_builder_for", port_builder)
    else:
        def ref_builder(p):
            return JaxGraphBuilder(JaxBuildConfig(
                backend=p.build_backend, batch_size=p.build_batch,
                knn_mode=getattr(p, "build_knn", "clustered"),
                frontier_backend="fused_ref"))
        monkeypatch.setattr(ref_engine, "_builder_for", ref_builder)


def _quant_err(x, codec_decode, codes):
    return float(np.mean(np.sum((x - codec_decode(codes)) ** 2, 1)))


@pytest.mark.parametrize("frontier", ("fused_ref", "batched"))
def test_bamg_build_matches_reference(int_corpus, monkeypatch, frontier):
    """`BAMGIndex.build` on the integer corpus: the graph, blocks, members,
    entry and every nav layer bit for bit; the codebooks to quantization
    error within 1.02x the reference's."""
    _pair_frontier(monkeypatch, frontier)
    kw = dict(alpha=3, beta=1.05, r=12, l_build=24, knn_k=12, capacity=16,
              gamma=32, pq_m=8)
    got = BAMGIndex.build(int_corpus, BAMGParams(**kw), device=CPU)
    want = ref_engine.BAMGIndex.build(int_corpus, ref_engine.BAMGParams(
        build_backend="batched", **kw))
    for f in ("adj", "blocks", "members", "entry", "capacity"):
        u, v = getattr(got.graph, f), getattr(want.graph, f)
        assert np.asarray(u).dtype == np.asarray(v).dtype, f
        np.testing.assert_array_equal(u, v, err_msg=f)
    assert len(got.nav.layers) == len(want.nav.layers) > 0
    for u, v in zip(got.nav.layers, want.nav.layers):
        np.testing.assert_array_equal(u.vids, v.vids)
        np.testing.assert_array_equal(u.adj, v.adj)
        assert u.entry == v.entry
    assert got.codes.dtype == want.codes.dtype == np.uint8
    assert isinstance(got.x, np.ndarray) and isinstance(got.codes, np.ndarray)
    assert got.codec.codebooks.device.type == "cpu"
    e_got = _quant_err(int_corpus, lambda c: got.codec.decode(c).numpy(),
                       got.codes)
    e_want = _quant_err(int_corpus, want.codec.decode, want.codes)
    assert e_got <= 1.02 * e_want, (e_got, e_want)


@pytest.mark.parametrize("frontier", ("fused_ref", "batched"))
def test_vamana_builds_match_reference(int_corpus, monkeypatch, frontier):
    """DiskANN's and Starling's Vamana graphs, entry, block order and
    Starling's sampled nav graph, bit for bit, on the integer corpus."""
    _pair_frontier(monkeypatch, frontier)
    kw = dict(r=12, l_build=24, pq_m=8)
    pd = DiskANNIndex.build(int_corpus, DiskANNParams(**kw), device=CPU)
    rd = ref_engine.DiskANNIndex.build(int_corpus, ref_engine.DiskANNParams(
        build_backend="batched", **kw))
    np.testing.assert_array_equal(pd.adj, rd.adj)
    assert pd.entry == rd.entry
    ps = StarlingIndex.build(int_corpus, StarlingParams(**kw), device=CPU)
    rs = ref_engine.StarlingIndex.build(int_corpus, ref_engine.StarlingParams(
        build_backend="batched", **kw))
    np.testing.assert_array_equal(ps.adj, rs.adj)
    np.testing.assert_array_equal(ps.adj, pd.adj)
    np.testing.assert_array_equal(ps.store.layout, rs.store.layout)
    np.testing.assert_array_equal(ps.nav_vids, rs.nav_vids)
    np.testing.assert_array_equal(ps.nav_adj, rs.nav_adj)
    for p, r in ((pd, rd), (ps, rs)):
        e_got = _quant_err(int_corpus, lambda c: p.codec.decode(c).numpy(),
                           p.codes)
        assert e_got <= 1.02 * _quant_err(int_corpus, r.codec.decode,
                                          r.codes)


def test_build_recall_within_reference_budget(indexes, ref_pair):
    """On the float corpus the port's default build (batched, fused
    frontier) recalls within 0.01 of the reference's host build, the
    budget of test_torch_build.py::test_backend_recall_within_budget."""
    ds, port = indexes
    ref = ref_pair[0]   # the reference's host build at the same params
    want = ref.search_batch(ds.queries, 10, 64, gt=ds.gt)
    got = port.search_batch(ds.queries, 10, 64, gt=ds.gt)
    assert want.recall >= 0.6
    assert abs(got.recall - want.recall) <= 0.01, (got, want)


def test_from_graph_lays_out_as_build(small_corpus, indexes):
    ds, idx = indexes
    again = BAMGIndex.from_graph(ds.base, idx.graph, idx.params, device=CPU)
    np.testing.assert_array_equal(again.codes, idx.codes)
    for q in ds.queries[:4]:
        _same_result(again.search(q, K, L), idx.search(q, K, L))


# ---------------------------------------------------------------------------
# Serving the index; device defaults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ("ref", "fused_ref"))
def test_from_index_serves_the_reference_ids(ref_pair, small_corpus,
                                             backend):
    """`BatchedANNEngine.from_index` on the port's loaded index gives the
    JAX engine's ids on the reference's index (dists within 1e-5)."""
    ref, port, _, _ = ref_pair
    ds = small_corpus
    cfg = dict(l=32, max_hops=16, n_entry_cands=64, backend=backend)
    eng = BatchedANNEngine.from_index(port, EngineConfig(**cfg))
    assert eng.device == port.device == torch.device("cpu")
    ids, d = eng.search_batch(ds.queries, K)
    want_ids, want_d = JaxEngine.from_index(
        ref, JaxEngineConfig(**cfg)).search_batch(ds.queries, K)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)


def test_entry_points_default_to_the_card(ref_pair, small_corpus):
    """With no device argument every build and load means the CUDA device,
    and raises without one: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, path, _ = ref_pair
    x = small_corpus.base[:64]
    for call in (lambda: BAMGIndex.build(x, BAMGParams(r=8)),
                 lambda: BAMGIndex.load(path),
                 lambda: DiskANNIndex.build(x, DiskANNParams(r=8)),
                 lambda: StarlingIndex.build(x, StarlingParams(r=8)),
                 lambda: PQCodec.load(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    port = BAMGIndex.load(path, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BAMGIndex.from_graph(port.x, port.graph, port.params)
