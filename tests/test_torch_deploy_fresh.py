"""The port's blue/green deployment (`repro_torch.serve.deploy`) and
streaming freshness (`repro_torch.index.delta`) against the JAX package's.

- **Interchange**: either package's `DeploymentManager` verifies, loads,
  promotes and serves a build that the other published (the same
  layout, npz and manifest JSON); the two engines over it answer with
  equal ids and dists within rtol = atol = 1e-5 (ADC and re-rank sums
  run in another order in XLA).
- **The overlay bit for bit**: the same insert/delete sequence over the
  same frozen index gives the same copy-on-write adjacency rows,
  tombstones and overlay search results in both packages (host numpy,
  the same code).
- **Fresh search**: on integer vectors and integer codebooks every ADC
  table entry and every distance is exact, so the host path
  (`FreshBAMGEngine.search`) equals the reference's bit for bit; the
  batched path is held to ids equal, dists within 1e-5.
- **Consolidation**: on integer vectors both packages fold the same
  overlay into the same graph: adjacency, blocks, members and `old2new`
  bit for bit, once the test has asserted that the two medoids (the new
  entry) agree.  The reference's `build_backend` default ("host") is
  paired with the port's ("batched"), whose refine follows the host's
  scan given the same inputs.
- **Mirrors**: the deployment tests of tests/test_faults.py and every
  test of tests/test_fresh.py, on the port alone with ``device="cpu"``,
  each with the reference's tolerance.
"""
import logging
import os

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.index import delta as ref_delta
from repro.serve import BlueGreenEngine as JaxBlueGreen
from repro.serve import DeploymentManager as JaxManager
from repro.serve import EngineConfig as JaxConfig
from repro.serve.ann_engine import BatchedANNEngine as JaxEngine
from repro_torch.core.distances import exact_knn, medoid, recall_at_k
from repro_torch.core.engine import BAMGIndex, BAMGParams
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.index.delta import (DeltaLayer, DeltaParams,
                                     FreshBAMGEngine, FreshService,
                                     consolidate)
from repro_torch.serve import (BatchedANNEngine, BlueGreenEngine,
                               DeploymentManager, EngineConfig)
from repro_torch.utils.faults import IntegrityError

CPU = "cpu"
K, L = 10, 48
_CFG = EngineConfig(l=48, max_hops=24, backend="ref")
_JCFG = JaxConfig(l=48, max_hops=24, backend="ref")
_FCFG = EngineConfig(l=32, max_hops=16, backend="ref")   # test_faults.py's
_PARAMS = BAMGParams(r=16, l_build=32, seed=0)
_R16 = dict(r=16, l_build=32, seed=0)


def _knn(x, q, k):
    """Exact top-k ids of the port (numpy in, numpy out)."""
    return exact_knn(torch.from_numpy(np.ascontiguousarray(x)),
                     torch.from_numpy(np.ascontiguousarray(q)), k)[1].numpy()


def _ext_recall(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    hits = sum(len(set(r[:k].tolist()) & set(g[:k].tolist()))
               for r, g in zip(ids, gt))
    return hits / (len(gt) * k)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def int_corpus(small_corpus):
    """The shared clustered corpus rounded to integers: every squared
    distance is exact in f32."""
    return np.round(small_corpus.base).astype(np.float32)


@pytest.fixture(scope="module")
def ref_index(small_corpus):
    return ref_engine.BAMGIndex.build(small_corpus.base,
                                      ref_engine.BAMGParams(**_R16))


@pytest.fixture(scope="module")
def base_index(small_corpus):
    return BAMGIndex.build(small_corpus.base, _PARAMS, device=CPU)


@pytest.fixture(scope="module")
def int_pair(int_corpus, tmp_path_factory):
    """A reference BAMG on the integer corpus with integer codebooks, and
    the port's index loaded from its npz: ADC tables exact in both."""
    ref = ref_engine.BAMGIndex.build(int_corpus,
                                     ref_engine.BAMGParams(**_R16))
    ref.codec.codebooks = np.round(ref.codec.codebooks).astype(np.float32)
    path = str(tmp_path_factory.mktemp("int") / "int.npz")
    ref.save(path)
    return ref, BAMGIndex.load(path, device=CPU)


def _writes(x, n_ins, seed):
    """A seeded insert batch near the corpus, integer-valued, and the
    base ids to delete (the first n_ins // 3 of a permutation)."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(x), n_ins)
    vecs = np.round(x[picks] + rng.normal(size=(n_ins, x.shape[1])))
    return vecs.astype(np.float32), rng.permutation(len(x))[:n_ins // 3]


# ---------------------------------------------------------------------------
# interchange with the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("publisher", ["jax", "torch"])
def test_manager_serves_the_other_packages_build(small_corpus, ref_index,
                                                 tmp_path, publisher):
    ds = small_corpus
    root = str(tmp_path / "depot")
    pm, jm = DeploymentManager(root, device=CPU), JaxManager(root)
    if publisher == "jax":
        jm.publish(ref_index, "b1", meta={"by": "jax"})
        reader = pm
    else:
        pm.publish(BAMGIndex.load(_saved(ref_index, tmp_path), device=CPU),
                   "b1", meta={"by": "torch"})
        reader = jm
    man = reader.verify("b1")
    assert man.meta == {"by": publisher}
    assert (man.n, man.d) == ds.base.shape
    assert pm.manifest("b1").to_json() == jm.manifest("b1").to_json()
    reader.promote("b1")
    assert pm.active() == jm.active() == "b1"
    assert pm.history() == jm.history() == ["b1"]
    loaded = reader.load("b1")
    np.testing.assert_array_equal(loaded.graph.adj, ref_index.graph.adj)
    got = BlueGreenEngine(pm, _CFG).search_batch(ds.queries, K)
    want = JaxBlueGreen(jm, _JCFG).search_batch(ds.queries, K)
    _assert_same(got, want)
    assert pm.validate("b1", ds.queries, ds.gt, k=K, min_recall=0.5,
                       config=_CFG) == jm.validate(
        "b1", ds.queries, ds.gt, k=K, min_recall=0.5, config=_JCFG)


def _saved(index, tmp_path) -> str:
    path = str(tmp_path / "src.npz")
    index.save(path)
    return path


# ---------------------------------------------------------------------------
# the overlay, the fresh search and consolidation against the reference
# ---------------------------------------------------------------------------
def test_overlay_matches_reference(int_corpus, int_pair):
    ref, _ = int_pair
    vecs, dead = _writes(int_corpus, 30, seed=4)
    dp = dict(r=16, ef=48)
    got = DeltaLayer(ref, DeltaParams(**dp))
    want = ref_delta.DeltaLayer(ref, ref_delta.DeltaParams(**dp))
    for layer in (got, want):
        layer.insert_batch(vecs[:20])
        layer.delete_batch(dead)
        layer.insert_batch(vecs[20:])
        layer.delete(layer.n_base + 3)
    assert got.n_total == want.n_total and got.tombstones == want.tombstones
    assert got.overrides.keys() == want.overrides.keys()
    for u in want.overrides:
        np.testing.assert_array_equal(got.overrides[u], want.overrides[u])
    for q in int_corpus[:6] + 0.5:
        for a, b in zip(got.search(q, K), want.search(q, K)):
            np.testing.assert_array_equal(a, b)
    assert got.overlay_fraction == want.overlay_fraction


def test_fresh_paths_match_reference(int_corpus, int_pair):
    """Host path bit for bit (exact tables on integers), batched path ids
    equal and dists within 1e-5."""
    ref, port = int_pair
    vecs, dead = _writes(int_corpus, 30, seed=5)
    rng = np.random.default_rng(6)
    queries = np.round(int_corpus[rng.integers(0, len(int_corpus), 12)]
                       + rng.normal(size=(12, int_corpus.shape[1])))
    queries = queries.astype(np.float32)
    pd, jd = DeltaLayer(ref, DeltaParams(r=16)), \
        ref_delta.DeltaLayer(ref, ref_delta.DeltaParams(r=16))
    for layer in (pd, jd):
        layer.insert_batch(vecs)
        layer.delete_batch(dead)
    got = FreshBAMGEngine(port, pd, engine=BatchedANNEngine(
        ref.batch_arrays(), _CFG, device=CPU))
    want = ref_delta.FreshBAMGEngine(ref, jd, engine=JaxEngine.from_index(
        ref, _JCFG))
    for q in queries:
        for a, b in zip(got.search(q, K, l=L), want.search(q, K, l=L)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    _assert_same(got.search_batch(queries, K), want.search_batch(queries, K))
    _assert_same(got.search_batch(queries, K, l=24, max_hops=6),
                 want.search_batch(queries, K, l=24, max_hops=6))


def test_consolidate_matches_reference(int_corpus, int_pair):
    ref, _ = int_pair
    vecs, dead = _writes(int_corpus, 45, seed=8)
    dp = dict(r=16, ef=48)
    pd = DeltaLayer(ref, DeltaParams(**dp))
    jd = ref_delta.DeltaLayer(ref, ref_delta.DeltaParams(**dp))
    for layer in (pd, jd):
        layer.insert_batch(vecs)
        layer.delete_batch(dead)
    # the new entry: both medoids of the live corpus agree on this corpus
    live = np.asarray([v for v in range(pd.n_total)
                       if v not in pd.tombstones])
    from repro.core.distances import medoid as jax_medoid
    x_live = pd.vectors(live)
    assert medoid(torch.from_numpy(x_live)) == jax_medoid(x_live)
    p = BAMGParams(gamma=32, **_R16)
    assert p.build_backend == "batched"
    rp = ref_engine.BAMGParams(gamma=32, **_R16)
    assert rp.build_backend == "host"
    got, g2n = consolidate(ref, pd, p, device=CPU)
    want, w2n = ref_delta.consolidate(ref, jd, rp)
    np.testing.assert_array_equal(g2n, w2n)
    np.testing.assert_array_equal(got.x, want.x)
    for f in ("adj", "blocks", "members", "entry", "capacity"):
        np.testing.assert_array_equal(getattr(got.graph, f),
                                      getattr(want.graph, f), err_msg=f)
    assert got.codec.codebooks.device.type == "cpu"


@pytest.fixture(scope="module")
def far_inserts_consolidated(int_corpus, int_pair):
    """60 inserts from another seed's cluster centres (clusters the base
    does not hold) and 20 deletes folded by both packages' `consolidate`;
    the reference's build gets integer codebooks, so every ADC table is
    exact in both engines.  Returns (inserts, their new rows, the
    reference's consolidated index)."""
    ref, _ = int_pair
    ins = np.round(clustered_vectors(60, int_corpus.shape[1], 12,
                                     seed=1)).astype(np.float32)
    dead = np.random.default_rng(3).permutation(len(int_corpus))[:20]
    dp = dict(r=16, ef=48)
    pd = DeltaLayer(ref, DeltaParams(**dp))
    jd = ref_delta.DeltaLayer(ref, ref_delta.DeltaParams(**dp))
    rows = [layer.insert_batch(ins) for layer in (pd, jd)]
    np.testing.assert_array_equal(rows[0], rows[1])
    for layer in (pd, jd):
        layer.delete_batch(dead)
    got, g2n = consolidate(ref, pd, BAMGParams(gamma=32, **_R16), device=CPU)
    want, w2n = ref_delta.consolidate(ref, jd,
                                      ref_engine.BAMGParams(gamma=32, **_R16))
    np.testing.assert_array_equal(g2n, w2n)
    np.testing.assert_array_equal(got.graph.adj, want.graph.adj)
    want.codec.codebooks = np.round(want.codec.codebooks).astype(np.float32)
    return ins, w2n[rows[1]], want


# the served budgets (the tests' and the card smoke's) miss some inserts in
# both packages; the last budget lets the search converge and misses none
@pytest.mark.parametrize("l,max_hops,misses", [(48, 24, True),
                                               (64, 32, True),
                                               (256, 512, False)])
def test_consolidated_inserts_missed_only_where_reference_misses(
        far_inserts_consolidated, l, max_hops, misses):
    """After consolidation an insert is served by the approximate search,
    not the overlay's exact scan.  Inserts far from the old corpus can lie
    beyond the hop budget: the port's engine, on the reference's arrays,
    misses exactly the inserts the reference's engine misses (first hit
    and its distance bit for bit), and a converging budget, its pool
    re-ranked in full, finds all."""
    ins, rows, want = far_inserts_consolidated
    kw = dict(l=l, max_hops=max_hops, n_entry=4, backend="ref")
    j_ids, j_d = JaxEngine.from_index(want, JaxConfig(**kw)).search_batch(
        ins, K)
    p_ids, p_d = BatchedANNEngine(want.batch_arrays(), EngineConfig(**kw),
                                  device=CPU).search_batch(ins, K)
    found = [(np.asarray(i)[:, 0] == rows) & (np.asarray(d)[:, 0] == 0)
             for i, d in ((j_ids, j_d), (p_ids, p_d))]
    np.testing.assert_array_equal(found[1], found[0])
    np.testing.assert_array_equal(p_ids[:, 0], np.asarray(j_ids)[:, 0])
    np.testing.assert_array_equal(p_d[:, 0], np.asarray(j_d)[:, 0])
    assert (not found[0].all()) == misses


def test_fresh_service_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    svc = FreshService(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="CUDA"):
        svc.bootstrap(np.zeros((8, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        DeploymentManager(str(tmp_path / "e")).deploy(
            np.zeros((8, 4), np.float32), "v1", np.zeros((1, 4), np.float32),
            np.zeros((1, 1), np.int64))


# ---------------------------------------------------------------------------
# mirrors of tests/test_faults.py: blue/green deployment
# ---------------------------------------------------------------------------
def test_blue_green_lifecycle(small_corpus, tmp_path):
    ds = small_corpus
    dm = DeploymentManager(str(tmp_path), device=CPU)
    assert dm.active() is None and dm.builds() == []
    man = dm.deploy(ds.base, "v1", ds.queries, ds.gt, params=_PARAMS, k=K,
                    min_recall=0.5, config=_FCFG)
    assert dm.active() == "v1" and man.meta["validated_recall"] >= 0.5
    assert man.n == len(ds.base) and man.d == ds.base.shape[1]
    bg = BlueGreenEngine(dm, _FCFG)
    ids1, d1 = bg.search_batch(ds.queries, K)
    assert recall_at_k(ids1, ds.gt, K) >= 0.5
    dm.deploy(ds.base, "v2", ds.queries, ds.gt,
              params=BAMGParams(r=16, l_build=32, seed=1), k=K,
              min_recall=0.5, config=_FCFG)
    pre, _ = bg.search_batch(ds.queries, K)
    np.testing.assert_array_equal(pre, ids1)
    assert bg.refresh() and bg.build_id == "v2"
    assert not bg.refresh()
    ids2, _ = bg.search_batch(ds.queries, K)
    assert recall_at_k(ids2, ds.gt, K) >= 0.5
    assert dm.rollback() == "v1"
    assert bg.refresh() and bg.build_id == "v1"
    back, _ = bg.search_batch(ds.queries, K)
    np.testing.assert_array_equal(back, ids1)
    assert dm.history()[-1] == "v1"


def test_deploy_tamper_detected(base_index, tmp_path):
    dm = DeploymentManager(str(tmp_path), device=CPU)
    dm.publish(base_index, "b1")
    dm.verify("b1")
    art = os.path.join(str(tmp_path), "builds", "b1", "index.npz")
    with open(art, "r+b") as f:
        f.seek(64)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(IntegrityError):
        dm.verify("b1")
    with pytest.raises(IntegrityError):
        dm.load("b1")


def test_deploy_failed_validation_keeps_active(small_corpus, tmp_path):
    ds = small_corpus
    dm = DeploymentManager(str(tmp_path), device=CPU)
    dm.deploy(ds.base, "good", ds.queries, ds.gt, params=_PARAMS, k=K,
              min_recall=0.5, config=_FCFG)
    with pytest.raises(ValueError, match="failed validation"):
        dm.deploy(ds.base, "bad", ds.queries, ds.gt,
                  params=BAMGParams(r=16, l_build=32, seed=1), k=K,
                  min_recall=1.01, config=_FCFG)
    assert dm.active() == "good"
    assert "bad" in dm.builds()
    dm.prune(keep=1)
    assert dm.builds() == ["good"]


def test_prune_protects_active_and_rollback_target(base_index, tmp_path):
    dm = DeploymentManager(str(tmp_path), device=CPU)
    for b in ("b1", "b2", "b3", "b4"):
        dm.publish(base_index, b)
        dm.promote(b)
    dm.promote("b2")
    removed = dm.prune(keep=0)
    assert set(removed) == {"b1", "b3"}
    assert dm.active() == "b2"
    assert set(dm.builds()) == {"b2", "b4"}
    dm.verify("b2")
    assert dm.rollback() == "b4"
    dm.verify("b4")
    assert dm.active() == "b4" and "b2" in dm.builds()


# ---------------------------------------------------------------------------
# mirrors of tests/test_fresh.py: the delta overlay
# ---------------------------------------------------------------------------
def test_delta_insert_wiring_copy_on_write(small_corpus, base_index):
    ds = small_corpus
    delta = DeltaLayer(base_index, DeltaParams(r=16, ef=48))
    frozen = np.asarray(base_index.graph.adj).copy()
    rng = np.random.default_rng(11)
    picks = rng.integers(0, len(ds.base), 20)
    vecs = ds.base[picks] + 0.02 * rng.standard_normal(
        (20, ds.base.shape[1])).astype(np.float32)
    ids = delta.insert_batch(vecs)
    np.testing.assert_array_equal(
        ids, np.arange(delta.n_base, delta.n_base + 20))
    assert delta.n_delta == 20 and delta.n_total == delta.n_base + 20
    np.testing.assert_array_equal(np.asarray(base_index.graph.adj), frozen)
    assert any(u < delta.n_base for u in delta.overrides)
    assert all(len(row) <= 16 for row in delta.overrides.values())
    for vid, v in zip(ids.tolist(), vecs):
        rids, rd = delta.search(v, k=3)
        assert rids[0] == vid and rd[0] == pytest.approx(0.0, abs=1e-3)
    assert delta.memory_bytes() > 0


def test_delta_tombstone_masked_but_navigable(small_corpus, base_index):
    ds = small_corpus
    delta = DeltaLayer(base_index, DeltaParams(r=16, ef=48))
    dead = sorted(set(ds.gt[:, 0].astype(int).tolist()))
    delta.delete_batch(dead)
    assert set(dead) <= delta.tombstones
    for v in dead:
        assert len(delta.neighbors(v)) > 0
    for q, g in zip(ds.queries, ds.gt):
        rids, rd = delta.search(q, k=K)
        assert not (set(rids.tolist()) & set(dead))
        live_gt = [v for v in g.tolist() if v not in delta.tombstones]
        assert set(rids.tolist()) & set(live_gt)
        assert (np.diff(rd) >= 0).all()


def test_delta_delete_validates_and_insert_checks_dim(base_index):
    delta = DeltaLayer(base_index)
    with pytest.raises(KeyError):
        delta.delete(delta.n_total)
    with pytest.raises(KeyError):
        delta.delete(-1)
    with pytest.raises(ValueError, match="dim"):
        delta.insert(np.zeros(delta.d + 1, np.float32))


def test_overlay_pressure_warns_once_and_rearms(small_corpus, base_index,
                                                caplog):
    ds = small_corpus
    n_base = len(ds.base)
    delta = DeltaLayer(base_index,
                       DeltaParams(r=16, ef=48, warn_fraction=4.5 / n_base))
    rng = np.random.default_rng(5)
    vecs = (ds.base[rng.integers(0, n_base, 6)]
            + 0.02 * rng.standard_normal((6, ds.base.shape[1]))
            .astype(np.float32))
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.index.delta.layer"):
        delta.insert_batch(vecs[:3])
        assert not delta.overlay_pressure
        assert caplog.records == []
        delta.delete(0)
        delta.delete(1)
        assert delta.overlay_pressure
        assert delta.overlay_fraction == pytest.approx(5 / n_base)
        warns = [r for r in caplog.records if "overlay" in r.message]
        assert len(warns) == 1
        assert f"{n_base}-point base" in warns[0].message
        delta.insert_batch(vecs[3:])
        assert len([r for r in caplog.records
                    if "overlay" in r.message]) == 1
    fresh = DeltaLayer(base_index, DeltaParams(r=16, warn_fraction=0.25))
    assert fresh.overlay_fraction == 0.0 and not fresh.overlay_pressure


def test_fresh_service_stats(small_corpus, base_index, tmp_path):
    svc = FreshService(str(tmp_path / "depot"), params=_PARAMS,
                       delta_params=DeltaParams(r=16, ef=48,
                                                warn_fraction=0.02),
                       device=CPU)
    svc.bootstrap(index=base_index)
    n0 = len(small_corpus.base)
    s = svc.stats()
    assert s["n_base"] == n0 and s["n_delta"] == 0
    assert s["n_tombstones"] == 0 and s["n_live"] == n0
    assert s["overlay_fraction"] == 0.0 and not s["overlay_pressure"]
    assert s["warn_fraction"] == pytest.approx(0.02)
    assert s["generation"] == 0
    rng = np.random.default_rng(9)
    m = int(np.ceil(0.02 * n0)) + 2
    svc.insert_batch(small_corpus.base[:m]
                     + 0.01 * rng.standard_normal(
                         (m, small_corpus.base.shape[1])).astype(np.float32))
    svc.delete(0)
    s = svc.stats()
    assert s["n_delta"] == m and s["n_tombstones"] == 1
    assert s["n_live"] == n0 + m - 1
    assert s["overlay_fraction"] == pytest.approx((m + 1) / n0)
    assert s["overlay_pressure"]
    assert s["overlay_memory_bytes"] >= svc.delta.memory_bytes()


# ---------------------------------------------------------------------------
# mirrors of tests/test_fresh.py: the unified base+delta engine
# ---------------------------------------------------------------------------
def test_fresh_engine_paths_agree_and_mask_tombstones(small_corpus,
                                                      base_index):
    ds = small_corpus
    delta = DeltaLayer(base_index, DeltaParams(r=16, ef=48))
    eng = BatchedANNEngine.from_index(base_index, _CFG)
    fresh = FreshBAMGEngine(base_index, delta, engine=eng)
    rng = np.random.default_rng(5)
    picks = rng.integers(0, len(ds.base), 30)
    vecs = ds.base[picks] + 0.02 * rng.standard_normal(
        (30, ds.base.shape[1])).astype(np.float32)
    new_ids = delta.insert_batch(vecs)
    dead = set(ds.gt[:, 0].astype(int).tolist()) | set(new_ids[:5].tolist())
    delta.delete_batch(sorted(dead))

    live_x = np.concatenate([ds.base, vecs])
    live_ids = np.asarray([v for v in range(delta.n_total)
                           if v not in dead], np.int64)
    gt = live_ids[_knn(live_x[live_ids], ds.queries, K)]

    h_ids = np.stack([fresh.search(q, K, l=L)[0] for q in ds.queries])
    b_ids, b_d = fresh.search_batch(ds.queries, K, l=L)
    for ids in (h_ids, b_ids):
        assert ids.shape == (len(ds.queries), K)
        assert not (set(ids.ravel().tolist()) & dead)
        assert _ext_recall(ids, gt, K) >= 0.9
    assert (np.diff(np.where(np.isfinite(b_d), b_d, np.inf),
                    axis=1) >= 0).all()
    probe = vecs[10]
    assert fresh.search(probe, K, l=L)[0][0] == new_ids[10]
    assert fresh.search_batch(probe[None, :], K)[0][0, 0] == new_ids[10]
    with pytest.raises(RuntimeError, match="engine"):
        FreshBAMGEngine(base_index, delta).search_batch(ds.queries, K)


def test_batched_tombstone_mask_matches_exclude_arg(small_corpus, base_index):
    ds = small_corpus
    eng = BatchedANNEngine.from_index(base_index, _CFG)
    dead = ds.gt[:, 0].astype(np.int64)
    a_ids, a_d = eng.search_batch(ds.queries, K, exclude=set(dead.tolist()))
    eng.set_tombstones(dead)
    b_ids, b_d = eng.search_batch(ds.queries, K)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_d, b_d)
    assert not (set(b_ids.ravel().tolist()) & set(dead.tolist()))
    eng.set_tombstones([])
    c_ids, _ = eng.search_batch(ds.queries, K)
    assert set(c_ids[:, 0].tolist()) & set(dead.tolist())


def test_consolidate_requires_live_points(base_index):
    delta = DeltaLayer(base_index)
    delta.delete_batch(np.arange(delta.n_total))
    with pytest.raises(ValueError, match="live"):
        consolidate(base_index, delta, device=CPU)


# ---------------------------------------------------------------------------
# mirrors of tests/test_fresh.py: the full service lifecycle
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lifecycle(small_corpus, tmp_path_factory):
    """tests/test_fresh.py's seeded insert+delete workload driven through
    bootstrap -> serve -> consolidate -> hot swap, on the port."""
    ds = small_corpus
    rng = np.random.default_rng(7)
    d = ds.base.shape[1]
    queries = np.concatenate([
        ds.queries,
        ds.base[rng.integers(0, len(ds.base), 20)]
        + 0.05 * rng.standard_normal((20, d)).astype(np.float32)])

    svc = FreshService(str(tmp_path_factory.mktemp("fresh")),
                       params=_PARAMS, config=_CFG,
                       delta_params=DeltaParams(r=16, ef=48), device=CPU)
    svc.bootstrap(ds.base, "gen-0")

    picks = rng.integers(0, len(ds.base), 60)
    ins_vecs = ds.base[picks] + 0.02 * rng.standard_normal(
        (60, d)).astype(np.float32)
    ins_ext = svc.insert_batch(ins_vecs)
    del_ext = sorted(set(ds.gt[:, 0].astype(int).tolist())
                     | set(ins_ext[:10].tolist()))
    for e in del_ext:
        svc.delete(e)

    pre_ids, _ = svc.search_batch(queries, K, l=L)
    pre_host = np.stack([svc.search(q, K, l=L)[0] for q in queries])

    live_x, live_ext = svc.live_corpus()
    gt_ext = live_ext[_knn(live_x, queries, K)]

    probes = {}
    orig_promote = svc.manager.promote

    def probing_promote(build_id):
        probes["during"], _ = svc.search_batch(queries, K, l=L)
        return orig_promote(build_id)

    svc.manager.promote = probing_promote
    try:
        svc.consolidate("gen-1", queries=queries, k=K, min_recall=0.5)
    finally:
        del svc.manager.promote

    post_ids, _ = svc.search_batch(queries, K, l=L)
    post_host = np.stack([svc.search(q, K, l=L)[0] for q in queries])

    scratch = BAMGIndex.build(live_x, _PARAMS, device=CPU)
    scratch_ids = live_ext[np.stack(
        [np.pad(r.ids[:K], (0, K - min(K, len(r.ids))))
         for r in (scratch.search(q, k=K, l=L) for q in queries)])]

    return dict(svc=svc, queries=queries, gt_ext=gt_ext,
                ins_vecs=ins_vecs, ins_ext=ins_ext, del_ext=set(del_ext),
                pre_ids=pre_ids, pre_host=pre_host, probes=probes,
                post_ids=post_ids, post_host=post_host,
                scratch_ids=scratch_ids, n_live=len(live_ext))


def test_deletes_never_surface_any_stage(lifecycle):
    lc = lifecycle
    for ids in (lc["pre_ids"], lc["pre_host"], lc["probes"]["during"],
                lc["post_ids"], lc["post_host"]):
        assert not (set(ids.ravel().tolist()) & lc["del_ext"])


def test_inserts_visible_before_and_after_consolidation(lifecycle):
    lc, svc = lifecycle, lifecycle["svc"]
    live = [i for i in range(len(lc["ins_ext"]))
            if int(lc["ins_ext"][i]) not in lc["del_ext"]][:5]
    for i in live:
        ids, d = svc.search_batch(lc["ins_vecs"][i][None, :], K)
        assert ids[0, 0] == lc["ins_ext"][i]
        assert d[0, 0] == pytest.approx(0.0, abs=1e-3)
        eid, dh = svc.search(lc["ins_vecs"][i], K, l=L)
        assert eid[0] == lc["ins_ext"][i]


def test_freshness_parity_with_from_scratch_rebuild(lifecycle):
    """The reference's bound: consolidated recall within 0.01 of a
    from-scratch build on the identical live corpus, same l, same k."""
    lc = lifecycle
    r_cons = _ext_recall(lc["post_host"], lc["gt_ext"], K)
    r_scratch = _ext_recall(lc["scratch_ids"], lc["gt_ext"], K)
    assert r_scratch >= 0.9
    assert abs(r_cons - r_scratch) <= 0.01
    assert _ext_recall(lc["post_ids"], lc["gt_ext"], K) >= r_scratch - 0.05


def test_swap_serves_correct_topk_throughout(lifecycle):
    lc = lifecycle
    np.testing.assert_array_equal(lc["probes"]["during"], lc["pre_ids"])
    assert _ext_recall(lc["pre_ids"], lc["gt_ext"], K) >= 0.85
    assert _ext_recall(lc["post_ids"], lc["gt_ext"], K) >= 0.85


def test_consolidated_build_promoted_with_lineage(lifecycle):
    svc = lifecycle["svc"]
    dm = svc.manager
    assert dm.active() == "gen-1"
    assert dm.history() == ["gen-0", "gen-1"]
    assert dm.rollback_target() == "gen-0"
    man = dm.manifest("gen-1")
    assert man.meta["generation"] == 1
    assert man.meta["n_delta"] == 60
    assert svc.last_validation_recall >= 0.5
    assert man.n == lifecycle["n_live"]
    dm.verify("gen-1")
    assert svc.delta.n_delta == 0 and not svc.delta.tombstones
    assert svc.n_live == lifecycle["n_live"]
    assert set(svc.timings) == {"fold", "repair", "compact", "connect", "bnf",
                                "refine", "index", "publish", "verify",
                                "validate", "promote", "swap"}


def test_external_ids_stable_across_compaction(lifecycle):
    lc, svc = lifecycle, lifecycle["svc"]
    live = [i for i in range(len(lc["ins_ext"]))
            if int(lc["ins_ext"][i]) not in lc["del_ext"]]
    for i in live[::7]:
        e = int(lc["ins_ext"][i])
        internal = svc._int_of_ext[e]
        np.testing.assert_allclose(svc.delta.vector(internal),
                                   lc["ins_vecs"][i], atol=1e-5)
    assert not (set(svc._int_of_ext) & lc["del_ext"])
    with pytest.raises(KeyError):
        svc.delete(next(iter(lc["del_ext"])))


def test_second_epoch_continues_after_swap(lifecycle):
    lc, svc = lifecycle, lifecycle["svc"]
    rng = np.random.default_rng(23)
    v = (lc["ins_vecs"][0] + 0.01
         * rng.standard_normal(len(lc["ins_vecs"][0])).astype(np.float32))
    e = svc.insert(v)
    assert e == svc._next_ext - 1
    ids, _ = svc.search_batch(v[None, :], K)
    assert ids[0, 0] == e
    svc.delete(e)
    ids, _ = svc.search_batch(v[None, :], K)
    assert e not in set(ids.ravel().tolist())
