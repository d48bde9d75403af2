"""Port `BatchedANNEngine` vs the JAX engine on a BAMG index that the JAX
package builds (the port's build is not ported yet).

Ids must be equal and dists agree within rtol = atol = 1e-5: the ADC
sums and the re-rank's reduction over D run in another order in XLA
than in PyTorch.  Mirrors tests/test_serve_engine.py for the exhaustive
and practical configurations.
"""
import numpy as np
import pytest
import torch

from repro.core.distances import exact_knn, recall_at_k
from repro.core.engine import BAMGIndex, BAMGParams
from repro.serve import BatchedANNEngine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro_torch.core.engine import load_batch_arrays
from repro_torch.serve import (BatchedANNEngine, EngineConfig,
                               resolve_backend)

K = 10


@pytest.fixture(scope="module")
def built(small_corpus):
    idx = BAMGIndex.build(small_corpus.base,
                          BAMGParams(alpha=3, beta=1.05, r=16, l_build=32,
                                     knn_k=16, seed=0))
    return small_corpus, idx, idx.batch_arrays()


def _engine(arrays, **cfg):
    return BatchedANNEngine(arrays, EngineConfig(**cfg), device="cpu")


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,jax_backend", [
    ("ref", "ref"), ("fused_ref", "fused_interpret"), ("ref", "fused_interpret"),
])
def test_engine_matches_jax_engine(built, backend, jax_backend):
    ds, _, arrays = built
    cfg = dict(l=48, max_hops=32)
    want = JaxEngine(arrays, JaxConfig(backend=jax_backend, **cfg)
                     ).search_batch(ds.queries, K)
    got = _engine(arrays, backend=backend, **cfg).search_batch(ds.queries, K)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32
    _assert_same(got, want)


def test_per_call_overrides_match_jax_engine(built):
    ds, _, arrays = built
    eng = _engine(arrays, l=48, max_hops=32, rerank=20)
    jeng = JaxEngine(arrays, JaxConfig(l=48, max_hops=32, rerank=20,
                                       backend="ref"))
    for kw in (dict(l=16), dict(max_hops=3), dict(l=24, max_hops=8)):
        _assert_same(eng.search_batch(ds.queries, 5, **kw),
                     jeng.search_batch(ds.queries, 5, **kw))


def test_exhaustive_rerank_identical_topk(built):
    """l = n, hops = n, full re-rank: ids == brute force, both backends
    (the fused semantics' (B, L, L) merge on three queries, for time)."""
    ds, _, arrays = built
    n = len(ds.base)
    gd, gi = exact_knn(ds.base, ds.queries, K)
    for backend, nq in (("ref", len(ds.queries)), ("fused_ref", 3)):
        ids, dists = _engine(arrays, l=n, max_hops=n,
                             backend=backend).search_batch(ds.queries[:nq], K)
        np.testing.assert_array_equal(ids, gi[:nq])
        np.testing.assert_allclose(dists, gd[:nq], rtol=1e-4, atol=1e-3)


def test_practical_settings_recall_parity(built):
    ds, idx, arrays = built
    ids, dists = _engine(arrays, l=48, max_hops=32).search_batch(ds.queries, K)
    assert ids.shape == (len(ds.queries), K)
    assert (np.diff(dists, axis=1) >= 0).all()        # ascending
    jids, _ = JaxEngine(arrays, JaxConfig(l=48, max_hops=32)
                        ).search_batch(ds.queries, K)
    assert recall_at_k(ids, ds.gt, K) == recall_at_k(jids, ds.gt, K)
    host = idx.search_batch(ds.queries, k=K, l=48, gt=ds.gt)
    assert recall_at_k(ids, ds.gt, K) >= host.recall - 0.05


def test_exclude_and_tombstones(built):
    ds, _, arrays = built
    eng = _engine(arrays, l=48, max_hops=32)
    jeng = JaxEngine(arrays, JaxConfig(l=48, max_hops=32))
    ids, _ = eng.search_batch(ds.queries, K)
    drop = set(ids[:, 0].tolist())
    for kw in (dict(exclude=drop), dict(exclude=np.isin(np.arange(len(ds.base)),
                                                        list(drop)))):
        got = eng.search_batch(ds.queries, K, **kw)
        assert not (set(got[0].ravel().tolist()) & drop)
        _assert_same(got, jeng.search_batch(ds.queries, K, **kw))
    eng.set_tombstones(list(drop) + [-5, 10 ** 9])    # out of range ignored
    jeng.set_tombstones(list(drop))
    got = eng.search_batch(ds.queries, K)
    assert not (set(got[0].ravel().tolist()) & drop)
    _assert_same(got, jeng.search_batch(ds.queries, K))
    eng.set_tombstones([])
    np.testing.assert_array_equal(eng.search_batch(ds.queries, K)[0], ids)


def test_load_batch_arrays_roundtrip(built, tmp_path):
    ds, idx, arrays = built
    path = str(tmp_path / "idx.npz")
    idx.save(path)
    for n_cands in (256, 7):
        got = load_batch_arrays(path, n_entry_cands=n_cands)
        want = idx.batch_arrays(n_entry_cands=n_cands)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _assert_same(_engine(load_batch_arrays(path)).search_batch(ds.queries, K),
                 _engine(arrays).search_batch(ds.queries, K))


def test_load_batch_arrays_without_nav(small_corpus, tmp_path):
    base = small_corpus.base[:200]
    idx = BAMGIndex.build(base, BAMGParams(r=8, l_build=16, knn_k=8,
                                           use_nav=False))
    path = str(tmp_path / "nonav.npz")
    idx.save(path)
    got = load_batch_arrays(path, n_entry_cands=64)
    np.testing.assert_array_equal(got["entry_cands"],
                                  idx.batch_arrays(64)["entry_cands"])


def test_engine_surface(built):
    ds, _, arrays = built
    eng = _engine(arrays, l=32, max_hops=16)
    assert eng.rerank_capacity == 32 and eng.effective_rerank(8) == 8
    with pytest.raises(ValueError, match="rerank capacity"):
        eng.search_batch(ds.queries, 33)
    with pytest.raises(ValueError, match="query dim"):
        eng.search_batch(ds.queries[:, :5], K)
    ids, _ = eng.search_batch(ds.queries[0], K)        # 1-D query promoted
    assert ids.shape == (1, K)
    eng.inject_fault()
    assert not eng.healthy
    with pytest.raises(RuntimeError, match="injected"):
        eng.search_batch(ds.queries, K)
    twin = eng.replicate("cpu")
    assert twin.healthy and twin is not eng
    eng.heal()
    assert eng.healthy and eng.place("cpu") is eng
    np.testing.assert_array_equal(twin.search_batch(ds.queries, K)[0],
                                  eng.search_batch(ds.queries, K)[0])
    assert eng.codes.dtype == torch.uint8 and eng.adj.dtype == torch.int32
    assert eng.memory_bytes() == (arrays["x"].nbytes + arrays["adj"].nbytes
                                  + arrays["codes"].nbytes
                                  + arrays["codebooks"].nbytes)


def test_default_device_is_cuda_and_never_falls_back(built):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, arrays = built
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedANNEngine(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _engine(arrays).place(None)


@pytest.mark.parametrize("name,hopper", [
    ("pallas", "cuda"), ("interpret", "ref"), ("fused_pallas", "fused"),
    ("fused_interpret", "fused_ref"), ("fused_stream", "fused"),
    ("fused_stream_interpret", "fused_ref"),
])
def test_tpu_backends_raise_with_counterpart(built, name, hopper):
    ds, _, arrays = built
    with pytest.raises(ValueError, match=f"counterpart is '{hopper}'"):
        _engine(arrays, backend=name).search_batch(ds.queries, K)


def test_resolve_backend():
    assert resolve_backend("auto", "cpu") == "ref"
    assert resolve_backend("auto", "cuda") == "fused"
    assert resolve_backend("fused_ref", "cpu") == "fused_ref"
    for kernel_backend in ("fused", "cuda"):
        with pytest.raises(ValueError, match="launches CUDA kernels"):
            resolve_backend(kernel_backend, "cpu")
    with pytest.raises(ValueError, match="must be one of"):
        resolve_backend("bogus", "cpu")
