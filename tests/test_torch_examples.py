"""The port's examples (`examples_torch/`) against the JAX package (CPU).

Each script's `main()` runs in this process with `--device cpu` at tiny
sizes.  Where a figure is deterministic the same steps run through the
JAX package's own calls at the same sizes and seed, and the figures must
be equal: quickstart's recall@10, mean NIO and cached NIO, serve_ann's
batched and host-loop recall@10, fresh_serving's recall after the
consolidation.  Both packages build on the same construction frontier,
the reference's "batched" with the port's "batched"
(`test_torch_disk_search._pair_frontier`): the frontiers' pools differ
in order across them.  DIN's parameters are drawn by torch, so the
retrieval example is held to its own brute-force check; train_lm, cut
after 2 steps and resumed, gives the uninterrupted run's losses.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core import engine as ref_engine
from repro.core.distances import exact_knn as j_exact_knn
from repro.core.distances import recall_at_k as j_recall
from repro.data.synthetic import make_vector_dataset as j_dataset
from repro.index.delta import DeltaParams as JDeltaParams
from repro.index.delta import FreshService as JFreshService
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ShardedFrontend as JFrontend
from test_torch_disk_search import _pair_frontier

EXAMPLES = Path(__file__).resolve().parent.parent / "examples_torch"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def paired(monkeypatch):
    _pair_frontier(monkeypatch, "batched")


def test_quickstart_matches_reference(paired):
    n, d, nq = 200, 16, 8
    got = _example("quickstart").main(
        ["--device", "cpu", "--n", str(n), "--d", str(d), "--nq", str(nq)])
    ds = j_dataset("quickstart", n=n, d=d, nq=nq, k_gt=10, seed=0)
    idx = ref_engine.BAMGIndex.build(ds.base, ref_engine.BAMGParams(
        alpha=3, beta=1.05, build_backend="batched"))
    # the example's sequence: one query, the batch, pipelined, cached
    r = idx.search(ds.queries[0], k=10, l=40)
    st = idx.search_batch(ds.queries, k=10, l=40, gt=ds.gt)
    idx.configure_io(qd=8, batch_io=True)
    idx.search_batch(ds.queries, k=10, l=40, gt=ds.gt)
    idx.configure_io(cache_policy="2q", pin_nav_blocks=16)
    stq = idx.search_batch(ds.queries, k=10, l=40, gt=ds.gt)
    assert (got["recall"], got["mean_nio"], got["cached_nio"]) == (
        st.recall, st.mean_nio, stq.mean_nio)
    assert (got["blocks"], got["q0_nio"]) == (idx.graph.members.shape[0],
                                              r.nio)


def test_serve_ann_matches_reference(paired):
    n, d, nq, shards, k = 160, 16, 8, 4, 10
    got = _example("serve_ann").main(
        ["--device", "cpu", "--n", str(n), "--d", str(d), "--nq", str(nq),
         "--shards", str(shards), "--requests", "8"])
    ds = j_dataset("serve", n=n, d=d, nq=nq, k_gt=k, seed=0)
    fe = JFrontend.build(ds.base, shards, params=ref_engine.BAMGParams(
        alpha=3, beta=1.05, r=16, l_build=32, knn_k=16,
        build_backend="batched"), config=JEngineConfig(l=24, max_hops=24))
    ids, _ = fe.search_batch(ds.queries, k=k)
    tops = []
    for q in ds.queries:
        cand = [(vids[r.ids], r.dists) for vids, r in (
            (v, i.search(q, k=k, l=24))
            for v, i in zip(fe.shard_vids, fe.host_indexes))]
        all_ids = np.concatenate([c[0] for c in cand])
        all_d = np.concatenate([c[1] for c in cand])
        tops.append(all_ids[np.argsort(all_d)[:k]])
    assert got["recall"] == j_recall(ids, ds.gt, k)
    assert got["host_recall"] == j_recall(np.stack(tops), ds.gt, k)
    assert got["sched_p50_ms"] > 0 and 0 <= got["sched_deadline_hit"] <= 1


def test_fresh_serving_matches_reference(paired, tmp_path):
    n, d, nq, m, k, l = 160, 16, 8, 16, 10, 48
    got = _example("fresh_serving").main(
        ["--device", "cpu", "--n", str(n), "--d", str(d), "--nq", str(nq),
         "--inserts", str(m)])
    ds = j_dataset("fresh", n=n, d=d, nq=nq, k_gt=k, n_clusters=16, seed=0)
    svc = JFreshService(str(tmp_path), params=ref_engine.BAMGParams(
        r=16, l_build=32, seed=0, build_backend="batched"),
        config=JEngineConfig(l=l, max_hops=24),
        delta_params=JDeltaParams(r=16, ef=48))
    svc.bootstrap(ds.base, "gen-0")
    rng = np.random.default_rng(1)
    new = (ds.base[rng.integers(0, n, m)]
           + 0.02 * rng.standard_normal((m, d)).astype(np.float32))
    ext = svc.insert_batch(new)
    svc.delete(int(ds.gt[0, 0]))
    svc.delete(int(ext[1]))
    svc.consolidate("gen-1", queries=ds.queries, k=k, min_recall=0.5,
                    keep_builds=2)
    live_x, live_ext = svc.live_corpus()
    _, rows = j_exact_knn(live_x, ds.queries, k)
    gt = live_ext[np.asarray(rows)]
    ids, _ = svc.search_batch(ds.queries, k, l=l)
    want = sum(len(set(r.tolist()) & set(g.tolist()))
               for r, g in zip(ids, gt)) / (len(gt) * k)
    assert got["post_swap_recall"] == want
    assert got["n_live"] == svc.n_live == n + m - 2
    assert got["validation_recall"] == svc.last_validation_recall


def test_din_retrieval_runs(paired):
    """Torch-drawn parameters: the figures are the example's own, the
    BAMG shortlist checked against brute force on the trained table."""
    got = _example("din_retrieval").main(
        ["--device", "cpu", "--n-items", "512", "--steps", "3",
         "--batch", "64", "--users", "4"])
    assert np.isfinite(got["loss"]) and got["blocks"] > 0
    assert got["recall"] >= 0.9 and got["mean_nio"] > 0
    assert got["brute_force_blocks"] == 512 * 16 * 4 // 4096


def test_train_lm_resumes_exactly(tmp_path):
    """A run cut after step 2 (its checkpoint written) and rerun resumes
    there, and its losses are the uninterrupted run's."""
    mod = _example("train_lm")
    small = ["--device", "cpu", "--steps", "4", "--layers", "1",
             "--d-model", "32", "--vocab", "128", "--seq", "8", "--batch",
             "2", "--ckpt-every", "2", "--log-every", "1"]
    whole = mod.main(small + ["--ckpt-dir", str(tmp_path / "a")])
    cut = mod.main(small + ["--ckpt-dir", str(tmp_path / "b"),
                            "--stop-after", "2"])
    rest = mod.main(small + ["--ckpt-dir", str(tmp_path / "b")])
    assert (whole["start"], cut["end"], rest["start"]) == (0, 2, 2)
    assert sorted(whole["losses"]) == [1, 2, 3, 4]
    assert {**cut["losses"], **rest["losses"]} == whole["losses"]
