"""Port of batched BAMG construction vs the JAX reference.

Mirrors tests/test_build_parity.py and adds module-by-module parity for
what the construction path runs: `core.graph_build`, `core.block_assign`,
`core.bamg`, `core.navgraph`, `build.{prune,knn,bamg_refine,builder}` and
`core.engine.batch_arrays`.  The same numpy-seeded inputs go to both
packages; the port runs on the CPU (its plain versions).

- Integer-valued corpora make every distance exact in f32, so there the
  port must equal the reference on every id: kNN rows, pruned rows, NSG
  adjacency, BNF blocks, the refined BAMG adjacency, the nav layers.
- On float corpora the refine is held bit-identical given the same NSG
  and blocks (its scan is `build_bamg_from`, verbatim), and whole builds
  are held to the reference's recall budget.
"""
import numpy as np
import pytest
import torch

from repro.build import BuildConfig as JaxBuildConfig
from repro.build import GraphBuilder as JaxGraphBuilder
from repro.build import robust_prune_batch as jax_robust_prune_batch
from repro.build import robust_prune_inc as jax_robust_prune_inc
from repro.build.knn import clustered_knn_graph as jax_clustered_knn_graph
from repro.core import block_assign as jax_ba
from repro.core import graph_build as jax_gb
from repro.core import navgraph as jax_nav
from repro.core.bamg import build_bamg as jax_build_bamg
from repro.core.bamg import build_bamg_from as jax_build_bamg_from
from repro.core.distances import exact_knn as jax_exact_knn
from repro.core.distances import knn_graph as jax_knn_graph
from repro.core.distances import medoid as jax_medoid
from repro.core.storage import coupled_nodes_per_block as jax_cnpb
from repro.core.storage import max_capacity_for as jax_mcf
from repro_torch.build import (BuildConfig, GraphBuilder, robust_prune_batch,
                               robust_prune_inc)
from repro_torch.build.bamg_refine import refine_bamg_batched
from repro_torch.build.chunking import map_chunks
from repro_torch.build.knn import clustered_knn_graph
from repro_torch.core import block_assign as ba
from repro_torch.core import graph_build as gb
from repro_torch.core import navgraph as nav
from repro_torch.core.bamg import build_bamg, build_bamg_from
from repro_torch.core.distances import exact_knn, knn_graph, medoid
from repro_torch.core.engine import _pick_pq_m, batch_arrays
from repro_torch.core.pq import train_pq
from repro_torch.core.storage import (BLOCK_SIZE, coupled_nodes_per_block,
                                      max_capacity_for)
from repro_torch.serve import BatchedANNEngine, EngineConfig

CPU = torch.device("cpu")


def _points(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def int_corpus(small_corpus):
    """The shared clustered corpus rounded to integers: every squared
    distance is exact in f32, and rounding makes ties."""
    return np.round(small_corpus.base).astype(np.float32)


@pytest.fixture(scope="module")
def base_nsg(small_corpus):
    """Reference host NSG + BNF blocks on the shared float corpus."""
    x = small_corpus.base
    adj, entry = jax_gb.build_nsg(x, r=12, l_build=24, knn_k=12)
    return x, adj, entry, jax_ba.bnf_blocks(adj, 16, seed=0)


@pytest.fixture(scope="module")
def int_bamg(int_corpus):
    """Reference host BAMG (NSG, BNF, Alg. 2) on the integer corpus."""
    return jax_build_bamg(int_corpus, capacity=16, alpha=3, beta=1.05, r=12,
                          l_build=24, knn_k=12)


def _tensor(x):
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# Small modules
# ---------------------------------------------------------------------------
def test_storage_arithmetic_and_map_chunks():
    assert BLOCK_SIZE == 4096
    for r in (8, 12, 32, 64, 2000):
        assert max_capacity_for(r) == jax_mcf(r)
        for d in (24, 128, 960, 2048):
            assert coupled_nodes_per_block(d, r) == jax_cnpb(d, r)
    for starts in ([], [0], list(range(0, 100, 7))):
        seen = []
        map_chunks(starts, seen.append)
        assert sorted(seen) == starts


def test_knn_graph_breaks_ties_as_reference(int_corpus):
    """`jax.lax.top_k` keeps the lowest indices among entries tied at the
    k-th distance; `torch.topk` keeps any.  On a corpus with ties the
    port's kNN graph and exact kNN must still be the reference's."""
    x = int_corpus
    np.testing.assert_array_equal(knn_graph(_tensor(x), 12).numpy(),
                                  jax_knn_graph(x, 12))
    d, i = exact_knn(_tensor(x), _tensor(x[:50]), 20)
    jd, ji = jax_exact_knn(x, x[:50], 20)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(d.numpy(), jd)


# ---------------------------------------------------------------------------
# Host graph builders, block assignment, Algorithm 2, navigation graph
# ---------------------------------------------------------------------------
def test_graph_build_matches_reference(int_corpus):
    x = int_corpus
    assert medoid(_tensor(x)) == jax_medoid(x)
    knn = jax_knn_graph(x, 12)
    med = jax_medoid(x)
    for p in range(0, len(x), 61):
        got = gb.greedy_search(x, knn, med, x[p], ef=24)
        want = jax_gb.greedy_search(x, knn, med, x[p], ef=24)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        cand = np.unique(got[0][got[0] != p])
        cd = gb._dists_to(x, cand, x[p])
        np.testing.assert_array_equal(
            gb.robust_prune(x, p, cand, cd, 8, alpha=1.2),
            jax_gb.robust_prune(x, p, cand, cd, 8, alpha=1.2))
    adj, entry = gb.build_nsg(x, r=12, l_build=24, knn_k=12, device=CPU)
    jadj, jentry = jax_gb.build_nsg(x, r=12, l_build=24, knn_k=12)
    assert entry == jentry
    np.testing.assert_array_equal(adj, jadj)
    assert gb.degree_stats(adj) == jax_gb.degree_stats(jadj)
    # a graph with unreachable nodes: connect_to_entry must attach them
    # to the same nearest reached nodes
    cut, jcut = adj.copy(), adj.copy()
    cut[:, 6:] = -1
    jcut[:, 6:] = -1
    gb.connect_to_entry(x, cut, entry, device=CPU)
    jax_gb.connect_to_entry(x, jcut, entry)
    np.testing.assert_array_equal(cut, jcut)
    small = x[:120]
    vam = gb.build_vamana(small, r=8, l_build=16, device=CPU)
    jvam = jax_gb.build_vamana(small, r=8, l_build=16)
    assert vam[1] == jvam[1]
    np.testing.assert_array_equal(vam[0], jvam[0])


def test_block_assign_matches_reference(base_nsg):
    x, adj, _, blocks = base_nsg
    got = ba.bnf_blocks(adj, 16, seed=0)
    np.testing.assert_array_equal(got, blocks)
    np.testing.assert_array_equal(ba.block_members(got, 16),
                                  jax_ba.block_members(blocks, 16))
    assert ba.undirected_neighbor_lists(adj) == \
        jax_ba.undirected_neighbor_lists(adj)
    assert ba.intra_edge_fraction(adj, got) == \
        jax_ba.intra_edge_fraction(adj, blocks)
    np.testing.assert_array_equal(ba.uniform_blocks(len(x), 16),
                                  jax_ba.uniform_blocks(len(x), 16))
    np.testing.assert_array_equal(ba.random_blocks(len(x), 16, seed=3),
                                  jax_ba.random_blocks(len(x), 16, seed=3))


def test_bamg_matches_reference(base_nsg, int_corpus, int_bamg):
    """The host Alg. 2 scan on the reference's NSG and blocks, and the
    host build end to end on the integer corpus."""
    x, adj, entry, blocks = base_nsg
    for occ, beta in (("rule", 1.05), ("alg2", 1.0)):
        got = build_bamg_from(x, adj, entry, blocks, 16, alpha=3, beta=beta,
                              occlusion_ref=occ)
        want = jax_build_bamg_from(x, adj, entry, blocks, 16, alpha=3,
                                   beta=beta, occlusion_ref=occ)
        np.testing.assert_array_equal(got.adj, want.adj)
        np.testing.assert_array_equal(got.members, want.members)
    g = build_bamg(int_corpus, capacity=16, alpha=3, beta=1.05, r=12,
                   l_build=24, knn_k=12, device=CPU)
    for f in ("adj", "blocks", "members", "entry", "capacity"):
        np.testing.assert_array_equal(getattr(g, f), getattr(int_bamg, f),
                                      err_msg=f)


def test_navgraph_matches_reference(int_corpus, int_bamg):
    x = int_corpus
    np.testing.assert_array_equal(
        nav.select_block_representatives(int_bamg),
        jax_nav.select_block_representatives(int_bamg))
    got = nav.build_navgraph(x, int_bamg, alpha=3, beta=1.05, gamma=32,
                             device=CPU)
    want = jax_nav.build_navgraph(x, int_bamg, alpha=3, beta=1.05, gamma=32)
    assert got.n_layers == want.n_layers >= 2
    assert got.memory_bytes() == want.memory_bytes()
    for gl, wl in zip(got.layers, want.layers):
        np.testing.assert_array_equal(gl.vids, wl.vids)
        np.testing.assert_array_equal(gl.adj, wl.adj)
        assert gl.entry == wl.entry
    q = x[7] + 0.5
    dist = lambda vids: ((x[np.asarray(vids)] - q) ** 2).sum(1)
    assert nav.search_nav(got, dist, n_entry=4) == \
        jax_nav.search_nav(want, dist, n_entry=4)
    np.testing.assert_array_equal(
        nav.nav_pin_gblocks(got, int_bamg.blocks, 5),
        jax_nav.nav_pin_gblocks(want, int_bamg.blocks, 5))


# ---------------------------------------------------------------------------
# RobustPrune: identical edge sets given the same pools
# ---------------------------------------------------------------------------
def test_robust_prune_batch_matches_host_given_same_pools():
    x = _points(400, 24, seed=3)
    knn = jax_knn_graph(x, 12)
    med = jax_medoid(x)
    for p in range(0, 400, 37):
        vis_ids, _ = jax_gb.greedy_search(x, knn, med, x[p], ef=24)
        cand = np.unique(np.concatenate(
            [vis_ids.astype(np.int64),
             knn[p][knn[p] >= 0].astype(np.int64)]))
        cand = cand[cand != p]
        cd = jax_gb._dists_to(x, cand, x[p])
        for r, alpha in ((8, 1.0), (12, 1.2)):
            host_kept = jax_gb.robust_prune(x, p, cand, cd, r, alpha=alpha)
            batched = robust_prune_batch(
                x, np.array([p]), cand[None, :].astype(np.int32),
                cd[None, :].astype(np.float32), r=r, alpha=alpha,
                device=CPU)[0]
            batched = batched[batched >= 0]
            assert batched.tolist() == host_kept.tolist(), (p, r, alpha)


@pytest.mark.parametrize("integer", (True, False))
def test_robust_prune_batch_handles_pads_self_and_duplicates(integer):
    """Raw candidate rows (pads, self, repeats) reduce to np.unique
    semantics -- each batch row matches the host run on its clean pool,
    and the whole output matches the reference's batched prune."""
    x = _points(120, 8, seed=5)
    if integer:
        x = np.round(x * 2).astype(np.float32)
    rng = np.random.default_rng(7)
    b, c, r = 6, 30, 6
    p_ids = rng.choice(120, size=b, replace=False)
    cand = rng.integers(0, 120, size=(b, c)).astype(np.int32)
    cand[:, -4:] = -1
    cand[:, 0] = p_ids                       # self candidates must drop
    cand[:, 1] = cand[:, 2]                  # duplicate ids collapse
    out = robust_prune_batch(x, p_ids, cand, None, r=r, alpha=1.1,
                             device=CPU)
    np.testing.assert_array_equal(
        out, jax_robust_prune_batch(x, p_ids, cand, None, r=r, alpha=1.1))
    for i, p in enumerate(p_ids.tolist()):
        clean = np.unique(cand[i][cand[i] >= 0].astype(np.int64))
        clean = clean[clean != p]
        cd = jax_gb._dists_to(x, clean, x[p])
        host_kept = jax_gb.robust_prune(x, p, clean, cd, r, alpha=1.1)
        got = out[i][out[i] >= 0]
        assert got.tolist() == host_kept.tolist(), i


def test_robust_prune_inc_matches_reference():
    x = _points(80, 8, seed=9)
    rng = np.random.default_rng(2)
    for _ in range(5):
        ids = rng.integers(0, 80, 25)
        for r, alpha in ((6, 1.0), (10, 1.2)):
            np.testing.assert_array_equal(
                robust_prune_inc(x[0], ids, x[ids], r, alpha=alpha),
                jax_robust_prune_inc(x[0], ids, x[ids], r, alpha=alpha))
    assert robust_prune_inc(x[0], [], x[:0], 4).shape == (0,)


# ---------------------------------------------------------------------------
# BAMG refinement: bit-identical adjacency
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("occlusion_ref", ["rule", "alg2"])
@pytest.mark.parametrize("beta", [1.0, 1.05])
def test_refine_bamg_batched_bit_identical(base_nsg, occlusion_ref, beta):
    x, adj, entry, blocks = base_nsg
    host = jax_build_bamg_from(x, adj, entry, blocks, 16, alpha=3,
                               beta=beta, occlusion_ref=occlusion_ref)
    bat = refine_bamg_batched(x, adj, entry, blocks, 16, alpha=3, beta=beta,
                              occlusion_ref=occlusion_ref, device=CPU)
    np.testing.assert_array_equal(host.adj, bat.adj)
    np.testing.assert_array_equal(host.blocks, bat.blocks)
    np.testing.assert_array_equal(host.members, bat.members)


def test_refine_bamg_batched_respects_ablation_flags(base_nsg):
    x, adj, entry, blocks = base_nsg
    host = jax_build_bamg_from(x, adj, entry, blocks, 16, alpha=2, beta=1.0,
                               sibling_edges=False, max_degree=10)
    bat = refine_bamg_batched(x, adj, entry, blocks, 16, alpha=2, beta=1.0,
                              sibling_edges=False, max_degree=10,
                              pair_chunk=64, device=CPU)
    np.testing.assert_array_equal(host.adj, bat.adj)


# ---------------------------------------------------------------------------
# kNN stage and full builds
# ---------------------------------------------------------------------------
def test_clustered_knn_matches_exact_on_probed_neighbors():
    """On clustered corpora the probed top-k recovers nearly all exact
    neighbours, and on an integer corpus it is the reference's graph."""
    from repro.data.synthetic import make_vector_dataset

    ds = make_vector_dataset("knn-test", n=2500, d=24, nq=1, k_gt=1,
                             n_clusters=25, seed=17)
    x = ds.base
    approx = clustered_knn_graph(x, 8, seed=0, device=CPU)
    exact = jax_knn_graph(x, 8)
    assert approx.shape == exact.shape and approx.dtype == np.int32
    n = len(x)
    overlap = np.mean([
        len(set(approx[i][approx[i] >= 0].tolist())
            & set(exact[i].tolist())) / 8 for i in range(n)])
    assert overlap >= 0.9, overlap
    for i in range(0, n, 97):
        row = approx[i][approx[i] >= 0]
        assert i not in row.tolist()
        assert len(set(row.tolist())) == len(row)
    xi = np.round(x).astype(np.float32)
    np.testing.assert_array_equal(clustered_knn_graph(xi, 8, device=CPU),
                                  jax_clustered_knn_graph(xi, 8))


@pytest.mark.parametrize("frontier_backend", ("batched", "fused_ref"))
def test_batched_build_matches_reference(int_corpus, frontier_backend):
    """Port and reference batched builds on the integer corpus: the same
    NSG, blocks and refined BAMG, id for id."""
    kw = dict(alpha=3, beta=1.05, r=12, l_build=24, knn_k=12, max_degree=12)
    got = GraphBuilder(BuildConfig(backend="batched", batch_size=128,
                                   frontier_backend=frontier_backend),
                       device=CPU).build_bamg(int_corpus, 16, **kw)
    want = JaxGraphBuilder(JaxBuildConfig(
        backend="batched", batch_size=128,
        frontier_backend=frontier_backend)).build_bamg(int_corpus, 16, **kw)
    for f in ("adj", "blocks", "members", "entry"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _graph_recall(x, graph, queries, gt, l=64):
    from repro.core.engine import BAMGIndex, BAMGParams
    from repro.core.pq import train_pq as jax_train_pq
    from repro.core.storage import DecoupledStorage

    codec = jax_train_pq(x, m=8, seed=0)
    idx = BAMGIndex(x, graph, codec, codec.encode(x),
                    DecoupledStorage(x, graph.adj, graph.blocks,
                                     graph.members),
                    None, BAMGParams(r=12, use_nav=False))
    st = idx.search_batch(queries, k=10, l=l, gt=gt)
    return st.recall, st.mean_nio


def test_backend_recall_within_budget(small_corpus):
    """The port's batched builds (seen-mask and fused frontiers) searched
    by the reference's host engine: recall within the reference's budget
    of its own host build, and the same mean degree within 10%."""
    ds = small_corpus
    kw = dict(alpha=3, beta=1.05, r=12, l_build=24, knn_k=12, max_degree=12)
    graphs = {"host": JaxGraphBuilder(JaxBuildConfig(backend="host"))
              .build_bamg(ds.base, 16, **kw)}
    for fb in ("batched", "fused"):
        graphs[fb] = GraphBuilder(BuildConfig(
            backend="batched", frontier_backend=fb), device=CPU).build_bamg(
            ds.base, 16, **kw)
    rec = {k: _graph_recall(ds.base, g, ds.queries, ds.gt)[0]
           for k, g in graphs.items()}
    deg = {k: gb.degree_stats(g.adj)["total"] for k, g in graphs.items()}
    assert rec["host"] >= 0.6, rec
    for fb in ("batched", "fused"):
        assert abs(rec[fb] - rec["host"]) <= 0.01, rec
        assert abs(deg[fb] - deg["host"]) <= 0.1 * deg["host"], deg


def test_batched_vamana_reachable_and_degree_bounded():
    x = _points(300, 8, seed=11)
    g = GraphBuilder(BuildConfig(backend="batched", batch_size=64),
                     device=CPU)
    adj, entry = g.build_vamana(x, r=12, l_build=24)
    assert adj.shape == (300, 12)
    seen = np.zeros(len(x), bool)
    stack = [entry]
    seen[entry] = True
    while stack:
        v = stack.pop()
        for u in adj[v]:
            if u >= 0 and not seen[u]:
                seen[u] = True
                stack.append(int(u))
    assert seen.mean() > 0.98


def test_build_config_defaults_to_the_card_path():
    """`BuildConfig()` is the batched build with the fused L2 frontier,
    the path that runs on the card; the host oracle must be asked for."""
    cfg = BuildConfig()
    assert (cfg.backend, cfg.frontier_backend) == ("batched", "fused")
    assert GraphBuilder(device=CPU).config == cfg


def test_build_config_rejects_unknown_backend():
    with pytest.raises(ValueError):
        BuildConfig(backend="gpu")
    with pytest.raises(ValueError):
        BuildConfig(knn_mode="lsh")


# ---------------------------------------------------------------------------
# Built index -> serving arrays -> engine
# ---------------------------------------------------------------------------
def test_batch_arrays_matches_reference(small_corpus):
    """`batch_arrays` on a reference-built index's parts, with the port's
    nav graph over the same BAMG, is that index's `batch_arrays()`."""
    from repro.core.engine import BAMGIndex, BAMGParams

    x = small_corpus.base
    idx = BAMGIndex.build(x, BAMGParams(alpha=3, beta=1.05, r=12,
                                        l_build=24, knn_k=12, gamma=32))
    ng = nav.build_navgraph(x, idx.graph, alpha=3, beta=1.05, gamma=32,
                            device=CPU)
    for n_entry_cands in (16, 10_000):
        got = batch_arrays(x, idx.graph, idx.codes, idx.codec.codebooks, ng,
                           n_entry_cands=n_entry_cands)
        want = idx.batch_arrays(n_entry_cands=n_entry_cands)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    no_nav = batch_arrays(x, idx.graph, idx.codes, idx.codec.codebooks,
                          None, n_entry_cands=16)
    assert no_nav["entry_cands"].tolist() == np.linspace(
        0, len(x) - 1, 16, dtype=np.int64).tolist()


def test_engine_serves_a_port_built_index(small_corpus):
    """Build (batched, fused frontier), PQ, nav graph and serving arrays
    through the port alone, then serve: recall as the reference's
    `test_engine_builds_accept_backend_knob` demands of its build."""
    ds = small_corpus
    x = ds.base
    g = GraphBuilder(BuildConfig(backend="batched", frontier_backend="fused"),
                     device=CPU).build_bamg(
        x, max_capacity_for(16), alpha=3, beta=1.05, r=16, l_build=32,
        knn_k=16, max_degree=16)
    xt = _tensor(x)
    codec = train_pq(xt, m=_pick_pq_m(x.shape[1]), seed=0)
    ng = nav.build_navgraph(x, g, alpha=3, beta=1.05, gamma=64, device=CPU)
    arrays = batch_arrays(xt, g, codec.encode(xt), codec.codebooks, ng)
    eng = BatchedANNEngine(arrays, EngineConfig(l=64, max_hops=64),
                           device=CPU)
    ids, dists = eng.search_batch(ds.queries, 10)
    hits = sum(len(set(a.tolist()) & set(b[:10].tolist()))
               for a, b in zip(ids, ds.gt))
    assert hits / (10 * len(ids)) >= 0.9
    assert (np.diff(dists, axis=1) >= 0).all()
