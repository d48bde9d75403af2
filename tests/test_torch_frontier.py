"""Port of the construction frontier vs the JAX reference: `beam_hops` in
exact-L2 mode (`kernels.beam_fused`) and `build.frontier.frontier_pools`.

The reference runs its beam as `backend="ref"` and as the Pallas kernel
in interpret mode; its frontiers as "batched", "fused_ref" and
"fused_interpret" (the port's "fused_ref" on its side).  Integer-valued corpora make every distance exact in
f32 and force (dist, id) ties, so there ids and dists compare bitwise.
Float corpora compare ids exactly and dists within rtol = 1e-5 (the port
sums the dot in ascending order, the reference in XLA's), with an atol of
1e-4 for distances near zero, where n2 - 2 x.q + |q|^2 cancels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.build.frontier import frontier_pools as jax_frontier_pools
from repro.core.distances import knn_graph as jax_knn_graph
from repro.core.distances import medoid as jax_medoid
from repro.kernels.beam_fused import beam_hops as jax_beam_hops
from repro_torch.build import BuildConfig, GraphBuilder
from repro_torch.build.frontier import default_hops, frontier_pools
from repro_torch.kernels.beam_fused import beam_hops, beam_hops_ref

NAMES = ("pool_ids", "pool_d", "pool_exp", "hops", "trace_ids", "trace_d",
         "next_id", "done")
CPU = torch.device("cpu")


def _corpus(n, d, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-4, 5, (n, d)).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _l2_case(n=300, r=8, d=12, b=5, l=12, integer=False, seed=3,
             case="plain"):
    """Random padded graph with dead ends, corpus, norms and queries, and
    a seeded sorted pool whose rows hold 0..3 seeds (exact L2).

    `case` reworks it into one of the inputs the CUDA kernel's
    de-duplication and merge lean on: "repeat_ids" (each adjacency row
    holds its ids twice, one three times), "self_loops" (every node is its
    own neighbour), "nbrs_in_pool" (each pool also holds neighbours of its
    first seed, under random dists that are not their L2 scores).
    """
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.2] = -1
    adj[rng.random(n) < 0.05] = -1
    if case == "repeat_ids":
        h = r // 2
        adj[:, h:2 * h] = adj[:, :h]
        adj[:, -1] = adj[:, 0]
    elif case == "self_loops":
        adj[np.arange(n), np.arange(n) % r] = np.arange(n)
    x = _corpus(n, d, integer, seed + 1)
    q = _corpus(b, d, integer, seed + 2)
    n2 = (x * x).sum(1).astype(np.float32)
    pool_ids = np.full((b, l), -1, np.int32)
    pool_d = np.full((b, l), np.inf, np.float32)
    for bi in range(b):
        s = bi % 4
        ids = rng.choice(n, s, replace=False).astype(np.int32)
        dd = ((x[ids] - q[bi]) ** 2).sum(1).astype(np.float32)
        if case == "nbrs_in_pool" and s:
            nb = adj[ids[0]]
            extra = np.setdiff1d(nb[nb >= 0], ids)
            ids = np.concatenate([ids, extra])[:l].astype(np.int32)
            dd = np.concatenate([dd, rng.integers(0, 4 * d, len(extra))])
            dd = dd[:l].astype(np.float32)
        o = np.lexsort((ids, dd))
        pool_ids[bi, :len(ids)], pool_d[bi, :len(ids)] = ids[o], dd[o]
    return adj, x, n2, q, pool_ids, pool_d, np.zeros((b, l), bool)


def _run_both(case, hops, jax_backend):
    adj, x, n2, q, pi, pd, pe = case
    want = jax_beam_hops(*(jnp.asarray(a) for a in (adj, pi, pd, pe)), hops,
                         x=jnp.asarray(x), n2=jnp.asarray(n2),
                         queries=jnp.asarray(q), backend=jax_backend,
                         tile_b=4, n_chunk=128)
    t = [torch.from_numpy(a) for a in case]
    got = beam_hops_ref(t[0], *t[4:], hops, x=t[1], n2=t[2], queries=t[3])
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _close(g, w, integer, err_msg=""):
    if w.dtype.kind == "f" and not integer:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                   err_msg=err_msg)
    else:
        np.testing.assert_array_equal(g, w, err_msg=err_msg)


@pytest.mark.parametrize("jax_backend", ("ref", "interpret"))
@pytest.mark.parametrize("integer", (True, False))
def test_beam_hops_l2_ref_matches_reference(jax_backend, integer):
    got, want = _run_both(_l2_case(integer=integer), 6, jax_backend)
    for g, w, name in zip(got, want, NAMES):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _close(g, w, integer, name)


@pytest.mark.parametrize("jax_backend", ("ref", "interpret"))
@pytest.mark.parametrize("case,r,l", [
    ("repeat_ids", 8, 12), ("nbrs_in_pool", 8, 12), ("self_loops", 8, 12),
    ("plain", 8, 40),                        # L not a multiple of 32
    ("repeat_ids", 16, 6)])                  # L < R
def test_beam_hops_l2_ref_edge_cases_match_reference(jax_backend, case, r, l):
    """The rules the CUDA kernel's hashed de-duplication and merge-path
    merge lean on, in exact-L2 mode, bitwise on all 8 outputs: duplicates
    are dropped by id, never by (dist, id); a pool entry outranks a
    candidate it ties."""
    case = _l2_case(r=r, l=l, integer=True, case=case)
    got, want = _run_both(case, 8, jax_backend)
    for g, w, name in zip(got, want, NAMES):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_beam_hops_l2_exhausts_and_reports_done():
    """Past exhaustion every row reports done, the next pick is -1, the
    trace tail is (-1, +inf), and the reference agrees bitwise."""
    got, want = _run_both(_l2_case(n=40, l=40, integer=True), 60, "ref")
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g, w, err_msg=name)
    _, _, _, hops, tid, td, next_id, done = got
    assert done.all() and (next_id == -1).all() and (hops <= 40).all()
    tail = np.arange(60)[None, :] >= hops[:, None]
    assert (tid[tail] == -1).all() and np.isinf(td[tail]).all()


def test_beam_hops_l2_wrapper_dispatch_on_cpu():
    """On CPU tensors the wrapper takes the plain version, counts no
    launch, and "cuda" raises; the operands pick the scoring mode."""
    adj, x, n2, q, pi, pd, pe = (torch.from_numpy(a) for a in _l2_case())
    before = (beam_hops.launches, beam_hops.l2_launches)
    got = beam_hops(adj, pi, pd, pe, 4, x=x, n2=n2, queries=q)
    want = beam_hops_ref(adj, pi, pd, pe, 4, x=x, n2=n2, queries=q)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    with pytest.raises(ValueError, match="CUDA tensors"):
        beam_hops(adj, pi, pd, pe, 4, x=x, n2=n2, queries=q, backend="cuda")
    assert (beam_hops.launches, beam_hops.l2_launches) == before
    assert not pe.any()                      # the input pool is not mutated


def _frontier_inputs(integer, n=600, d=16, k=12):
    x = _corpus(n, d, integer, seed=21)
    return x, jax_knn_graph(x, k), jax_medoid(x)


@pytest.mark.parametrize("backend,jax_backend", [
    ("batched", "batched"), ("fused_ref", "fused_ref"),
    ("fused_ref", "fused_interpret"), ("fused", "fused_ref")])
@pytest.mark.parametrize("integer", (True, False))
def test_frontier_pools_match_reference(backend, jax_backend, integer):
    """The same corpus, graph and entry give the reference's pools: every
    id equal, dists bitwise on integer corpora.  On the CPU "fused" is the
    plain version; the reference's Pallas interpret mode is held to it."""
    x, knn, med = _frontier_inputs(integer)
    nodes = np.arange(0, len(x), 3)
    kw = dict(ef=24, batch=64, width=4)
    if jax_backend == "fused_interpret":      # Pallas interpret: keep it short
        kw = dict(ef=16, batch=64, max_hops=6)
        nodes = nodes[:128]
    got = frontier_pools(x, knn, [med], nodes, backend=backend, device=CPU,
                         **kw)
    want = jax_frontier_pools(x, knn, [med], nodes, backend=jax_backend, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1], want[1], integer)


def test_frontier_fused_matches_batched_width1():
    """With an exhaustive pool (no evictions) the fused frontier visits
    the identical node sequence as the width-1 seen-mask beam (mirrors
    the reference's test of the same name)."""
    x, knn, med = _frontier_inputs(integer=False, n=300)
    nodes = np.arange(len(x))
    ids_b, d_b = frontier_pools(x, knn, [med], nodes, ef=len(x), max_hops=12,
                                batch=64, width=1, backend="batched",
                                device=CPU)
    ids_f, d_f = frontier_pools(x, knn, [med], nodes, ef=len(x), max_hops=12,
                                batch=64, backend="fused_ref", device=CPU)
    np.testing.assert_array_equal(ids_b, ids_f)
    # one batched product against the kernel's sequential dot
    _close(d_b, d_f, integer=False)


@pytest.mark.parametrize("name,hopper", [
    ("fused_pallas", "fused"), ("fused_stream", "fused"),
    ("fused_interpret", "fused_ref"), ("fused_stream_interpret", "fused_ref")])
def test_frontier_tpu_backends_raise_with_counterpart(name, hopper):
    """The JAX package's TPU frontier names raise, naming the port's
    counterpart, in `frontier_pools` and in `BuildConfig` alike."""
    x, knn, med = _frontier_inputs(integer=True, n=40, d=4, k=4)
    with pytest.raises(ValueError, match=f"counterpart is '{hopper}'"):
        frontier_pools(x, knn, [med], [0], ef=8, backend=name, device=CPU)
    with pytest.raises(ValueError, match=f"counterpart is '{hopper}'"):
        BuildConfig(frontier_backend=name)


def test_frontier_pools_sorted_unique_valid():
    x, knn, med = _frontier_inputs(integer=False, n=200, d=8, k=8)
    for backend in ("batched", "fused"):
        ids, d = frontier_pools(x, knn, [med], np.arange(40), ef=16, batch=16,
                                backend=backend, device=CPU)
        # output width = visited capacity (hops * width), not the beam ef
        width = 8 if backend == "batched" else 1
        assert ids.shape == d.shape == (40, default_hops(16, width) * width)
        for i in range(40):
            valid = ids[i] >= 0
            dv = d[i][valid]
            assert np.all(np.diff(dv) >= 0), "pool must be ascending"
            assert len(set(ids[i][valid].tolist())) == valid.sum(), "no dups"
            assert ids[i][valid].max() < 200
            assert np.all(np.isinf(d[i][~valid]))


def test_build_with_fused_frontier(small_corpus):
    """BuildConfig.frontier_backend plumbs through to a working build."""
    gb = GraphBuilder(BuildConfig(backend="batched",
                                  frontier_backend="fused_ref",
                                  batch_size=64), device=CPU)
    adj, entry = gb.build_nsg(small_corpus.base, r=12, l_build=24, knn_k=12,
                              seed=0)
    n = len(small_corpus.base)
    assert adj.shape == (n, 12)
    assert (adj >= -1).all() and (adj < n).all()
    assert (adj[adj >= 0] != np.repeat(np.arange(n), 12)
            [adj.ravel() >= 0]).all()                  # no self loops
    assert set(gb.timings) == {"knn", "frontier", "prune", "connect"}
    with pytest.raises(ValueError, match="frontier_backend"):
        BuildConfig(frontier_backend="bogus")
    with pytest.raises(ValueError, match="frontier backend"):
        frontier_pools(small_corpus.base, adj, [entry], [0], ef=8,
                       backend="stream", device=CPU)
