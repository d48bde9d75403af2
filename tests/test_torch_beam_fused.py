"""Port `beam_hops_ref` (ADC mode) vs the JAX reference on all 8 outputs.

The reference runs as `beam_hops(backend="ref")` and as the Pallas kernel
in interpret mode (`backend="interpret"`).  Integer-valued tables make
every ADC sum exact and force distance ties, so those runs compare
bitwise; random tables compare ids, flags, hops and picks exactly and
dists within rtol = atol = 1e-5 (the reference's `.sum(-1)` and the
one-hot matmul reduce in another order than the port's ascending-m sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.beam_fused import beam_hops as jax_beam_hops
from repro_torch.kernels.beam_fused import beam_hops, beam_hops_ref

NAMES = ("pool_ids", "pool_d", "pool_exp", "hops", "trace_ids", "trace_d",
         "next_id", "done")


def _graph(n=300, r=8, m=4, k=16, b=5, l=12, integer=False, seed=3,
           case="plain"):
    """Random padded graph, codes, tables and a seeded sorted pool whose
    rows hold 0..3 seeds (a row with none has no frontier at all).

    `case` reworks it into one of the inputs the CUDA kernel's
    de-duplication and merge lean on: "repeat_ids" (each adjacency row
    holds its ids twice, one three times), "self_loops" (every node is its
    own neighbour), "nbrs_in_pool" (each pool also holds neighbours of its
    first seed, under random dists that are not their ADC scores).
    """
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.2] = -1                # padded slots
    adj[rng.random(n) < 0.05] = -1                    # dead ends
    if case == "repeat_ids":
        h = r // 2
        adj[:, h:2 * h] = adj[:, :h]
        adj[:, -1] = adj[:, 0]
    elif case == "self_loops":
        adj[np.arange(n), np.arange(n) % r] = np.arange(n)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    tables = (rng.integers(0, 4, (b, m, k)) if integer
              else rng.random((b, m, k))).astype(np.float32)
    pool_ids = np.full((b, l), -1, np.int32)
    pool_d = np.full((b, l), np.inf, np.float32)
    for bi in range(b):
        s = bi % 4
        ids = rng.choice(n, s, replace=False).astype(np.int32)
        if case == "nbrs_in_pool" and s:
            nb = adj[ids[0]]
            ids = np.concatenate([ids, np.setdiff1d(nb[nb >= 0], ids)])
            ids = ids[:l].astype(np.int32)
        d = (rng.integers(0, 3, len(ids)) if integer
             else rng.random(len(ids)))
        o = np.lexsort((ids, d))
        pool_ids[bi, :len(ids)], pool_d[bi, :len(ids)] = ids[o], d[o]
    pool_exp = np.zeros((b, l), bool)
    return adj, codes, tables, pool_ids, pool_d, pool_exp


def _run_both(args, hops, jax_backend):
    adj, codes, tables, pi, pd, pe = args
    want = jax_beam_hops(*(jnp.asarray(a) for a in (adj, pi, pd, pe)), hops,
                         tables=jnp.asarray(tables),
                         codes=jnp.asarray(codes.astype(np.int32)),
                         backend=jax_backend, tile_b=4, n_chunk=128)
    got = beam_hops_ref(*(torch.from_numpy(a) for a in (adj, pi, pd, pe)),
                        hops, tables=torch.from_numpy(tables),
                        codes=torch.from_numpy(codes))
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("jax_backend", ("ref", "interpret"))
@pytest.mark.parametrize("integer", (True, False))
def test_beam_hops_ref_matches_reference(jax_backend, integer):
    args = _graph(integer=integer)
    got, want = _run_both(args, 6, jax_backend)
    for g, w, name in zip(got, want, NAMES):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind == "f" and not integer:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("jax_backend", ("ref", "interpret"))
@pytest.mark.parametrize("case,r,l", [
    ("repeat_ids", 8, 12), ("nbrs_in_pool", 8, 12), ("self_loops", 8, 12),
    ("plain", 8, 40),                        # L not a multiple of 32
    ("repeat_ids", 16, 6)])                  # L < R
def test_beam_hops_ref_edge_cases_match_reference(jax_backend, case, r, l):
    """The rules the CUDA kernel's hashed de-duplication and merge-path
    merge lean on, bitwise on all 8 outputs: duplicates are dropped by id,
    never by (dist, id); a pool entry outranks a candidate it ties."""
    args = _graph(r=r, l=l, integer=True, case=case)
    got, want = _run_both(args, 8, jax_backend)
    for g, w, name in zip(got, want, NAMES):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_beam_hops_exhausts_and_reports_done():
    """Past exhaustion every row reports done, the next pick is -1, the
    trace tail is (-1, +inf), and the reference agrees."""
    args = _graph(n=40, l=40, integer=True)
    got, want = _run_both(args, 60, "ref")
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g, w, err_msg=name)
    _, _, _, hops, tid, td, next_id, done = got
    assert done.all() and (next_id == -1).all() and (hops <= 40).all()
    tail = np.arange(60)[None, :] >= hops[:, None]
    assert (tid[tail] == -1).all() and np.isinf(td[tail]).all()


def test_beam_hops_wrapper_dispatch_on_cpu():
    adj, codes, tables, pi, pd, pe = (torch.from_numpy(a) for a in _graph())
    before = beam_hops.launches
    got = beam_hops(adj, pi, pd, pe, 4, tables=tables, codes=codes)
    want = beam_hops_ref(adj, pi, pd, pe, 4, tables=tables, codes=codes)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    with pytest.raises(ValueError, match="CUDA tensors"):
        beam_hops(adj, pi, pd, pe, 4, tables=tables, codes=codes,
                  backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        beam_hops(adj, pi, pd, pe, 4, tables=tables, codes=codes,
                  backend="stream")
    assert beam_hops.launches == before
    assert not pe.any()                      # the input pool is not mutated
