"""Port `pool_merge` / `pool_merge_ranked` vs the JAX reference, bitwise.

Mirrors the sweeps of tests/test_beam_fused.py: integer-quantized
distances force (dist, id) ties, candidates duplicate the pool and each
other, rows may be all padding, and merges chain (each output is the
next call's pool).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.build.pool import pool_merge as jax_pool_merge
from repro.build.pool import pool_merge_ranked as jax_pool_merge_ranked
from repro_torch.build.pool import pool_merge, pool_merge_ranked

RNG = np.random.default_rng(11)
# jitted once per shape: the reference merges are plain jnp functions
_JAX_MERGES = [jax.jit(f, static_argnums=5)
               for f in (jax_pool_merge, jax_pool_merge_ranked)]


def _sorted_pool(b, l, n_ids, n_dists=5):
    """Random pool satisfying the merge invariant: ascending (dist, id),
    unique valid ids, invalid entries exactly (-1, +inf, False)."""
    pool_ids = np.full((b, l), -1, np.int32)
    pool_d = np.full((b, l), np.inf, np.float32)
    pool_exp = np.zeros((b, l), bool)
    nvalid = int(RNG.integers(0, l + 1))
    for bi in range(b):
        vids = RNG.choice(n_ids, size=min(nvalid, n_ids), replace=False)
        vd = RNG.integers(0, n_dists, size=len(vids)).astype(np.float32)
        o = np.lexsort((vids, vd))
        pool_ids[bi, : len(vids)] = vids[o]
        pool_d[bi, : len(vids)] = vd[o]
        pool_exp[bi, : len(vids)] = RNG.random(len(vids)) < 0.5
    return pool_ids, pool_d, pool_exp


def _cands(b, r, n_ids):
    ids = RNG.integers(-1, n_ids, size=(b, r)).astype(np.int32)
    d = np.where(ids < 0, np.inf,
                 RNG.integers(0, 5, size=(b, r))).astype(np.float32)
    return ids, d


def _assert_port_matches(pool, cands, l):
    """Both port merges equal both reference merges on every output."""
    jargs = [jnp.asarray(a) for a in (*pool, *cands)]
    targs = [torch.from_numpy(np.array(a)) for a in (*pool, *cands)]
    want, want_r = ([np.asarray(a) for a in fn(*jargs, l)]
                    for fn in _JAX_MERGES)
    for fn in (pool_merge, pool_merge_ranked):
        got = [a.numpy() for a in fn(*targs, l)]
        for g, w, wr, name in zip(got, want, want_r,
                                  ("ids", "dists", "expanded")):
            assert g.dtype == w.dtype, (fn.__name__, name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{fn.__name__} {name}")
            np.testing.assert_array_equal(g, wr, err_msg=f"{fn.__name__} {name}")
    return want


@pytest.mark.parametrize("lo", (1, 5, 9, 16))
def test_pool_merge_sweep_matches_reference(lo):
    b, l, r, n_ids = 3, 9, 7, 14
    for _ in range(12):
        pool = _sorted_pool(b, l, n_ids)
        merged = _assert_port_matches(pool, _cands(b, r, n_ids), lo)
        # chained: the (invariant-satisfying) output is the next pool
        _assert_port_matches(merged, _cands(b, r, n_ids), lo)


def test_pool_merge_all_padded_candidates():
    """An all-(-1) candidate chunk leaves the pool bit-identical."""
    pool = _sorted_pool(4, 8, 20)
    cand = (np.full((4, 6), -1, np.int32), np.full((4, 6), np.inf, np.float32))
    out = _assert_port_matches(pool, cand, 8)
    np.testing.assert_array_equal(out[0], pool[0])
    np.testing.assert_array_equal(out[2], pool[2])


def test_pool_merge_all_padded_pool():
    """An empty pool (every slot invalid) takes the candidates in order."""
    pool = (np.full((3, 6), -1, np.int32), np.full((3, 6), np.inf, np.float32),
            np.zeros((3, 6), bool))
    _assert_port_matches(pool, _cands(3, 5, 9), 6)


def test_pool_merge_duplicates_across_chunks():
    """A candidate duplicating a pool id is dropped (the incumbent keeps
    its expanded flag); duplicates within the chunk collapse to one."""
    pool = (np.array([[3, 7, -1, -1]], np.int32),
            np.array([[1.0, 2.0, np.inf, np.inf]], np.float32),
            np.array([[True, False, False, False]]))
    cand = (np.array([[7, 5, 5, 3]], np.int32),
            np.array([[2.0, 1.5, 1.5, 1.0]], np.float32))
    out = _assert_port_matches(pool, cand, 4)
    np.testing.assert_array_equal(out[0], [[3, 5, 7, -1]])
    np.testing.assert_array_equal(out[2], [[True, False, False, False]])


def test_pool_merge_tie_break_is_by_id_not_concat_order():
    """Equal distances order by id, whatever the concat order."""
    pool = (np.array([[4, -1, -1]], np.int32),
            np.array([[1.0, np.inf, np.inf]], np.float32),
            np.zeros((1, 3), bool))
    cand = (np.array([[9, 2]], np.int32), np.array([[1.0, 1.0]], np.float32))
    out = _assert_port_matches(pool, cand, 3)
    np.testing.assert_array_equal(out[0], [[2, 4, 9]])
