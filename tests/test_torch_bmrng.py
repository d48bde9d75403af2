"""The port's exact graphs (`repro_torch.core.rng_rules`,
`repro_torch.core.bmrng`) against the JAX package's.

- **Bit for bit on integer points**: every squared distance of small
  integer coordinates is exact in f32, so both packages' distance
  matrices are equal and the numpy rules (with `np.argsort`'s default
  kind, whose tie order both share) give the same RNG, MRNG and BMRNG
  adjacency, and the same monotonic I/O paths.
- **Mirrors**: the four RNG / MRNG / BMRNG tests of
  tests/test_core_graphs.py on the port alone, distances on the CPU.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro.core import bmrng as ref_bmrng
from repro.core import rng_rules as ref_rules
from repro.core.distances import pairwise_sq_l2 as jax_pairwise
from repro_torch.core.block_assign import (bnf_blocks, random_blocks,
                                           uniform_blocks)
from repro_torch.core.bmrng import (build_bmrng, io_length,
                                    monotonic_io_path)
from repro_torch.core.distances import knn_graph
from repro_torch.core.rng_rules import (has_monotonic_path, in_lune,
                                        is_monotonic_path, mrng_edges,
                                        rng_edges, sq_dist_matrix)

CPU = "cpu"


def _points(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _int_points(n, d, seed):
    """Small integer coordinates: exact distances, and many ties."""
    return np.random.default_rng(seed).integers(-6, 7, (n, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# bit for bit against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rng_and_mrng_match_reference(seed):
    x = _int_points(36, 3, seed)
    d = sq_dist_matrix(x, CPU)
    np.testing.assert_array_equal(d, jax_pairwise(x, x))
    np.testing.assert_array_equal(rng_edges(x, CPU), ref_rules.rng_edges(x))
    np.testing.assert_array_equal(mrng_edges(x, device=CPU),
                                  ref_rules.mrng_edges(x))
    np.testing.assert_array_equal(mrng_edges(x, d), ref_rules.mrng_edges(x, d))
    adj = mrng_edges(x, d)
    for u, q, v in ((0, 5, 9), (3, 1, 2), (7, 7, 8)):
        assert in_lune(d, u, q, v) == ref_rules.in_lune(d, u, q, v)
    for u in range(0, 36, 7):
        for q in range(36):
            assert (has_monotonic_path(adj, d, u, q)
                    == ref_rules.has_monotonic_path(adj, d, u, q))
    path = [0, 4, 9]
    assert (is_monotonic_path(d, path, 9)
            == ref_rules.is_monotonic_path(d, path, 9))


@pytest.mark.parametrize("seed,cap", [(0, 4), (3, 6), (5, 29)])
def test_bmrng_matches_reference(seed, cap):
    x = _int_points(40, 4, seed)
    blocks = bnf_blocks(knn_graph(torch.from_numpy(x), 8).numpy(), cap,
                        seed=seed)
    got = build_bmrng(x, blocks, device=CPU)
    want = ref_bmrng.build_bmrng(x, blocks)
    assert got.adj.dtype == want.adj.dtype and got.blocks.dtype == \
        want.blocks.dtype
    np.testing.assert_array_equal(got.adj, want.adj)
    np.testing.assert_array_equal(got.blocks, want.blocks)
    np.testing.assert_array_equal(got.dist, want.dist)
    assert isinstance(got.dist, np.ndarray)
    for u in range(0, 40, 5):
        for q in range(0, 40, 3):
            a = monotonic_io_path(got.adj, got.dist, got.blocks, u, q)
            b = ref_bmrng.monotonic_io_path(want.adj, want.dist, want.blocks,
                                            u, q)
            assert a == b
            if a is not None:
                assert io_length(a, got.blocks) == ref_bmrng.io_length(
                    b, want.blocks)


def test_distances_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _int_points(6, 2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rng_edges(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_bmrng(x, np.zeros(6, np.int32))


# ---------------------------------------------------------------------------
# mirrors of tests/test_core_graphs.py
# ---------------------------------------------------------------------------
def test_rng_subset_of_mrng_outedges():
    x = _points(30, 3, 0)
    rng_adj = rng_edges(x, CPU)
    mrng_adj = mrng_edges(x, device=CPU)
    assert np.all(mrng_adj[rng_adj]), "MRNG must contain RNG edges"


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_mrng_monotonic_property(seed):
    x = _points(18, 3, seed)
    d = sq_dist_matrix(x, CPU)
    adj = mrng_edges(x, d)
    n = len(x)
    for u in range(0, n, 5):
        for q in range(n):
            if u != q:
                assert has_monotonic_path(adj, d, u, q), (u, q)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000), st.integers(3, 8))
def test_bmrng_theorem1_monotonic_io_path(seed, cap):
    x = _points(20, 3, seed)
    blocks = random_blocks(len(x), cap, seed=seed)
    g = build_bmrng(x, blocks, device=CPU)
    for u in range(0, len(x), 4):
        for q in range(len(x)):
            if u == q:
                continue
            path = monotonic_io_path(g.adj, g.dist, g.blocks, u, q)
            assert path is not None, f"no monotonic I/O path {u}->{q}"
            dq = g.dist[:, q]
            seg_end_prev = np.inf
            for a, b in zip(path, path[1:]):
                assert g.adj[a, b], f"non-edge {a}->{b}"
                if g.blocks[a] == g.blocks[b]:
                    assert dq[b] < dq[a], "intra-block step must decrease"
                else:
                    assert dq[a] < seg_end_prev, "segment end must decrease"
                    seg_end_prev = dq[a]
            assert dq[path[-1]] == 0.0 or path[-1] == q
            assert io_length(path, g.blocks) >= 1


def test_bmrng_sparser_than_mrng_same_io():
    x = _points(40, 4, 7)
    blocks = uniform_blocks(len(x), 8)
    g = build_bmrng(x, blocks, device=CPU)
    m = mrng_edges(x, device=CPU)
    same = blocks[:, None] == blocks[None, :]
    assert int((g.adj & ~same).sum()) <= int((m & ~same).sum())
