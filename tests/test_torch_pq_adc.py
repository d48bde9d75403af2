"""Port PQ, ADC, distances and synthetic data vs the JAX reference (CPU).

The plain ADC versions sum over m in ascending order; the reference's
`pq_adc_ref` reduces with `.sum(-1)`, whose order XLA chooses, so float
tables agree within rtol = atol = 1e-5 and integer-valued tables (exact
sums) agree bitwise.  The Pallas kernels run in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro.core.engine import _pick_pq_m as jax_pick_pq_m
from repro.core.pq import adc_tables as jax_adc_tables
from repro.core.pq import train_pq as jax_train_pq
from repro.data import synthetic as jsyn
from repro.kernels.pq_adc import pq_adc as jax_pq_adc
from repro.kernels.pq_adc import pq_adc_rowwise as jax_pq_adc_rowwise
from repro_torch.core import distances as td
from repro_torch.core.engine import _pick_pq_m
from repro_torch.core.pq import PQCodec, adc_tables, train_pq
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.pq_adc import (pq_adc, pq_adc_ref, pq_adc_rowwise,
                                        pq_adc_rowwise_ref)

RNG = np.random.default_rng(0)
T = torch.from_numpy


def _tables(shape, integer):
    if integer:
        return RNG.integers(0, 8, shape).astype(np.float32)
    return RNG.random(shape).astype(np.float32)


@pytest.mark.parametrize("integer", (False, True))
@pytest.mark.parametrize("b,n,m,k", [
    (1, 256, 8, 16), (3, 700, 16, 256), (9, 1024, 4, 64), (2, 100, 32, 256),
])
def test_pq_adc_matches_reference(b, n, m, k, integer):
    tables = _tables((b, m, k), integer)
    codes = RNG.integers(0, k, (n, m)).astype(np.uint8)
    got = pq_adc(T(tables), T(codes)).numpy()            # auto on CPU: plain
    np.testing.assert_array_equal(got, pq_adc_ref(T(tables), T(codes)).numpy())
    for backend in ("ref", "interpret"):
        want = np.asarray(jax_pq_adc(jnp.asarray(tables), jnp.asarray(codes),
                                     backend=backend))
        if integer:
            np.testing.assert_array_equal(got, want, err_msg=backend)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=backend)


@pytest.mark.parametrize("integer", (False, True))
@pytest.mark.parametrize("b,r,m,k", [
    (1, 8, 8, 16), (3, 33, 16, 256), (9, 64, 4, 64), (2, 5, 32, 256),
])
def test_pq_adc_rowwise_matches_reference(b, r, m, k, integer):
    tables = _tables((b, m, k), integer)
    codes = RNG.integers(0, k, (b, r, m)).astype(np.uint8)
    got = pq_adc_rowwise(T(tables), T(codes)).numpy()
    assert got.shape == (b, r)
    np.testing.assert_array_equal(
        got, pq_adc_rowwise_ref(T(tables), T(codes.astype(np.int32))).numpy())
    for backend in ("ref", "interpret"):
        want = np.asarray(jax_pq_adc_rowwise(
            jnp.asarray(tables), jnp.asarray(codes), backend=backend))
        if integer:
            np.testing.assert_array_equal(got, want, err_msg=backend)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=backend)


def test_plain_adc_sums_in_ascending_m():
    """Summation order is part of the contract the CUDA kernels keep:
    ((t0 + t1) + t2) + ..., which differs from a pairwise sum here."""
    tables = np.array([[[1e8], [1.0], [-1e8], [1.0]]], np.float32)  # (1, 4, 1)
    codes = np.zeros((1, 4), np.uint8)
    want = np.float32(np.float32(np.float32(np.float32(1e8) + 1) - 1e8) + 1)
    assert pq_adc_ref(T(tables), T(codes)).item() == want
    assert pq_adc_rowwise_ref(T(tables), T(codes[None])).item() == want


def test_kernel_wrappers_dispatch_on_cpu():
    tables = T(_tables((2, 4, 16), False))
    codes = T(RNG.integers(0, 16, (10, 4)).astype(np.uint8))
    before = (pq_adc.launches, pq_adc_rowwise.launches)
    np.testing.assert_array_equal(pq_adc(tables, codes, backend="ref").numpy(),
                                  pq_adc(tables, codes).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_adc(tables, codes, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_adc_rowwise(tables, codes[None].expand(2, 10, 4), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        pq_adc(tables, codes, backend="pallas")
    assert (pq_adc.launches, pq_adc_rowwise.launches) == before


def test_adc_tables_and_codec_match_reference():
    x = RNG.normal(size=(500, 32)).astype(np.float32)
    jcodec = jax_train_pq(x, m=8, k=32, iters=4)
    codec = PQCodec(codebooks=T(np.array(jcodec.codebooks)))
    q = RNG.normal(size=(3, 32)).astype(np.float32)
    tables = adc_tables(T(q), codec.codebooks).numpy()
    want = np.array(jax_adc_tables(jnp.asarray(q),
                                     jnp.asarray(jcodec.codebooks)))
    np.testing.assert_allclose(tables, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(codec.adc_table(T(q[0])).numpy(),
                               jcodec.adc_table(q[0]), rtol=1e-5, atol=1e-5)
    codes = codec.encode(T(x), chunk=128)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), jcodec.encode(x))
    est = codec.estimate(T(want[0]), codes).numpy()
    np.testing.assert_allclose(est, jcodec.estimate(want[0], jcodec.encode(x)),
                               rtol=1e-5, atol=1e-5)


def test_train_pq_draws_like_reference():
    """Same numpy draws (sample + inits): with zero Lloyd iterations the
    codebooks are the reference's inits exactly; trained ones quantize
    about as well as the reference's."""
    x = RNG.normal(size=(700, 16)).astype(np.float32)
    for k in (16, 1024):                       # 1024 > n pads duplicates
        want = jax_train_pq(x, m=4, k=k, iters=0, sample=600, seed=3)
        got = train_pq(T(x), m=4, k=k, iters=0, sample=600, seed=3)
        np.testing.assert_array_equal(got.codebooks.numpy(), want.codebooks)
    with pytest.raises(ValueError, match="divisible"):
        train_pq(T(x), m=5)

    def err(codebooks):
        codec = PQCodec(codebooks=torch.as_tensor(np.array(codebooks)))
        rec = torch.cat([codec.codebooks[j][codec.encode(T(x))[:, j].long()]
                         for j in range(codec.m)], 1)
        return float(((rec - T(x)) ** 2).sum(1).mean())
    got = train_pq(T(x), m=4, k=16, iters=6, seed=1)
    want = jax_train_pq(x, m=4, k=16, iters=6, seed=1)
    assert err(got.codebooks) <= 1.02 * err(want.codebooks)


def test_distances_match_reference():
    x = RNG.normal(size=(300, 12)).astype(np.float32)
    q = RNG.normal(size=(17, 12)).astype(np.float32)
    np.testing.assert_allclose(td.pairwise_sq_l2(T(q), T(x)).numpy(),
                               jd.pairwise_sq_l2(q, x), rtol=1e-5, atol=1e-4)
    gd, gi = td.exact_knn(T(x), T(q), 10, chunk=5)
    wd, wi = jd.exact_knn(x, q, 10, chunk=5)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-5, atol=1e-4)
    g = td.knn_graph(T(x), 8, chunk=64)
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(g.numpy(), jd.knn_graph(x, 8, chunk=64))
    # k >= n: every other point, then -1 pads (far-tail order is rounding)
    g, w = td.knn_graph(T(x), 400).numpy(), jd.knn_graph(x, 400)
    np.testing.assert_array_equal(np.sort(g, 1), np.sort(w, 1))
    np.testing.assert_array_equal(g[:, :10], w[:, :10])
    assert td.medoid(T(x), sample=64, seed=2) == jd.medoid(x, sample=64,
                                                           seed=2)
    assert td.medoid(T(x)) == jd.medoid(x)
    assert td.recall_at_k(gi, wi, 10) == 1.0
    assert td.recall_at_k(gi.flip(1), wi, 5) == jd.recall_at_k(wi[:, ::-1],
                                                               wi, 5)


@pytest.mark.parametrize("setting", (True, False))
def test_f32_matmul_restores_the_callers_tf32_setting(setting):
    """The products run with TF32 off, and the caller's setting is back
    after every distance and PQ function, even when the block raises."""
    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    x = T(RNG.normal(size=(300, 16)).astype(np.float32))
    try:
        flag.allow_tf32 = setting
        with td.f32_matmul():
            assert flag.allow_tf32 is False
        td.pairwise_sq_l2(x[:5], x)
        td.knn_graph(x, 4)
        train_pq(x, m=4, k=8, iters=2).encode(x)
        assert flag.allow_tf32 is setting
        with pytest.raises(RuntimeError), td.f32_matmul():
            raise RuntimeError
        assert flag.allow_tf32 is setting
    finally:
        flag.allow_tf32 = before


def test_exact_knn_ties_keep_lower_index():
    """Duplicated points tie exactly; the lower id comes first, as with
    `jax.lax.top_k`."""
    x = np.repeat(RNG.normal(size=(5, 4)).astype(np.float32), 3, axis=0)
    gd, gi = td.exact_knn(T(x), T(x[:4]), 6)
    wd, wi = jd.exact_knn(x, x[:4], 6)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_synthetic_data_bitwise():
    np.testing.assert_array_equal(
        tsyn.clustered_vectors(300, 10, n_clusters=5, seed=4),
        jsyn.clustered_vectors(300, 10, n_clusters=5, seed=4))
    got = tsyn.make_vector_dataset("t", n=400, d=16, nq=9, k_gt=10,
                                   n_clusters=6, seed=2, device="cpu")
    want = jsyn.make_vector_dataset("t", n=400, d=16, nq=9, k_gt=10,
                                    n_clusters=6, seed=2)
    np.testing.assert_array_equal(got.base, want.base)
    np.testing.assert_array_equal(got.queries, want.queries)
    np.testing.assert_array_equal(got.gt, want.gt)
    assert got.gt.dtype == np.int64
    p = tsyn.paper_dataset("sift-like", n=200, nq=3, device="cpu")
    assert p.name == "sift-like" and p.base.shape == (200, 128)
    assert tsyn.PAPER_REGIMES == jsyn.PAPER_REGIMES
    np.testing.assert_array_equal(
        p.base, jsyn.paper_dataset("sift-like", n=200, nq=3).base)


def test_pick_pq_m_matches_reference():
    for d in (8, 24, 100, 128, 256, 300, 420, 960, 7):
        assert _pick_pq_m(d) == jax_pick_pq_m(d)
        assert _pick_pq_m(d, 12) == jax_pick_pq_m(d, 12)
