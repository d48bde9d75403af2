"""The port's exact L2 top-k against the JAX reference (CPU).

The plain version (`repro_torch.kernels.l2_topk.l2_topk_ref`) sums each
of |q|^2, |x|^2 and q.x over i in order, as the CUDA kernel does; the
reference's matmul form sums in an order XLA chooses, and the difference
cancels in |q|^2 + |x|^2 - 2 q.x.  So on normal data dists agree within
rtol = atol = 1e-4 (the repo's own interpret-vs-ref bar is 1e-3,
tests/test_kernels.py), and ids are equal wherever the distance is apart
from its row's other distances by more than that.  On integer-valued data
every sum is exact: dists and ids are equal, ties included.  The Pallas
kernel runs in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2_topk import l2_topk as jax_l2_topk
from repro.kernels.l2_topk import l2_topk_ref as jax_l2_topk_ref
from repro_torch.kernels.l2_topk import l2_topk, l2_topk_ref
from repro_torch.kernels.l2_topk.ops import (BINS, MAX_K, QUERIES_PER_CTA,
                                            STAGES, THREADS, plan)
from repro_torch.kernels.l2_topk.ref import sq_l2_ordered

RNG = np.random.default_rng(13)
TOL = 1e-4


def _jax(q, x, k):
    """[(dists, ids)] of the reference's interpret-mode kernel, then of
    its plain version (which needs k <= N), as numpy."""
    q, x = jnp.asarray(q), jnp.asarray(x)
    out = [jax_l2_topk(q, x, k, backend="interpret")]
    if k <= x.shape[0]:
        out.append(jax_l2_topk_ref(q, x, k))
    return [(np.asarray(v, np.float32), np.asarray(i)) for v, i in out]


def _separated(q, x, vals):
    """(B, k) mask: the distance at each kept position lies more than TOL
    (relative and absolute) from every other distance of its row."""
    full = np.sort(sq_l2_ordered(torch.as_tensor(q), torch.as_tensor(x))
                   .numpy(), axis=1)
    lo = np.searchsorted
    sep = np.zeros(vals.shape, bool)
    for r in range(vals.shape[0]):
        for j, v in enumerate(vals[r]):
            tol = TOL * (1 + abs(v))
            sep[r, j] = (lo(full[r], v + tol, "right")
                         - lo(full[r], v - tol, "left")) == 1
    return sep


@pytest.mark.parametrize("b,n,d,k", [
    (1, 1000, 16, 10), (5, 512, 128, 4), (8, 2000, 24, 32), (2, 300, 960, 8),
    (3, 1000, 18, 100),
])
def test_l2_topk_matches_reference(b, n, d, k):
    q = RNG.normal(size=(b, d)).astype(np.float32)
    x = RNG.normal(size=(n, d)).astype(np.float32)
    v, i = l2_topk(torch.as_tensor(q), torch.as_tensor(x), k)   # auto: plain
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert v.shape == i.shape == (b, k)
    v, i = v.numpy(), i.numpy()
    assert (np.diff(v, axis=1) >= 0).all()
    sep = _separated(q, x, v)
    assert sep.mean() > 0.9
    for jv, ji in _jax(q, x, k):
        np.testing.assert_allclose(v, jv, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(i[sep], ji[sep])


@pytest.mark.parametrize("b,n,d,k", [
    (4, 700, 3, 50), (1, 513, 1, 64), (6, 2000, 18, 100), (2, 40, 8, 40),
])
def test_l2_topk_integer_data_is_exact(b, n, d, k):
    """Integer-valued rows: every distance is exact, so the port equals
    the reference id for id, on (dist, id) ties too."""
    q = RNG.integers(-2, 3, (b, d)).astype(np.float32)
    x = RNG.integers(-2, 3, (n, d)).astype(np.float32)
    v, i = l2_topk_ref(torch.as_tensor(q), torch.as_tensor(x), k)
    v, i = v.numpy(), i.numpy()
    assert (v[:, 1:] == v[:, :-1]).any()          # the data has ties
    for jv, ji in _jax(q, x, k):
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(i, ji)


def test_l2_topk_bf16_inputs():
    """bf16 inputs are cast to f32, as the reference casts them."""
    q = RNG.normal(size=(2, 64)).astype(np.float32)
    x = RNG.normal(size=(600, 64)).astype(np.float32)
    v, i = l2_topk(torch.as_tensor(q).bfloat16(), torch.as_tensor(x).bfloat16(),
                   5)
    qb = torch.as_tensor(q).bfloat16().float().numpy()
    xb = torch.as_tensor(x).bfloat16().float().numpy()
    sep = _separated(qb, xb, v.numpy())
    for jv, ji in _jax(jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
                       5):
        np.testing.assert_allclose(v.numpy(), jv, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(i.numpy()[sep], ji[sep])


@pytest.mark.parametrize("n,k", [(3, 5), (1, 4), (7, 7)])
def test_l2_topk_k_above_n_pads_inf_and_minus_one(n, k):
    q = RNG.integers(-3, 4, (2, 8)).astype(np.float32)
    x = RNG.integers(-3, 4, (n, 8)).astype(np.float32)
    v, i = l2_topk(torch.as_tensor(q), torch.as_tensor(x), k)
    assert np.isinf(v.numpy()[:, n:]).all() and (i.numpy()[:, n:] == -1).all()
    for jv, ji in _jax(q, x, k):
        np.testing.assert_array_equal(v.numpy(), jv)
        np.testing.assert_array_equal(i.numpy(), ji)


def _emulate(q, x, k, gen):
    """The CUDA kernel's four launches on the CPU, keys as int64
    (bits(dist) << 32) | id (a non-negative f32's bits are below 2^31):
    1. a histogram of each query's first digit, bits 30..20 of bits(dist);
    2. the bin t that holds the k-th key, nb keys below it, nt in it;
    3. the keys below t and those in t, emitted in a shuffled order (the
       kernel's atomics give any order);
    4. an 8-bit radix select of the k - nb smallest keys of bin t, over
       the 20 low bits of bits(dist) and then the bits the ids use,
       stopping when a digit's bucket is taken whole; the <= k keys
       selected are sorted and decoded, +inf / -1 past N."""
    b, n = q.shape[0], x.shape[0]
    bits = sq_l2_ordered(q, x).view(torch.int32).long()
    keys = (bits << 32) | torch.arange(n, dtype=torch.int64)
    bins = bits >> 20
    idb = max(1, (n - 1).bit_length())
    dists = torch.full((b, k), torch.inf)
    ids = torch.full((b, k), -1, dtype=torch.int32)
    for row in range(b):
        hist = torch.bincount(bins[row], minlength=BINS)
        cum = hist.cumsum(0)
        if n <= k:
            t, nb, nt = BINS, n, 0
        else:
            t = int(torch.searchsorted(cum, k))     # first bin with cum >= k
            nb, nt = int(cum[t] - hist[t]), int(hist[t])
        perm = torch.randperm(n, generator=gen)
        kr, br = keys[row, perm], bins[row, perm]
        below, cand = kr[br < t], kr[br == t]
        assert below.numel() == nb and cand.numel() == nt
        r = min(k - nb, nt)
        red = (((cand >> 32) & 0xFFFFF) << idb) | (cand & ((1 << idb) - 1))
        prefix, s, rem = 0, 20 + idb, r
        if 0 < r < nt:
            while s > 0:
                w = min(8, s)
                s -= w
                m = (red >> (s + w)) == prefix
                h = torch.bincount((red[m] >> s) & ((1 << w) - 1),
                                   minlength=256)
                c = h.cumsum(0)
                dg = int(torch.searchsorted(c, rem))
                rem, cnt = rem - int(c[dg] - h[dg]), int(h[dg])
                prefix = (prefix << w) | dg
                if cnt == rem:
                    break
        taken = cand[(red >> s) <= prefix] if r > 0 else cand[:0]
        assert taken.numel() == r
        sel = torch.sort(torch.cat([below, taken])).values
        dists[row, :sel.numel()] = (sel >> 32).to(torch.int32).view(
            torch.float32)
        ids[row, :sel.numel()] = (sel & 0xFFFFFFFF).to(torch.int32)
    return dists, ids


@pytest.mark.parametrize("b,n,d,k,kind", [
    (3, 20000, 4, 1024, "integer"), (2, 9000, 18, 100, "normal"),
    (1, 5000, 2, 1, "integer"), (2, 300, 8, 300, "integer"),
    (2, 300, 8, 301, "normal"), (5, 70000, 3, 7, "integer"),
    (2, 3000, 6, 700, "identical"), (3, 5000, 1, 1500, "integer"),
])
def test_kernel_passes_select_as_the_plain_version(b, n, d, k, kind):
    """The kernel's histogram, threshold, emit and radix-select passes,
    emulated, pick the plain version's (dist, id) order bitwise: ragged N,
    k = 1, k = N, k > N, the ties of integer data, a base of identical
    rows (every key ties on distance: the order is by id, and the select
    runs down to the id bits) and D = 1 integer data with the k-th key
    inside a run of ties."""
    if kind == "normal":
        q, x = torch.randn((b, d), generator=_gen()), torch.randn(
            (n, d), generator=_gen())
    else:
        q = torch.randint(-2, 3, (b, d), generator=_gen()).float()
        x = torch.randint(-2, 3, (n, d), generator=_gen()).float()
    if kind == "identical":
        x = x[:1].expand(n, d).contiguous()
    want = l2_topk_ref(q, x, k)
    if kind == "integer" and d == 1:
        full = torch.sort(sq_l2_ordered(q, x), dim=1).values
        assert (full[:, k - 1] == full[:, k]).all()     # k inside a tie run
    got = _emulate(q, x, k, _gen())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _gen():
    g = torch.Generator()
    g.manual_seed(int(RNG.integers(1 << 31)))
    return g


@pytest.mark.parametrize("b,n,d,k", [
    (1, 1 << 20, 18, 1024), (64, 1 << 20, 18, 1024), (8, 100000, 128, 100),
    (2, 3, 8, 5), (0, 4, 8, 4), (1, 5000, 2, 1), (3, 3000, 960, 8),
    (5, 0, 4, 4)])
def test_plan_covers_the_base_in_four_launches(b, n, d, k):
    """Every base row in exactly one stripe, stripes whole tiles, tiles in
    the staging budget, the card filled where N allows; four launches a
    call whatever the shapes, none at B = 0."""
    p = plan(b, n, d, k)
    assert p.launches == (len(STAGES) if b else 0) == (4 if b else 0)
    assert p.stride >= d and p.stride % 2 == 1
    assert 1 <= p.tile <= THREADS
    assert p.tile == 1 or p.tile * p.stride * 4 <= 64 * 1024
    assert p.stripe % p.tile == 0 and p.stripe <= 65535   # 16-bit counts
    assert 1 <= p.emit_blocks <= max(1, -(-n // (4 * THREADS)))
    assert p.stripes * p.stripe >= n and (n == 0 or (p.stripes - 1)
                                          * p.stripe < n)
    if n >= 132 * 8 * p.tile:
        assert -(-b // QUERIES_PER_CTA) * p.stripes >= 132
    # retrieval_cand: four launches at B = 1 and at B = 64, and at B = 1 the
    # one query's base is split over more than 132 CTAs
    assert plan(1, 1 << 20, 18, 1024).launches == 4
    assert plan(64, 1 << 20, 18, 1024).launches == 4
    assert plan(1, 1 << 20, 18, 1024).stripes >= 132


def test_l2_topk_backends_on_cpu():
    q, x = torch.randn(2, 8), torch.randn(50, 8)
    before = l2_topk.launches
    v, i = l2_topk(q, x, MAX_K + 1)            # the plain version: any k
    assert v.shape == (2, MAX_K + 1) and (i[:, 50:] == -1).all()
    for got, want in zip(l2_topk(q, x, 9, backend="ref"), l2_topk_ref(q, x, 9)):
        assert torch.equal(got, want)
    assert l2_topk.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        l2_topk(q, x, 4, backend="cuda")
    with pytest.raises(ValueError, match="backend must be one of"):
        l2_topk(q, x, 4, backend="interpret")
