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
from repro_torch.kernels.l2_topk.ops import MAX_K, chunk_size, plan
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


def _emulate(q, x, k):
    """The CUDA kernel's passes (`plan`) on the CPU: (dist, id) keys as
    (bits(dist) << 32) | id in int64 (a non-negative f32's bits are below
    2^31), a missing row as the largest key; each chunk of C keys sorted,
    its first k kept, until one chunk remains."""
    b, n = q.shape[0], x.shape[0]
    missing = torch.iinfo(torch.int64).max
    d = sq_l2_ordered(q, x)
    keys = ((d.view(torch.int32).long() << 32)
            | torch.arange(n, dtype=torch.int64))
    for c, s in plan(n, k):
        pad = s * c - keys.shape[1]
        keys = torch.cat([keys, torch.full((b, pad), missing)], 1)
        keys = torch.sort(keys.reshape(b, s, c), dim=2).values[:, :, :k]
        keys = keys.reshape(b, s * k)
    ok = keys != missing
    dists = torch.where(ok, (keys >> 32).to(torch.int32).view(torch.float32),
                        torch.inf)
    return dists, torch.where(ok, keys & 0xFFFFFFFF, -1).to(torch.int32)


@pytest.mark.parametrize("b,n,d,k,integer", [
    (3, 20000, 4, 1024, True), (2, 9000, 18, 100, False),
    (1, 5000, 2, 1, True), (2, 300, 8, 300, True), (2, 300, 8, 301, False),
    (5, 70000, 3, 7, True),
])
def test_kernel_passes_select_as_the_plain_version(b, n, d, k, integer):
    """The kernel's chunked sort-and-keep passes, emulated, pick the
    plain version's (dist, id) order: ragged N, k = 1, k = N, k > N, and
    the ties of integer data."""
    if integer:
        q = torch.randint(-2, 3, (b, d), generator=_gen()).float()
        x = torch.randint(-2, 3, (n, d), generator=_gen()).float()
    else:
        q, x = torch.randn((b, d), generator=_gen()), torch.randn(
            (n, d), generator=_gen())
    got = _emulate(q, x, k)
    want = l2_topk_ref(q, x, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _gen():
    g = torch.Generator()
    g.manual_seed(int(RNG.integers(1 << 31)))
    return g


@pytest.mark.parametrize("n,k", [(1 << 20, 1024), (1 << 20, 100),
                                 (100000, 100), (3, 5), (0, 4), (5000, 1)])
def test_plan_reaches_one_chunk(n, k):
    passes = plan(n, k)
    m = n
    for c, s in passes:
        assert c & (c - 1) == 0 and c >= 2 * k and c * 8 <= 64 * 1024
        assert s == max(1, -(-m // c)) and c == chunk_size(m, k)
        m = s * k
    assert passes[-1][1] == 1 and all(s > 1 for _, s in passes[:-1])
    # retrieval_cand: the last pass sorts the 2,048 keys left, not 8,192
    assert plan(1 << 20, 1024) == [(8192, 128), (8192, 16), (8192, 2),
                                   (2048, 1)]


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
