"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc; elsewhere each one skips.
The file imports neither jax nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The plain versions keep the kernels' summation order (ascending m for
ADC, ascending i with no fused multiply-add for exact L2), so kernel and
plain version are compared bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.build.frontier import frontier_pools
from repro_torch.build.pool import pool_merge
from repro_torch.core.distances import knn_graph
from repro_torch.core.pq import train_pq
from repro_torch.kernels.beam_fused import beam_hops, beam_hops_ref
from repro_torch.kernels.beam_fused.ref import l2_score, sq_norms
from repro_torch.kernels.pq_adc import (pq_adc, pq_adc_ref, pq_adc_rowwise,
                                        pq_adc_rowwise_ref)
from repro_torch.serve import BatchedANNEngine, EngineConfig

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tables(b, m, k, integer, dev):
    t = RNG.integers(0, 4, (b, m, k)) if integer else RNG.random((b, m, k))
    return torch.as_tensor(t, dtype=torch.float32, device=dev)


def _codes(shape, k, dev):
    return torch.as_tensor(RNG.integers(0, k, shape), dtype=torch.uint8,
                           device=dev)


@pytest.mark.parametrize("b,n,m,k,integer", [
    (64, 256, 16, 256, False), (37, 1000, 8, 64, True),
    (5, 333, 64, 256, False), (1, 70000, 16, 256, False)])
def test_pq_adc_kernel_matches_plain(dev, b, n, m, k, integer):
    t, c = _tables(b, m, k, integer, dev), _codes((n, m), k, dev)
    before = pq_adc.launches
    torch.testing.assert_close(pq_adc(t, c), pq_adc_ref(t, c), rtol=0, atol=0)
    assert pq_adc.launches == before + 1


@pytest.mark.parametrize("b,r,m,k,integer", [
    (64, 32, 16, 256, False), (37, 5, 32, 256, True), (3, 257, 64, 256, False)])
def test_pq_adc_rowwise_kernel_matches_plain(dev, b, r, m, k, integer):
    t, c = _tables(b, m, k, integer, dev), _codes((b, r, m), k, dev)
    before = pq_adc_rowwise.launches
    torch.testing.assert_close(pq_adc_rowwise(t, c), pq_adc_rowwise_ref(t, c),
                               rtol=0, atol=0)
    assert pq_adc_rowwise.launches == before + 1


def _pool(tables, codes, n, l, dev):
    cands = torch.arange(0, n, max(1, n // 64), device=dev)
    ed = pq_adc_ref(tables, codes[cands])
    sd, si = torch.sort(ed, dim=1, stable=True)
    b = tables.shape[0]
    ids, d, exp = pool_merge(
        torch.full((b, l), -1, dtype=torch.int32, device=dev),
        torch.full((b, l), torch.inf, device=dev),
        torch.zeros((b, l), dtype=torch.bool, device=dev),
        cands[si[:, :4]].to(torch.int32), sd[:, :4], l)
    ids[::5], d[::5] = -1, torch.inf           # rows with no seed at all
    return ids, d, exp


@pytest.mark.parametrize("b,n,r,m,k,l,hops,integer", [
    (64, 100000, 32, 16, 256, 64, 32, False),
    (37, 5000, 24, 8, 64, 48, 40, True),
    (19, 300, 16, 8, 16, 300, 400, True),
    (8, 20000, 256, 64, 256, 1024, 8, False)])
def test_beam_hops_kernel_matches_plain(dev, b, n, r, m, k, l, hops, integer):
    adj = torch.as_tensor(RNG.integers(0, n, (n, r)), dtype=torch.int32,
                          device=dev)
    adj[torch.as_tensor(RNG.random((n, r)) < 0.2, device=dev)] = -1
    adj[torch.as_tensor(RNG.random(n) < 0.05, device=dev)] = -1
    codes = _codes((n, m), k, dev)
    t = _tables(b, m, k, integer, dev)
    pool = _pool(t, codes, n, l, dev)
    before = beam_hops.launches
    got = beam_hops(adj, *pool, hops, tables=t, codes=codes)
    want = beam_hops_ref(adj, *pool, hops, tables=t, codes=codes)
    assert beam_hops.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _l2_case(b, n, r, d, l, integer, dev):
    """Random padded graph with dead ends, a corpus and queries (integer
    values force (dist, id) ties), and a pool seeded by exact L2 from
    strided candidates, every fifth row with no seed at all."""
    adj = torch.as_tensor(RNG.integers(0, n, (n, r)), dtype=torch.int32,
                          device=dev)
    adj[torch.as_tensor(RNG.random((n, r)) < 0.2, device=dev)] = -1
    adj[torch.as_tensor(RNG.random(n) < 0.05, device=dev)] = -1
    draw = ((lambda shape: RNG.integers(-3, 4, shape)) if integer
            else (lambda shape: RNG.normal(size=shape)))
    x = torch.as_tensor(draw((n, d)), dtype=torch.float32, device=dev)
    q = torch.as_tensor(draw((b, d)), dtype=torch.float32, device=dev)
    n2 = sq_norms(x)
    cands = torch.arange(0, n, max(1, n // 64), device=dev, dtype=torch.int32)
    seeds = cands[None, :].expand(b, -1)
    sd = l2_score(x, n2, q, sq_norms(q), seeds)
    ids, dd, exp = pool_merge(
        torch.full((b, l), -1, dtype=torch.int32, device=dev),
        torch.full((b, l), torch.inf, device=dev),
        torch.zeros((b, l), dtype=torch.bool, device=dev), seeds, sd, l)
    ids[::5], dd[::5] = -1, torch.inf
    return adj, x, n2, q, (ids, dd, exp)


@pytest.mark.parametrize("b,n,r,d,l,hops,integer", [
    (256, 100000, 32, 128, 96, 66, False),
    (37, 5001, 23, 8, 48, 40, True),
    (19, 301, 15, 8, 301, 400, True),
    (7, 3000, 32, 960, 96, 30, False),
    (8, 20000, 256, 16, 1024, 8, False)])
def test_beam_hops_l2_kernel_matches_plain(dev, b, n, r, d, l, hops, integer):
    adj, x, n2, q, pool = _l2_case(b, n, r, d, l, integer, dev)
    before = (beam_hops.launches, beam_hops.l2_launches)
    got = beam_hops(adj, *pool, hops, x=x, n2=n2, queries=q)
    want = beam_hops_ref(adj, *pool, hops, x=x, n2=n2, queries=q)
    assert (beam_hops.launches, beam_hops.l2_launches) == (before[0],
                                                           before[1] + 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_frontier_fused_kernel_matches_plain(dev):
    """The construction frontier through the L2 kernel gives the plain
    version's pools, one launch per chunk of 256 nodes."""
    x = torch.as_tensor(RNG.normal(size=(3000, 32)), dtype=torch.float32,
                        device=dev)
    knn = knn_graph(x, 16).cpu().numpy()
    xn = x.cpu().numpy()
    nodes = np.arange(3000)
    before = beam_hops.l2_launches
    got = frontier_pools(xn, knn, [0], nodes, ef=32, backend="fused",
                         device=dev)
    assert beam_hops.l2_launches == before + 12
    want = frontier_pools(xn, knn, [0], nodes, ef=32, backend="fused_ref",
                          device=dev)
    assert beam_hops.l2_launches == before + 12
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_kernel_limits_and_checks_raise(dev):
    t = _tables(2, 4, 16, False, dev)
    c = _codes((10, 4), 16, dev)
    with pytest.raises(ValueError, match="uint8"):
        pq_adc(t, c.int())
    with pytest.raises(ValueError, match="shared memory"):
        pq_adc(_tables(1, 256, 256, False, dev), _codes((3, 256), 256, dev))
    adj = torch.zeros((10, 300), dtype=torch.int32, device=dev)
    ids = torch.full((2, 8), -1, dtype=torch.int32, device=dev)
    d = torch.full((2, 8), torch.inf, device=dev)
    exp = torch.zeros((2, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="R <= 256"):
        beam_hops(adj, ids, d, exp, 2, tables=t, codes=c)
    with pytest.raises(ValueError, match="contiguous"):
        beam_hops(adj[:, :8].clone().T.contiguous().T, ids, d, exp, 2,
                  tables=t, codes=c)
    x = torch.zeros((10, 8), device=dev)
    with pytest.raises(ValueError, match="queries"):
        beam_hops(adj[:, :8].contiguous(), ids, d, exp, 2, x=x,
                  n2=sq_norms(x), queries=torch.zeros((2, 7), device=dev))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((10, 60000), device=dev)
        beam_hops(adj[:, :8].contiguous(), ids, d, exp, 2, x=big,
                  n2=sq_norms(big), queries=torch.zeros((2, 60000), device=dev))


def test_engine_backends_agree_on_card(dev):
    x = torch.as_tensor(RNG.normal(size=(6000, 32)), dtype=torch.float32,
                        device=dev)
    q = RNG.normal(size=(50, 32)).astype(np.float32)
    codec = train_pq(x, m=8, k=256, iters=4)
    arrays = dict(x=x, adj=knn_graph(x, 16), codes=codec.encode(x),
                  codebooks=codec.codebooks,
                  entry_cands=np.linspace(0, 5999, 256, dtype=np.int64))
    out = {}
    for backend in ("fused", "cuda", "ref", "fused_ref", "auto"):
        eng = BatchedANNEngine(arrays, EngineConfig(l=48, max_hops=24,
                                                    backend=backend),
                               device=dev)
        counts = (pq_adc.launches, pq_adc_rowwise.launches, beam_hops.launches)
        out[backend] = eng.search_batch(q, 10)
        grew = [a - b for a, b in zip((pq_adc.launches,
                                       pq_adc_rowwise.launches,
                                       beam_hops.launches), counts)]
        expect = {"fused": [1, 0, 1], "auto": [1, 0, 1], "cuda": [1, 24, 0],
                  "ref": [0, 0, 0], "fused_ref": [0, 0, 0]}[backend]
        assert grew == expect, backend
    for backend, (ids, dists) in out.items():
        np.testing.assert_array_equal(ids, out["ref"][0], err_msg=backend)
        np.testing.assert_allclose(dists, out["ref"][1], rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
