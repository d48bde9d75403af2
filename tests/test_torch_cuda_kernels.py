"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc; elsewhere each one skips.
The file imports neither jax nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The plain versions keep the kernels' summation order (ascending m for
ADC, ascending i with no fused multiply-add for exact L2 and the L2
top-k), so kernel and plain version are compared bitwise.  Flash-decode
is the exception: its online softmax over splits of the positions sums
in another order than the plain version's single softmax, so the two are
held within atol 1e-5 on f32 outputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.build.frontier import frontier_pools
from repro_torch.build.pool import pool_merge
from repro_torch.core.distances import knn_graph
from repro_torch.core.pq import train_pq
from repro_torch.configs import olmo_1b
from repro_torch.kernels.beam_fused import beam_hops, beam_hops_ref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.beam_fused.ref import l2_score, sq_norms
from repro_torch.kernels.l2_topk import l2_topk, l2_topk_ref
from repro_torch.kernels.l2_topk.ops import plan
from repro_torch.models.recsys.din import init_params
from repro_torch.models.transformer import (decode_step, init_cache,
                                            init_lm_params, serve_prefill)
from repro_torch.kernels.pq_adc import (pq_adc, pq_adc_ref, pq_adc_rowwise,
                                        pq_adc_rowwise_ref)
from repro_torch.kernels.pq_adc.ops import plan as adc_plan
from repro_torch.configs import din_cfg
from repro_torch.data.synthetic import din_batch
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


def _codes(shape, k, dev, offset=0):
    """uint8 codes; offset > 0 starts the tensor that many bytes into its
    storage (rows no wider load can take)."""
    flat = RNG.integers(0, k, int(np.prod(shape)) + offset)
    t = torch.as_tensor(flat, dtype=torch.uint8, device=dev)
    return t[offset:].view(shape)


# both forms on either side of `plan`'s cut (B = 3, K = 256: a staged
# block scores n / 88 rows, staged from 512 = 2 * K), M = 8, 12 (never
# 16-byte rows), 48 and 4 (runtime M), 64 (a 64 KB table), codes one byte
# into their storage, B = N = 1 and K = 16
@pytest.mark.parametrize("b,n,m,k,integer,offset,form", [
    (64, 256, 16, 256, False, 0, "gather"),
    (37, 1000, 8, 64, True, 0, "staged"),
    (5, 333, 64, 256, False, 0, "gather"),
    (1, 70000, 16, 256, False, 0, "gather"),
    (3, 70000, 16, 256, False, 0, "staged"),
    (3, 45056, 16, 256, True, 0, "staged"),
    (3, 44968, 16, 256, True, 0, "gather"),
    (9, 500, 12, 256, False, 0, "gather"),
    (3, 70000, 12, 256, False, 0, "staged"),
    (2, 70000, 64, 256, False, 0, "staged"),
    (4, 2000, 48, 256, False, 0, "gather"),
    (9, 1024, 4, 64, False, 0, "staged"),
    (64, 256, 16, 256, False, 1, "gather"),
    (3, 70000, 16, 256, False, 1, "staged"),
    (7, 999, 12, 64, True, 1, "staged"),
    (1, 1, 16, 256, False, 0, "gather"),
    (1, 1, 12, 256, False, 1, "gather"),
    (64, 256, 16, 16, True, 0, "staged"),
    (3, 3000, 16, 16, False, 0, "staged"),
    (300, 31, 16, 16, True, 0, "gather"),
    (64, 100, 4, 64, False, 0, "gather"),
    (9, 500, 12, 256, True, 1, "gather")])
def test_pq_adc_kernel_matches_plain(dev, b, n, m, k, integer, offset, form):
    t, c = _tables(b, m, k, integer, dev), _codes((n, m), k, dev, offset)
    assert adc_plan(b, n, m, k, c.data_ptr()).form == form
    before = pq_adc.launches
    torch.testing.assert_close(pq_adc(t, c), pq_adc_ref(t, c), rtol=0, atol=0)
    assert pq_adc.launches == before + 1


@pytest.mark.parametrize("b,r,m,k,integer,offset,form", [
    (64, 32, 16, 256, False, 0, "gather"),
    (37, 5, 32, 256, True, 0, "gather"),
    (3, 257, 64, 256, False, 0, "gather"),
    (64, 32, 8, 256, False, 0, "gather"),
    (64, 32, 16, 256, False, 1, "gather"),
    (13, 33, 12, 256, True, 1, "gather"),
    (1, 1, 16, 256, False, 0, "gather"),
    (64, 32, 16, 16, True, 0, "staged"),
    (64, 20, 16, 16, True, 0, "gather"),
    (2, 70000, 16, 256, False, 0, "staged"),
    (3, 3000, 16, 16, False, 1, "staged")])
def test_pq_adc_rowwise_kernel_matches_plain(dev, b, r, m, k, integer, offset,
                                             form):
    t, c = _tables(b, m, k, integer, dev), _codes((b, r, m), k, dev, offset)
    assert adc_plan(b, r, m, k, c.data_ptr()).form == form
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


def _edge_case(adj, pool, case, scale, dev):
    """Rework a random graph and pool into one of the inputs the kernels'
    de-duplication and merge lean on: "repeat_ids" (each adjacency row
    holds its ids twice, across warps where R > 32, one three times),
    "self_loops" (every node its own neighbour), "nbrs_in_pool" (each pool
    also holds neighbours of its best seed under random dists in
    [0, scale) that are not their scores)."""
    n, r = adj.shape
    if case == "repeat_ids":
        h = r // 2
        adj[:, h:2 * h] = adj[:, :h]
        adj[:, -1] = adj[:, 0]
    elif case == "self_loops":
        ids = torch.arange(n, device=dev)
        adj[ids, ids % r] = ids.to(torch.int32)
    elif case == "nbrs_in_pool":
        ids, d, exp = pool
        nb = torch.where(ids[:, :1] >= 0, adj[ids[:, 0].clamp_min(0).long()],
                         -1)
        nd = torch.as_tensor(RNG.random(nb.shape) * scale,
                             dtype=torch.float32, device=dev)
        pool = pool_merge(ids, d, exp, nb, nd, ids.shape[1])
    return adj, pool


@pytest.mark.parametrize("b,n,r,m,k,l,hops,integer,case", [
    (64, 100000, 32, 16, 256, 64, 32, False, "plain"),
    (37, 5000, 24, 8, 64, 48, 40, True, "plain"),
    (19, 300, 16, 8, 16, 300, 400, True, "plain"),
    (8, 20000, 256, 64, 256, 1024, 8, False, "plain"),
    (64, 100000, 32, 16, 256, 64, 32, True, "repeat_ids"),
    (37, 5000, 64, 16, 256, 64, 40, True, "repeat_ids"),
    (33, 3000, 32, 16, 256, 64, 32, False, "nbrs_in_pool"),
    (19, 2000, 24, 8, 64, 48, 40, True, "self_loops"),
    (21, 4000, 32, 16, 256, 129, 60, True, "repeat_ids"),   # L % 32 != 0
    (16, 3000, 40, 8, 64, 8, 30, True, "nbrs_in_pool"),     # L < R
    (8, 20000, 256, 64, 256, 1024, 8, True, "repeat_ids"),
    (13, 3000, 32, 6, 64, 40, 30, True, "plain"),          # byte code loads
    (13, 3000, 32, 16, 256, 64, 30, False, "codes_offset")])
def test_beam_hops_kernel_matches_plain(dev, b, n, r, m, k, l, hops, integer,
                                        case):
    adj = torch.as_tensor(RNG.integers(0, n, (n, r)), dtype=torch.int32,
                          device=dev)
    adj[torch.as_tensor(RNG.random((n, r)) < 0.2, device=dev)] = -1
    adj[torch.as_tensor(RNG.random(n) < 0.05, device=dev)] = -1
    codes = _codes((n, m), k, dev)
    if case == "codes_offset":   # codes 1 byte into their storage
        buf = torch.empty(n * m + 1, dtype=torch.uint8, device=dev)
        buf[1:] = codes.reshape(-1)
        codes = buf[1:].view(n, m)
    t = _tables(b, m, k, integer, dev)
    pool = _pool(t, codes, n, l, dev)
    adj, pool = _edge_case(adj, pool, case, m, dev)
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


@pytest.mark.parametrize("b,n,r,d,l,hops,integer,case", [
    (256, 100000, 32, 128, 96, 66, False, "plain"),
    (37, 5001, 23, 8, 48, 40, True, "plain"),
    (19, 301, 15, 8, 301, 400, True, "plain"),
    (7, 3000, 32, 960, 96, 30, False, "plain"),
    (8, 20000, 256, 16, 1024, 8, False, "plain"),
    (64, 20000, 32, 128, 96, 40, True, "repeat_ids"),
    (37, 5000, 64, 16, 64, 40, True, "repeat_ids"),
    (33, 3000, 32, 32, 64, 32, False, "nbrs_in_pool"),
    (19, 2000, 24, 8, 48, 40, True, "self_loops"),
    (21, 4000, 32, 16, 129, 60, True, "repeat_ids"),      # L % 32 != 0
    (16, 3000, 40, 8, 8, 30, True, "nbrs_in_pool"),       # L < R
    (13, 3000, 32, 7, 40, 30, True, "plain"),             # 4-byte rows
    (13, 3000, 32, 128, 96, 30, False, "x_offset"),
    (8, 20000, 256, 16, 1024, 8, True, "repeat_ids")])
def test_beam_hops_l2_kernel_matches_plain(dev, b, n, r, d, l, hops, integer,
                                           case):
    adj, x, n2, q, pool = _l2_case(b, n, r, d, l, integer, dev)
    adj, pool = _edge_case(adj, pool, case, 8 * d, dev)
    if case == "x_offset":   # x 1 float into its storage: misaligned rows
        buf = torch.empty(n * d + 1, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(n, d)
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


@pytest.mark.parametrize("b,n,d,k,kind", [
    (1, 1 << 20, 18, 1024, "normal"), (8, 100000, 128, 100, "normal"),
    (37, 20001, 18, 100, "integer"), (3, 5000, 1, 64, "integer"),
    (2, 3000, 960, 8, "normal"), (5, 777, 4, 1, "normal"),
    (4, 300, 8, 300, "integer"), (4, 300, 8, 1000, "normal"),
    (3, 9000, 64, 16, "bf16"), (2, 1 << 16, 18, 1024, "identical"),
    (3, 255, 18, 100, "normal"), (3, 256, 18, 100, "normal"),
    (3, 257, 18, 100, "normal"), (2, 540671, 18, 64, "normal"),
    (2, 540672, 18, 64, "normal"), (2, 540673, 18, 64, "normal"),
    (64, 1 << 20, 18, 1024, "normal"), (5, 20001, 18, 100, "unaligned")])
def test_l2_topk_kernel_matches_plain(dev, b, n, d, k, kind):
    """Bitwise: ragged N, odd B, k = 1, k = N, k > N (+inf / -1), ties of
    integer data, D = 1 and 960, bf16 inputs, a base of identical rows
    (all keys tie on distance), N one below, at and one above a tile (256
    rows at D = 18) and a stripe (512 rows at N = 540,672, B = 2), B = 64
    at the retrieval shape, and a base that starts 72 bytes into its
    storage (no 16-byte loads); plan(...).launches launches a call."""
    if kind == "integer":
        x = torch.randint(-2, 3, (n + b + 1, d), device=dev).float()
    else:
        x = torch.randn((n + b + 1, d), device=dev)
    if kind == "bf16":
        x = x.bfloat16()
    if kind == "identical":
        x[:n] = x[0]
    base, q = x[:n].contiguous(), x[n + 1:].contiguous()
    if kind == "unaligned":
        base = x[1:n + 1]
        assert base.is_contiguous() and base.data_ptr() % 16 != 0
    before = l2_topk.launches
    got = l2_topk(q, base, k)
    assert l2_topk.launches == before + plan(b, n, d, k).launches == before + 4
    want = l2_topk_ref(q, base, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if k > n:
        assert (got[1][:, n:] == -1).all() and torch.isinf(got[0][:, n:]).all()
    if kind == "identical":
        assert (got[1] == torch.arange(k, device=dev, dtype=torch.int32)).all()


def test_din_retrieval_kernel_matches_plain(dev):
    """DIN's cascade under "auto" (the kernel) and "ref" (the plain
    version) gives the same shortlist and the same final items."""
    cfg = din_cfg.model_config(reduced=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_params(cfg, gen, device=dev)
    batch = dict(zip(("hist_items", "hist_cates", "hist_len", "target_item",
                      "target_cate"),
                     din_batch(0, 9, cfg.seq_len, cfg.n_items, cfg.n_cates)))
    before = l2_topk.launches
    short = model.shortlist(batch, cfg.n_items)
    assert l2_topk.launches > before
    assert torch.equal(short, model.shortlist(batch, cfg.n_items, "ref"))
    got = model.retrieval_step(batch, cfg.n_items, k=10)
    want = model.retrieval_step(batch, cfg.n_items, k=10, backend="ref")
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)


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
    with pytest.raises(ValueError, match="k <= 1024"):
        l2_topk(x[:2], x, 1025)
    with pytest.raises(ValueError, match="base"):
        l2_topk(x[:2], x[:, :7].contiguous(), 4)
    with pytest.raises(ValueError, match="shared memory"):
        l2_topk(big[:1], big, 4)


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


@pytest.mark.parametrize("b,h,hkv,dh,s,dtype,lens", [
    (2, 8, 4, 64, 300, "f32", "random"), (1, 4, 1, 32, 512, "f32", "random"),
    (3, 16, 16, 64, 200, "f32", "random"), (2, 8, 2, 128, 1000, "f32", "full"),
    (2, 8, 2, 120, 333, "bf16", "random"), (3, 4, 4, 16, 77, "bf16", "one"),
    (2, 8, 1, 256, 513, "bf16", "full"), (3, 8, 2, 64, 300, "bf16", "zero"),
    (3, 8, 2, 64, 300, "f32", "past_s"), (2, 64, 2, 64, 100, "f32", "random"),
    (4, 32, 8, 128, 8192, "bf16", "full"),
    # G = 1, 4 and 8 at Dh = 128 in bf16
    (3, 4, 4, 128, 2000, "bf16", "random"),
    (3, 16, 4, 128, 2000, "bf16", "random"),
    (3, 32, 4, 128, 2000, "bf16", "random"),
    # decode_32k layers of gemma-7b and h2o-danube-3-4b (its ring)
    (2, 16, 16, 256, 32768, "bf16", "full"),
    (128, 32, 8, 120, 4096, "bf16", "random")])
def test_flash_decode_kernel_matches_plain(dev, b, h, hkv, dh, s, dtype,
                                           lens):
    """Within atol 1e-5: G = 1 to 32, Dh = 16 to 256, ragged S, f32 and
    bf16 caches and queries, cache_len random, 1, S, 0 (zeros) and > S
    (clamped); two launches per call."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(b * s + dh)
    q = torch.randn((b, h, dh), device=dev, generator=gen).to(dt)
    k = torch.randn((b, s, hkv, dh), device=dev, generator=gen).to(dt)
    v = torch.randn((b, s, hkv, dh), device=dev, generator=gen).to(dt)
    n = {"random": torch.randint(1, s + 1, (b,), device=dev, generator=gen),
         "full": torch.full((b,), s, device=dev),
         "one": torch.ones(b, device=dev), "zero": torch.zeros(b, device=dev),
         "past_s": torch.full((b,), s + 9, device=dev)}[lens].int()
    before = flash_decode.launches
    got = flash_decode(q, k, v, n)
    assert flash_decode.launches == before + 2
    want = flash_decode_ref(q, k, v, n)
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if lens == "zero":
        assert (got == 0).all()


def _fd_close(q, k, v, n):
    before = flash_decode.launches
    got = flash_decode(q, k, v, n)
    assert flash_decode.launches == before + 2
    torch.testing.assert_close(got, flash_decode_ref(q, k, v, n), rtol=0,
                               atol=1e-5)
    return got


def _fd_bf16(b, h, hkv, s, seed):
    """bf16 q, k, v at Dh = 128 on the card."""
    dh = 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, dh), device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn((b, s, hkv, dh), device="cuda",
                        generator=gen).bfloat16() for _ in range(2))
    return q, k, v


# Dh = 128 in bf16: a warp's ring stage is 8 positions, a CTA's tile
# (one stage per warp) 32; the rings of all 4 warps are full at 96
@pytest.mark.parametrize("s,lens", [
    (7, "S"), (8, "S"), (9, "S"),                 # around one stage
    (95, "S"), (96, "S"), (97, "S"),              # around every ring full
    (None, "S"),                    # the last split shorter than a stage
    (1024, "split+3"),              # cache_len 3 positions into a split
    (1000, "mid"), (1000, "edge")])  # ending mid-stage, on a stage edge
def test_flash_decode_ring_edges(dev, s, lens):
    """The ring's edges within atol 1e-5 of the plain version (B = 2,
    Hkv = 2, G = 1)."""
    from repro_torch.kernels.flash_decode.ops import split_plan, stage_rows
    rows = stage_rows(128, 2)
    if s is None:                   # the first S from 800 with a short tail
        s = next(t for t in range(800, 2000)
                 if 0 < t - (split_plan(2, 2, 1, t, 128, 2)[0] - 1)
                 * split_plan(2, 2, 1, t, 128, 2)[1] < rows)
    q, k, v = _fd_bf16(2, 2, 2, s, seed=s)
    n_split, chunk = split_plan(2, 2, 1, s, 128, 2)
    n = {"S": [s, s], "split+3": [chunk + 3, 2 * chunk + 1],
         "mid": [5 * rows + 4, 17 * rows + 3],
         "edge": [5 * rows, 17 * rows]}[lens]
    _fd_close(q, k, v, torch.tensor(n, dtype=torch.int32, device=dev))


def test_flash_decode_misaligned_base_takes_element_path(dev):
    """K and V contiguous but viewed one element into their storage (not
    16-byte aligned): the element-load path, within atol 1e-5."""
    b, h, hkv, s, dh = 2, 8, 2, 300, 128
    q, k, v = _fd_bf16(b, h, hkv, s, seed=3)
    kk, vv = (torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
              for t in (k, v))
    kk[1:], vv[1:] = k.flatten(), v.flatten()
    k1, v1 = kk[1:].view(k.shape), vv[1:].view(v.shape)
    assert k1.is_contiguous() and k1.data_ptr() % 16 != 0
    n = torch.tensor([300, 171], dtype=torch.int32, device=dev)
    got = _fd_close(q, k1, v1, n)
    torch.testing.assert_close(got, flash_decode(q, k, v, n), rtol=0,
                               atol=1e-5)


def test_flash_decode_limits_raise(dev):
    q = torch.zeros((2, 4, 300), device=dev)
    kv = torch.zeros((2, 8, 2, 300), device=dev)
    n = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="Dh <= 256"):
        flash_decode(q, kv, kv, n)
    with pytest.raises(ValueError, match="multiple of"):
        flash_decode(q[:, :3, :64].contiguous(), kv[..., :64].contiguous(),
                     kv[..., :64].contiguous(), n)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q[..., :64].contiguous(), kv[..., :64], kv[..., :64], n)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_decode(q[..., :64].contiguous().half(), kv[..., :64].contiguous(),
                     kv[..., :64].contiguous(), n)


def test_lm_decode_kernel_matches_plain(dev):
    """OLMo's reduced config in f32 on the card: a prefill, then 4 greedy
    decode steps under "auto" (the kernel, 2 launches per layer) and
    "ref" (the plain version) give logits within 1e-5 and equal tokens."""
    cfg = olmo_1b.model_config(reduced=True)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    prompt = torch.randint(0, cfg.vocab, (3, 24), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    logits0, (ck, cv), lens = serve_prefill(params, cfg, prompt)
    out, toks = {}, []              # "ref" is fed "auto"'s greedy tokens
    for backend in ("auto", "ref"):
        ck0, cv0, _ = init_cache(cfg, 3, 32, device=dev)
        ck0[:, :, :24], cv0[:, :, :24] = ck, cv
        caches, logits, steps = (ck0, cv0, lens), logits0, []
        before = flash_decode.launches
        for i in range(4):
            if backend == "auto":
                toks.append(logits.argmax(-1)[:, None].int())
            logits, caches = decode_step(params, cfg, toks[i],
                                         torch.full((3,), 24 + i, device=dev),
                                         caches, backend=backend)
            steps.append(logits)
        grew = flash_decode.launches - before
        assert grew == (4 * cfg.n_layers * 2 if backend == "auto" else 0)
        out[backend] = torch.stack(steps)
    torch.testing.assert_close(out["auto"], out["ref"], rtol=1e-5, atol=1e-5)
    assert torch.equal(out["auto"].argmax(-1), out["ref"].argmax(-1))
