"""Plain PyTorch version of the fused beam-hop loop.

One hop is the unfused serve step (`serve.ann_engine.batched_search`):
pop the best unexpanded pool entry of each row, gather its padded
adjacency row, score the neighbours, merge them into the sorted (B, L)
pool with `pool_merge_ranked`, count the hop.  Scoring comes in the two
flavours the two callers need, picked by the operands given:

- ADC (serving): `tables` (B, M, K) and `codes` (N, M), summed over m in
  ascending order (`pq_adc_rowwise_ref`);
- exact L2 (the construction frontier, `build.frontier`): `x` (N, D),
  `n2` (N,) squared norms and `queries` (B, D), scored by `l2_score`.

Every hop records its frontier pick, and the loop ends with the next pick
and a done mask.  The CUDA kernels (`csrc/beam_hops_adc.cu`,
`csrc/beam_hops_l2.cu`, both on the hop loop of `csrc/beam_loop.cuh`) are
held to this function bitwise on every output.
"""
from __future__ import annotations

import torch

from ..pq_adc.ref import pq_adc_rowwise_ref


def sq_norms(v: torch.Tensor) -> torch.Tensor:
    """(n, D) -> (n,) squared norms: the corpus `n2` and the queries' |q|^2
    of exact-L2 scoring (the L2 kernel's wrapper computes |q|^2 with it)."""
    v = v.float()
    return (v * v).sum(1)


def l2_score(x, n2, queries, qn, nbrs) -> torch.Tensor:
    """Exact squared L2 of each row's query to corpus ids nbrs (B, C):
    max((n2[c] - 2 * dot) + qn, 0), +inf where the id is -1.

    The dot is summed over i = 0, 1, ... in order, one rounded multiply
    and one rounded add per term, the order of the L2 kernel, so that the
    kernel and this version agree bitwise.
    """
    c = nbrs.clamp_min(0).long()
    vt = x[c].permute(2, 0, 1)                            # (D, B, C)
    qt = queries.T                                        # (D, B)
    dot = torch.zeros(nbrs.shape, dtype=torch.float32, device=nbrs.device)
    for i in range(vt.shape[0]):
        dot = dot + vt[i] * qt[i][:, None]
    d = (n2[c] - 2.0 * dot + qn[:, None]).clamp_min(0.0)
    return torch.where(nbrs >= 0, d, torch.inf)


def beam_hops_ref(adj, pool_ids, pool_d, pool_exp, max_hops: int, *,
                  tables=None, codes=None, x=None, n2=None, queries=None):
    """Run `max_hops` beam hops over a seeded pool.

    adj (N, R) int32 with -1 pad; pool_ids/pool_d/pool_exp (B, L) the
    seeded sorted pool (ascending (dist, id), invalid = (-1, +inf,
    False)).  ADC mode takes tables (B, M, K) f32 and codes (N, M)
    uint8/int; exact-L2 mode (no codes) takes x (N, D) f32, n2 (N,) and
    queries (B, D) f32.

    Returns (pool_ids, pool_d, pool_exp, hops (B,) int32,
    trace_ids (B, max_hops) int32, trace_d (B, max_hops) f32,
    next_id (B,) int32, done (B,) bool): the final pool, per-hop frontier
    picks (-1 / +inf where a row had no frontier left), the next frontier
    pick after the last hop, and whether the beam is exhausted.
    """
    # deferred: the build package's frontier imports this module
    from ...build.pool import pool_merge_ranked

    b, l = pool_ids.shape
    dev = pool_ids.device
    rows = torch.arange(b, device=dev)
    pool_ids = pool_ids.to(torch.int32)
    pool_exp = pool_exp.clone()
    if codes is not None:
        codes_i = codes.long()

        def score(nbrs):
            nd = pq_adc_rowwise_ref(tables, codes_i[nbrs.clamp_min(0).long()])
            return torch.where(nbrs >= 0, nd, torch.inf)
    else:
        q = queries.float()
        qn = sq_norms(q)

        def score(nbrs):
            return l2_score(x, n2, q, qn, nbrs)

    def pick(ids, d, exp):
        frontier_d = torch.where(exp | (ids < 0), torch.inf, d)
        j = torch.argmin(frontier_d, 1)          # first minimum, as argmin
        return j, torch.isfinite(frontier_d[rows, j])

    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    tid = torch.full((b, max_hops), -1, dtype=torch.int32, device=dev)
    td = torch.full((b, max_hops), torch.inf, dtype=torch.float32, device=dev)
    for h in range(max_hops):
        j, has = pick(pool_ids, pool_d, pool_exp)
        v = torch.where(has, pool_ids[rows, j], 0)
        td[:, h] = torch.where(has, pool_d[rows, j], torch.inf)
        tid[:, h] = torch.where(has, v, -1)
        pool_exp[rows, j] |= has
        nbrs = torch.where(has[:, None], adj[v.long()], -1)       # (B, R)
        pool_ids, pool_d, pool_exp = pool_merge_ranked(
            pool_ids, pool_d, pool_exp, nbrs, score(nbrs), l)
        hops += has.to(torch.int32)
    j, has = pick(pool_ids, pool_d, pool_exp)
    next_id = torch.where(has, pool_ids[rows, j], -1).to(torch.int32)
    return pool_ids, pool_d, pool_exp, hops, tid, td, next_id, ~has
