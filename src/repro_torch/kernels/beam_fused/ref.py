"""Plain PyTorch version of the fused ADC beam-hop loop.

One hop is the unfused serve step (`serve.ann_engine.batched_search`):
pop the best unexpanded pool entry of each row, gather its padded
adjacency row, ADC-score the neighbours (`pq_adc_rowwise_ref`), merge
them into the sorted (B, L) pool with `pool_merge_ranked`, count the hop.
Every hop records its frontier pick, and the loop ends with the next pick
and a done mask.  The CUDA kernel (`csrc/beam_hops_adc.cu`) is held to
this function on every output.
"""
from __future__ import annotations

import torch

from ...build.pool import pool_merge_ranked
from ..pq_adc.ref import pq_adc_rowwise_ref


def beam_hops_ref(adj, pool_ids, pool_d, pool_exp, max_hops: int, *,
                  tables, codes):
    """Run `max_hops` beam hops over a seeded pool, ADC scoring.

    adj (N, R) int32 with -1 pad; pool_ids/pool_d/pool_exp (B, L) the
    seeded sorted pool (ascending (dist, id), invalid = (-1, +inf,
    False)); tables (B, M, K) f32; codes (N, M) uint8/int.

    Returns (pool_ids, pool_d, pool_exp, hops (B,) int32,
    trace_ids (B, max_hops) int32, trace_d (B, max_hops) f32,
    next_id (B,) int32, done (B,) bool): the final pool, per-hop frontier
    picks (-1 / +inf where a row had no frontier left), the next frontier
    pick after the last hop, and whether the beam is exhausted.
    """
    b, l = pool_ids.shape
    dev = pool_ids.device
    rows = torch.arange(b, device=dev)
    codes_i = codes.long()
    pool_ids = pool_ids.to(torch.int32)
    pool_exp = pool_exp.clone()

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
        nd = pq_adc_rowwise_ref(tables, codes_i[nbrs.clamp_min(0).long()])
        nd = torch.where(nbrs >= 0, nd, torch.inf)
        pool_ids, pool_d, pool_exp = pool_merge_ranked(
            pool_ids, pool_d, pool_exp, nbrs, nd, l)
        hops += has.to(torch.int32)
    j, has = pick(pool_ids, pool_d, pool_exp)
    next_id = torch.where(has, pool_ids[rows, j], -1).to(torch.int32)
    return pool_ids, pool_d, pool_exp, hops, tid, td, next_id, ~has
