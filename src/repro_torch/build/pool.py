"""The fixed-shape (B, L) insert-sort candidate pool (port of
`repro.build.pool`).

`pool_merge` merges with two stable sorts; `pool_merge_ranked` is the
sort-free form (merge ranks plus one slot-match scatter) that the fused
CUDA hop kernel (`csrc/beam_hops_adc.cu`) inlines.  Both give outputs
bit-identical to the JAX reference on the same inputs.
"""
from __future__ import annotations

import torch

_SENT = torch.iinfo(torch.int32).max   # -1 ids rank last, as id=+sentinel


def pool_merge(pool_ids, pool_d, pool_exp, cand_ids, cand_d, l: int):
    """Vectorized insert-sort of candidates into the sorted (B, L) pool.

    Duplicate ids collapse to the incumbent pool entry (the stable sort by
    id keeps the lower concat index, and the pool occupies 0..L-1), so an
    expanded flag survives re-insertion.  Returns the new (ids, dists,
    expanded), sorted ascending by (dist, id) with invalid entries
    (-1, +inf, False) at the tail.
    """
    ids = torch.cat([pool_ids.to(torch.int32), cand_ids.to(torch.int32)], 1)
    d = torch.cat([pool_d, cand_d], 1)
    exp = torch.cat([pool_exp, torch.zeros(cand_ids.shape, dtype=torch.bool,
                                           device=pool_exp.device)], 1)
    d = torch.where(ids < 0, torch.inf, d)
    key = torch.where(ids < 0, _SENT, ids)
    sid, order = torch.sort(key, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    d_s = torch.gather(d, 1, order)
    exp_s = torch.gather(exp, 1, order)
    dup = torch.zeros_like(exp_s)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    ids_s = torch.where(dup, -1, ids_s)
    d_s = torch.where(dup, torch.inf, d_s)
    exp_s = exp_s & ~dup
    o2 = torch.sort(d_s, dim=1, stable=True).indices[:, :l]
    return (torch.gather(ids_s, 1, o2), torch.gather(d_s, 1, o2),
            torch.gather(exp_s, 1, o2))


def pool_merge_ranked(pool_ids, pool_d, pool_exp, cand_ids, cand_d, l: int):
    """Sort-free `pool_merge`: merge ranks instead of two stable sorts.

    Requires the pool invariant every merge output keeps: ascending by
    (dist, id), unique valid ids, invalid entries exactly (-1, +inf,
    False).  Candidates may duplicate the pool or each other, or be -1.
    A candidate duplicating a pool id or an earlier candidate is dropped;
    survivors land at their lexicographic (dist, id) merge rank -- pool
    entries at old index + #{strictly smaller candidates}, candidates at
    #{pool entries at most theirs} + #{candidates ranked earlier}.  Ranks
    >= l fall off.  Returns (ids, dists, expanded) of shape (B, l).
    """
    pids = pool_ids.to(torch.int32)
    cids = cand_ids.to(torch.int32)
    cd = torch.where(cids < 0, torch.inf, cand_d)
    r = cids.shape[1]

    dup_pool = ((pids[:, None, :] == cids[:, :, None])
                & (cids[:, :, None] >= 0)).any(2)                 # (B, R)
    j = torch.arange(r, device=cids.device)
    earlier = j[None, :, None] > j[None, None, :]                  # j' < j
    dup_cand = ((cids[:, :, None] == cids[:, None, :])
                & (cids[:, :, None] >= 0) & earlier).any(2)
    valid = (cids >= 0) & ~dup_pool & ~dup_cand
    cd = torch.where(valid, cd, torch.inf)
    cids = torch.where(valid, cids, -1)

    pkid = torch.where(pids < 0, _SENT, pids)
    ckid = torch.where(cids < 0, _SENT, cids)
    c_lt_p = ((cd[:, :, None] < pool_d[:, None, :])               # (B, R, L)
              | ((cd[:, :, None] == pool_d[:, None, :])
                 & (ckid[:, :, None] < pkid[:, None, :])))
    pos_p = (torch.arange(pids.shape[1], device=pids.device)[None, :]
             + c_lt_p.sum(1))
    ctie = cd[:, :, None] == cd[:, None, :]
    c_lt_c = ((cd[:, :, None] > cd[:, None, :])
              | (ctie & (ckid[:, :, None] > ckid[:, None, :]))
              | (ctie & (ckid[:, :, None] == ckid[:, None, :]) & earlier))
    pos_c = (~c_lt_p).sum(2) + c_lt_c.sum(2)

    # merge ranks of all L + R entries are distinct, so each slot < l has
    # exactly one writer; the slot-match sums are the JAX reference's form
    slot = torch.arange(l, device=pids.device)
    mask_p = pos_p[:, :, None] == slot                             # (B, L, l)
    mask_c = pos_c[:, :, None] == slot                             # (B, R, l)
    ids_o = (torch.where(mask_p, pids[:, :, None], 0).sum(1)
             + torch.where(mask_c, cids[:, :, None], 0).sum(1))
    d_o = (torch.where(mask_p, pool_d[:, :, None], 0.0).sum(1)
           + torch.where(mask_c, cd[:, :, None], 0.0).sum(1))
    wrote = mask_p.any(1) | mask_c.any(1)
    exp_o = (mask_p & pool_exp[:, :, None]).any(1)
    return (torch.where(wrote, ids_o, -1).to(torch.int32),
            torch.where(wrote, d_o, torch.inf), exp_o)
