"""Vectorized masked RobustPrune (Vamana) / MRNG edge selection (NSG); port
of `repro.build.prune`.

The host loop (`core.graph_build.robust_prune`) scans candidates in
ascending distance from p and keeps v unless an already kept u occludes it
(`alpha * d(u, v) <= d(p, v)`).  The kept set grows sequentially, but the
sequential axis can be the *kept* set instead of the candidate list: the
earliest candidate no kept entry occludes is itself kept (first-survivor
rounds), so each round promotes one candidate per row and occludes all
later candidates against it in a single (B, C, D) op.

Exact-parity contract with the host reference: candidates are
deduplicated by id (ascending, like `np.unique`), self is dropped, the
scan order is a stable sort by distance (ties break toward lower id),
distances use the same f32 subtract-square-sum form as
`graph_build._dists_to`, the occlusion test is the same
`alpha * duv <= dpv`, and the kept set caps at r.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, to_device, to_numpy
from ..kernels.l2_topk import sq_l2_rowwise

_SENT = torch.iinfo(torch.int32).max


def _prune_batch(x, p_ids, cand_ids, cand_d, r: int, alpha: float):
    """x (N, D) f32; p_ids (B,) int; cand_ids (B, C) int32 with -1 pad;
    cand_d (B, C) f32 (ignored where id < 0).  Returns kept (B, min(r, C))
    int32 ids, -1 padded, in selection (ascending-distance) order.
    """
    b, c = cand_ids.shape
    ids = torch.where((cand_ids >= 0) & (cand_ids != p_ids[:, None]),
                      cand_ids, -1)

    # dedupe by id, ascending (np.unique semantics): sort by id, mask runs
    key = torch.where(ids < 0, _SENT, ids)
    key_s, o1 = torch.sort(key, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, o1)
    d_s = torch.gather(cand_d, 1, o1)
    dup = torch.zeros_like(key_s, dtype=torch.bool)
    dup[:, 1:] = key_s[:, 1:] == key_s[:, :-1]
    ids_s = torch.where(dup, -1, ids_s)
    d_s = torch.where((ids_s < 0) | dup, torch.inf, d_s)

    # stable sort by distance: ties break toward lower id (ids ascending)
    d_s, o2 = torch.sort(d_s, dim=1, stable=True)
    ids_s = torch.gather(ids_s, 1, o2)
    vecs = x[ids_s.clamp_min(0).long()]                      # (B, C, D)

    # First-survivor rounds.  The reference loops while any row has a
    # candidate left; a row keeps one per round and at most r in all, and
    # a round with nothing available is a no-op, so r rounds give the same
    # result without reading a flag back from the device every round.
    rows = torch.arange(b, device=x.device)
    pos = torch.arange(c, device=x.device)
    valid = torch.isfinite(d_s)
    occl = torch.zeros((b, c), dtype=torch.bool, device=x.device)
    kept = torch.zeros_like(occl)
    cnt = torch.zeros(b, dtype=torch.int32, device=x.device)
    for _ in range(min(r, c)):
        avail = valid & ~occl & ~kept & (cnt < r)[:, None]
        act = avail.any(1)                                   # (B,)
        nxt = torch.argmax(avail.to(torch.uint8), 1)         # first True
        kept[rows, nxt] |= act
        duv = sq_l2_rowwise(vecs[rows, nxt], vecs)           # (B, C)
        later = pos[None, :] > nxt[:, None]
        occl |= act[:, None] & later & (alpha * duv <= d_s)
        cnt += act.to(torch.int32)

    # compress kept entries (already in selection order) to the first r slots
    o3 = torch.sort((~kept).to(torch.uint8), dim=1, stable=True).indices[:, :r]
    return torch.gather(torch.where(kept, ids_s, -1), 1, o3).to(torch.int32)


def robust_prune_batch(
    x,
    p_ids: np.ndarray,
    cand_ids: np.ndarray,
    cand_d: np.ndarray | None,
    r: int,
    alpha: float = 1.0,
    device=None,
) -> np.ndarray:
    """Batched RobustPrune; returns numpy (B, r) int32 kept ids, -1 padded.

    `x` is a numpy array or a tensor; the prune runs on `device` (None:
    the CUDA device).  `cand_d=None` recomputes candidate distances from x
    (the common build path, matching the host builders which re-derive
    distances after merging candidate sources).
    """
    dev = resolve_device(device)
    xt = to_device(x, dev, torch.float32)
    p = torch.as_tensor(np.asarray(p_ids, np.int64), device=dev)
    cand = torch.as_tensor(np.asarray(cand_ids, np.int32), device=dev)
    if cand_d is None:
        d = sq_l2_rowwise(xt[p], xt[cand.clamp_min(0).long()],
                          valid=cand >= 0)
    else:
        d = to_device(cand_d, dev, torch.float32)
    return to_numpy(_prune_batch(xt, p, cand, d, r=r, alpha=float(alpha)))


def robust_prune_inc(
    p_vec: np.ndarray,
    cand_ids: np.ndarray,
    cand_vecs: np.ndarray,
    r: int,
    alpha: float = 1.0,
) -> np.ndarray:
    """Incremental RobustPrune over explicit candidate vectors (numpy, on
    the host, as in the reference).

    The streaming entry point (delta-layer inserts, consolidation edge
    repair): unlike `robust_prune_batch` there is no global corpus array --
    the caller hands over the candidate vectors directly, so it works on a
    growing buffer that mixes frozen-base and delta points.  Same contract
    as the host reference: dedupe by id ascending, stable scan by distance
    (ties toward lower id), keep v unless a kept u has
    ``alpha * d(u, v) <= d(p, v)``, cap at r.  Returns kept ids (<= r,)
    int64 in selection order.
    """
    cand_ids = np.asarray(cand_ids, np.int64)
    cand_vecs = np.asarray(cand_vecs, np.float32)
    p_vec = np.asarray(p_vec, np.float32)
    if len(cand_ids) == 0:
        return np.empty(0, np.int64)
    uniq, first = np.unique(cand_ids, return_index=True)
    cand_ids, cand_vecs = uniq, cand_vecs[first]
    diff = cand_vecs - p_vec[None, :]
    cand_d = np.einsum("nd,nd->n", diff, diff)
    o = np.argsort(cand_d, kind="stable")
    kept: list[int] = []
    kept_vecs: list[np.ndarray] = []
    for i in o.tolist():
        dv = float(cand_d[i])
        xv = cand_vecs[i]
        ok = True
        for xu in kept_vecs:
            duv = float(np.dot(xu - xv, xu - xv))
            if alpha * duv <= dv:
                ok = False
                break
        if ok:
            kept.append(int(cand_ids[i]))
            kept_vecs.append(xv)
            if len(kept) >= r:
                break
    return np.asarray(kept, np.int64)
