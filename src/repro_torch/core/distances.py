"""Batched / chunked distance computation and exact kNN (port of
`repro.core.distances`).

All distances are SQUARED Euclidean.  Functions take tensors and compute
on their device.  Ground truth must be IEEE f32, so every product runs
inside `f32_matmul`, which turns TF32 off for the product and restores the
caller's setting after it (a float32 matmul on the card may otherwise keep
only about three decimal digits).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def f32_matmul():
    """Run the block's float32 matmuls in IEEE f32 (TF32 off), then
    restore the caller's `torch.backends.cuda.matmul.allow_tf32`."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pairwise_sq_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(na, d), (nb, d) -> (na, nb) squared L2 in the expanded form,
    clamped at 0: (|a|^2 + |b|^2) - 2 a.b, as the reference orders it."""
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1)
    with f32_matmul():
        d = torch.addmm(a2 + b2[None, :], a, b.T, alpha=-2.0)
    return d.clamp_min_(0.0)


def _smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of each row of `d`, ascending by (dist,
    index) -- `jax.lax.top_k(-d, k)`'s choice and order, lower index first
    on ties.  `torch.topk` promises no tie order: where more entries of a
    row equal its k-th smallest value than topk kept, it may keep others
    than the lowest-indexed, so those rows are chosen again by a stable
    sort.  The kept k are then re-sorted stably: by index, then by
    distance."""
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=False)
    kth = vals.max(1, keepdim=True).values
    ragged = ((d == kth).sum(1) > (vals == kth).sum(1)).nonzero()[:, 0]
    if len(ragged):
        idx[ragged] = torch.sort(d[ragged], dim=1, stable=True).indices[:, :k]
        vals[ragged] = torch.gather(d[ragged], 1, idx[ragged])
    idx, o = torch.sort(idx, dim=1)
    vals = torch.gather(vals, 1, o)
    vals, o = torch.sort(vals, dim=1, stable=True)
    return vals, torch.gather(idx, 1, o)


def exact_knn(base: torch.Tensor, queries: torch.Tensor, k: int,
              chunk: int = 1024):
    """Exact kNN by brute force, chunked over queries.  Returns (dists,
    ids) tensors of shape (nq, k) on `base`'s device, ids int64."""
    out_d, out_i = [], []
    for s in range(0, len(queries), chunk):
        q = queries[s:s + chunk].to(base.device)
        dd, ii = _smallest_k(pairwise_sq_l2(q, base), k)
        out_d.append(dd)
        out_i.append(ii)
    return torch.cat(out_d, 0), torch.cat(out_i, 0)


def knn_graph(x: torch.Tensor, k: int, chunk: int = 1024) -> torch.Tensor:
    """Exact directed kNN graph (self excluded).  Returns int32 (n, k).

    Each row keeps the first k of its k + 1 nearest ids other than
    itself; rows shorter than k (corpora of fewer than k + 1 points) are
    padded with -1, the missing-edge sentinel."""
    n = x.shape[0]
    _, ids = exact_knn(x, x, min(k + 1, n), chunk=chunk)
    keep = ids != torch.arange(n, device=ids.device)[:, None]
    keep &= keep.cumsum(1) <= k
    # stable sort on the drop flag moves the kept ids to the front in order
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    ids = torch.gather(ids, 1, order)
    kept = torch.gather(keep, 1, order)
    adj = torch.where(kept, ids, -1).to(torch.int32)[:, :k]
    if adj.shape[1] < k:
        pad = adj.new_full((n, k - adj.shape[1]), -1)
        adj = torch.cat([adj, pad], 1)
    return adj.contiguous()


def medoid(x: torch.Tensor, sample: int | None = 4096, seed: int = 0) -> int:
    """Approximate medoid: the point closest to the dataset mean, the
    argmin restricted to a seeded uniform sample of `sample` candidates
    when n > sample (numpy draws, as the reference)."""
    mean = x.float().mean(0, keepdim=True)
    n = len(x)
    if sample is not None and n > sample:
        cand = np.random.default_rng(seed).choice(n, size=sample,
                                                  replace=False)
        cand_t = torch.as_tensor(cand, device=x.device)
        d = pairwise_sq_l2(mean, x[cand_t])[0]
        return int(cand[int(torch.argmin(d))])
    return int(torch.argmin(pairwise_sq_l2(mean, x)[0]))


def recall_at_k(ids, gt, k: int) -> float:
    """Mean recall@k of (B, >=k) result ids against (B, >=k) ground truth;
    arrays or tensors.  Padding ids (-1) count as misses."""
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)
    gt = np.asarray(gt.cpu() if torch.is_tensor(gt) else gt)
    hits = sum(len(set(ids[i, :k].tolist()) & set(gt[i, :k].tolist()))
               for i in range(len(ids)))
    return hits / (len(ids) * k)
