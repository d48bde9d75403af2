"""Per-row exact re-rank (port of `repro.kernels.l2_topk.ops`'s
`sq_l2_rowwise` and `l2_topk_rowwise`).  Plain PyTorch: in the reference
these are plain jnp outside any Pallas kernel too.
"""
from __future__ import annotations

import torch


def sq_l2_rowwise(queries: torch.Tensor, bases: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row exact squared L2: queries (B, D) vs bases (B, C, D) ->
    (B, C); invalid entries get +inf."""
    diff = bases.float() - queries.float()[:, None, :]
    d = (diff * diff).sum(-1)
    if valid is not None:
        d = torch.where(valid, d, torch.inf)
    return d


def l2_topk_rowwise(queries: torch.Tensor, bases: torch.Tensor, k: int,
                    valid: torch.Tensor | None = None):
    """Per-row exact re-rank: each query against its *own* candidates.

    queries (B, D); bases (B, C, D); valid (B, C) bool or None.  Returns
    (dists (B, k) ascending, idx (B, k) int64) where idx indexes into C.
    Ties keep the lower index first, as `jax.lax.top_k` does: a stable
    sort, since `torch.topk` promises no tie order.
    """
    d = sq_l2_rowwise(queries, bases, valid)
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]
