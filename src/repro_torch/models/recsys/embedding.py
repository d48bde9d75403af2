"""Embedding lookups for recsys (port of `repro.models.recsys.embedding`).

* `embedding_bag`: pooled lookup (sum / mean) over flat ids and segment
  ids; negative ids are padding.
* `sharded_lookup`: the table lookup.  Without a mesh it is a clipped
  take, as in the reference; the row-sharded mesh path waits for the
  port's serving fleet.
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag(table: torch.Tensor, flat_ids: torch.Tensor,
                  segment_ids: torch.Tensor, n_segments: int,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled lookup: out[s] = pool_{i: seg[i]=s} table[flat_ids[i]].

    flat_ids (M,) (negative = padding); segment_ids (M,) in
    [0, n_segments).  mode "mean" divides by max(count, 1).  The sums go
    through `index_add_`, whose order on a CUDA device is not fixed: two
    runs may differ in the last bits there (DIN pools its contiguous
    history bags with a masked sum instead; `models.recsys.din`).
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    ids = flat_ids.long()
    ok = ids >= 0
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    if weights is not None:
        rows = rows * weights[:, None]
    rows = torch.where(ok[:, None], rows, 0.0)
    # padding and out-of-range segments sum into a spare row, dropped after
    seg = segment_ids.long()
    seg = torch.where(ok & (seg >= 0) & (seg < n_segments), seg, n_segments)
    out = rows.new_zeros((n_segments + 1, table.shape[1])).index_add_(
        0, seg, rows)[:n_segments]
    if mode == "mean":
        cnt = rows.new_zeros(n_segments + 1).index_add_(
            0, seg, ok.to(rows.dtype))[:n_segments]
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for ids of any shape, clipped to the table's rows (the
    reference's lookup without a mesh); ids are cast to int64 first."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]
