"""Embedding lookups for recsys (port of `repro.models.recsys.embedding`).

* `embedding_bag`: pooled lookup (sum / mean) over flat ids and segment
  ids; negative ids are padding.
* `sharded_lookup`: the table lookup.  Without a mesh it is a clipped
  take, as in the reference; over a `DeviceMesh` it is the reference's
  Megatron-style row-sharded lookup: each rank of `model_axis` holds a
  block of the table's rows and takes the ids that fall in it (zeros for
  the others), and the blocks' rows are summed over the axis.  Tables of
  10^6..10^9 rows shard over `model` and are never gathered.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...utils.sharding import P, local, reduce_from, shard_leaf


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


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None,
                   model_axis: Optional[str] = None,
                   batch_axes: tuple = ()) -> torch.Tensor:
    """table[ids] for ids of any shape, clipped to the table's rows; ids
    are cast to int64 first.

    With a mesh whose `model_axis` exists: `table` is this rank's block of
    rows (a DTensor sharded P(model_axis, None), or its local tensor),
    `ids` the global ids (the same on every rank), and the result this
    rank's rows of table[ids] over `batch_axes` (the reference's out
    spec; all rows when `batch_axes` is empty): the masked local take
    summed over `model_axis`.  The sum adds zeros to the one block that
    holds each row, so the result equals the unsharded lookup bitwise.
    Without a mesh: the plain take."""
    if mesh is None or model_axis is None \
            or model_axis not in mesh.mesh_dim_names:
        return table[ids.long().clamp(0, table.shape[0] - 1)]
    if batch_axes:
        ids = local(shard_leaf(mesh, P(tuple(batch_axes)), ids))
    table = local(table)
    v_local = table.shape[0]
    loc = ids.long() - mesh.get_local_rank(model_axis) * v_local
    ok = (loc >= 0) & (loc < v_local)
    rows = torch.where(ok[..., None], table[loc.clamp(0, v_local - 1)], 0.0)
    return reduce_from(rows, mesh, model_axis)
