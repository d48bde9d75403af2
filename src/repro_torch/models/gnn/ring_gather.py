"""Memory-bounded distributed row gather and its mirror, the distributed
segment sum (port of `repro.models.gnn.ring_gather`).

`ring_gather`: out[t] = table[idx[t]] where `table` is row-sharded over
mesh axes and idx indexes it *globally*.  Instead of all-gathering the
table, the local blocks rotate around the ring of the axes' ranks
(`utils.sharding.ring_shift`, the reference's collective-permute); each
rank picks the rows it needs from the block it holds.  Peak extra memory
is one block.

Its backward is the mirrored ring *scatter*: cotangent rows accumulate in
f32 into a rotating per-owner buffer with a dump row for the ids that
other owners hold; after P steps every owner's buffer has visited every
rank and is back home, complete.  `ring_scatter_add` is that scatter as a
function of its own, and its backward is the ring gather: each is the
other's VJP.  One block is live at a time in either direction.

The contract is `shard_map`'s, one process a rank: a rank holds its
table block `table_local` (R, d), the rows [me*R, (me+1)*R) with `me`
its flat coordinate over `axes` (the first axis outermost), and its own
global ids `idx` (T_local,).  A negative id is padding: zeros out of the
gather, dropped by the scatter.  Every rank of the ring calls, with the
same R.  The gather's forward rotates P - 1 times (the P-th would only
bring the table home); the scatter rotates P times, so that each owner's
accumulator returns home.  Collective volume is one logical all-gather
of the table a call: the win is memory, not bytes.
"""
from __future__ import annotations

import torch

from ...utils.sharding import ring_group, ring_shift


def _owner_rows(idx: torch.Tensor, owner: int, rows: int):
    """(ids held by `owner`'s block, their rows in it)."""
    lo = owner * rows
    sel = (idx >= lo) & (idx < lo + rows)
    return sel, idx - lo


def _gather(table_local: torch.Tensor, idx: torch.Tensor, mesh,
            axes) -> torch.Tensor:
    _, me, p = ring_group(mesh, axes)
    r = table_local.shape[0]
    idx = idx.long()
    out = table_local.new_zeros((idx.shape[0],) + tuple(table_local.shape[1:]))
    chunk = table_local
    for i in range(p):
        sel, rel = _owner_rows(idx, (me - i) % p, r)
        rows = chunk.index_select(0, rel.clamp(0, r - 1))
        out = torch.where(sel.view((-1,) + (1,) * (out.dim() - 1)), rows,
                          out)
        if i < p - 1:
            chunk = ring_shift(chunk, mesh, axes)
    return out


def _scatter(values: torch.Tensor, idx: torch.Tensor, mesh, axes,
             rows_local: int) -> torch.Tensor:
    """This rank's (rows_local, ...) block of the f32 segment sum."""
    _, me, p = ring_group(mesh, axes)
    idx = idx.long()
    tail = tuple(values.shape[1:])
    lift = (-1,) + (1,) * len(tail)
    acc = values.new_zeros((rows_local,) + tail, dtype=torch.float32)
    for i in range(p):
        # acc belongs to owner (me - i) % p now: add this rank's rows for it
        sel, rel = _owner_rows(idx, (me - i) % p, rows_local)
        local = torch.where(sel, rel, rows_local)          # dump row
        part = torch.where(sel.view(lift), values, 0.0).float()
        contrib = acc.new_zeros((rows_local + 1,) + tail).index_add_(
            0, local, part)[:rows_local]
        acc = ring_shift(acc + contrib, mesh, axes)
    return acc


class _RingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_local, idx, mesh, axes):
        ctx.save_for_backward(idx)
        ctx.mesh, ctx.axes = mesh, axes
        ctx.rows, ctx.dtype = table_local.shape[0], table_local.dtype
        return _gather(table_local, idx, mesh, axes)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        acc = _scatter(dout, idx, ctx.mesh, ctx.axes, ctx.rows)
        return acc.to(ctx.dtype), None, None, None


class _RingScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, mesh, axes, rows_local):
        ctx.save_for_backward(idx)
        ctx.mesh, ctx.axes, ctx.dtype = mesh, axes, values.dtype
        return _scatter(values, idx, mesh, axes, rows_local).to(values.dtype)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        dv = _gather(dout, idx, ctx.mesh, ctx.axes)
        return dv.to(ctx.dtype), None, None, None, None


def ring_gather(table_local: torch.Tensor, idx: torch.Tensor, mesh,
                axes) -> torch.Tensor:
    """table_local (R, ...) = this rank's rows [me*R, (me+1)*R) of a table
    row-sharded over `axes` of `mesh`; idx (T,) global row ids (negative
    = padding -> zeros).  Returns (T, ...), each row bitwise the table's.
    Backward: the ring scatter, summed in f32."""
    return _RingGather.apply(table_local, idx, mesh, axes)


def ring_scatter_add(values: torch.Tensor, idx: torch.Tensor, mesh, axes,
                     rows_local: int) -> torch.Tensor:
    """out[idx[t]] += values[t] with `out` row-sharded over `axes`: values
    (T_local, ...), idx (T_local,) *global* row ids (negative = dropped).
    Returns this rank's (rows_local, ...) block, summed in f32 and cast
    to the values' dtype.  Backward: the ring gather."""
    return _RingScatterAdd.apply(values, idx, mesh, axes, rows_local)
