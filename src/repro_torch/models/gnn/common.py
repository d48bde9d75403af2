"""Message-passing substrate: segment ops over padded edge lists (port of
`repro.models.gnn.common`).

Message passing is built from gathers and `index_add_` /
`scatter_reduce` over (edge_src, edge_dst) index arrays.  Edges are
padded with -1 (src/dst): indices are clipped before every gather (torch
wraps a negative index where JAX clamps it), padded messages are zeroed
and scattered to a dump row.  Every gather is `index_select`, whose
backward is an `index_add_`: advanced indexing's backward sorts the
indices and sums each run of duplicates in turn, and the -1 pads all
clip to row 0 (about 97,000 of minibatch_lg's 168,960 edge slots, 20,000
of the molecule cell's 32,768 triplet slots), which made a GraphCast
step on the card take seconds.  On a CUDA device `index_add_` adds with
float atomics, so a sum is not bitwise the same from run to run.

`mlp_specs` (a sharding spec) waits for the sharded slice (ROADMAP Queue
1 item 7.3).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..._device import resolve_device, to_device
from ...utils.tree import tree_map
from ..layers import act_fn, dense_init


# ---------------------------------------------------------------------------
# MLP helper
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             device=None) -> dict:
    """{"w": [(sizes[i], sizes[i+1])], "b": [zeros]} in f32, weights
    N(0, 1/d_in) drawn from `generator` (torch's numbers, not
    jax.random's)."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    return {"w": [dense_init(generator, a, b, device) for a, b in pairs],
            "b": [torch.zeros((b,), device=device) for _, b in pairs]}


def mlp_apply(p: dict, x: torch.Tensor, activation: str = "silu",
              final_act: bool = False) -> torch.Tensor:
    n = len(p["w"])
    for i in range(n):
        # params stay f32; compute follows the activation dtype (bf16 for
        # the large full-graph cells)
        x = x @ p["w"][i].to(x.dtype) + p["b"][i].to(x.dtype)
        if i < n - 1 or final_act:
            x = act_fn(activation)(x)
    return x


def tree_from_numpy(tree, device=None):
    """A reference parameter tree (numpy arrays, or anything
    `numpy.asarray` reads) as float32 tensors on `device` (None means the
    CUDA device), in the same layout."""
    dev = resolve_device(device)
    return tree_map(lambda a: to_device(a, dev, torch.float32), tree)


def check_depth(name: str, got: int, want: int) -> None:
    if got != want:
        raise ValueError(f"{name}: the tree has {got} layers, the config "
                         f"{want}")


# ---------------------------------------------------------------------------
# Padded segment message passing
# ---------------------------------------------------------------------------
def edge_mask(edge_src: torch.Tensor) -> torch.Tensor:
    return edge_src >= 0


def clip_index(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """idx clipped to [0, rows - 1] as int64: the row JAX's clamped
    gather reads for a -1 pad."""
    return idx.clamp(0, rows - 1).long()


def gather_src_dst(node_feat: torch.Tensor, edge_src, edge_dst):
    """(N, d) -> ((E, d), (E, d)); padded edges gather row 0 (masked
    later)."""
    return take_rows(node_feat, edge_src), take_rows(node_feat, edge_dst)


def segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                rows: int) -> torch.Tensor:
    """(E, ...) values summed into (rows, ...) at idx; idx in [0, rows)."""
    out = vals.new_zeros((rows,) + tuple(vals.shape[1:]))
    return out.index_add(0, idx.long(), vals)


def scatter_to_nodes(messages: torch.Tensor, edge_dst: torch.Tensor,
                     n_nodes: int, mask: torch.Tensor | None = None,
                     agg: str = "sum") -> torch.Tensor:
    """(E, d) messages -> (N, d) aggregated at edge_dst.  agg: sum|mean|max;
    a node that receives no message gets 0 under max, as in the
    reference."""
    if mask is None:
        mask = edge_mask(edge_dst)
    dst = torch.where(mask, edge_dst, n_nodes).long()   # dump row for padding
    if agg == "max":
        m = torch.where(mask[:, None], messages, float("-inf"))
        out = torch.full((n_nodes + 1, messages.shape[1]), float("-inf"),
                         dtype=messages.dtype, device=messages.device)
        out = out.scatter_reduce(0, dst[:, None].expand_as(m), m, "amax")
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        m = torch.where(mask[:, None], messages, 0.0)
        out = segment_sum(m, dst, n_nodes + 1)
        if agg == "mean":
            cnt = segment_sum(mask.to(messages.dtype), dst, n_nodes + 1)
            out = out / cnt.clamp_min(1.0)[:, None]
    return out[:n_nodes]


def degree(edge_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    mask = edge_mask(edge_dst)
    dst = torch.where(mask, edge_dst, n_nodes)
    return segment_sum(mask.float(), dst, n_nodes + 1)[:n_nodes]


def scatter_rows(vals: torch.Tensor, ix: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """The models' default `scatter_fn`: vals summed at ix, -1 dropped."""
    return segment_sum(vals, torch.where(ix >= 0, ix, rows), rows + 1)[:rows]


def take_rows(table: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """table's rows at ix, clipped (the models' default `gather_fn`)."""
    return torch.index_select(table, 0, clip_index(ix, table.shape[0]))


def graph_energies(e_atom: torch.Tensor, batch) -> torch.Tensor:
    """Per-atom energies summed per graph: `graph_ids` (N,) -> (n_graphs,)
    with n_graphs static, `energy`'s length; all atoms if no ids."""
    gid = batch.get("graph_ids")
    if gid is None:
        return e_atom.sum().reshape(1)
    return segment_sum(e_atom, gid, batch["energy"].shape[0])


# ---------------------------------------------------------------------------
# Geometry helpers (radius/molecular graphs)
# ---------------------------------------------------------------------------
def edge_vectors(pos: torch.Tensor, edge_src, edge_dst, eps: float = 1e-9):
    """Returns (unit r_ij (E,3), |r_ij| (E,)) for edges src->dst."""
    ps, pd = gather_src_dst(pos, edge_src, edge_dst)
    d = pd - ps
    r = torch.sqrt(torch.clamp_min((d * d).sum(-1), eps))
    return d / r[:, None], r


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis sin(n pi r / c) / r with cosine envelope (E, n)."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rb = (torch.sin(n[None, :] * torch.pi * r[:, None] / cutoff)
          * (2.0 / cutoff) ** 0.5 / torch.clamp_min(r[:, None], 1e-9))
    return rb * cosine_cutoff(r, cutoff)[:, None]


def cosine_cutoff(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    return 0.5 * (torch.cos(torch.pi * x) + 1.0)
