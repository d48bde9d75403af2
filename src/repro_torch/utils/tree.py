"""Tree helpers over nested dicts, lists and tuples of tensors (port of
`repro.utils.tree`, plus the path walk that `jax.tree_util` gives the
reference).

The walk is `jax.tree_util`'s: dict keys in sorted order, lists and
tuples in order, `None` a node with no leaf, anything else a leaf.  So
the leaf order (and with it the order `global_norm` sums in) and the
paths `flatten_with_path` writes (`keystr`'s: ``['params']['layers']['wq']``,
``['attn']['w'][0]``) are the reference's, and a checkpoint keyed by
them crosses between the two packages.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor


def _children(tree):
    """[(path piece, child)] of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def flatten_with_path(tree) -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in the reference's leaf order."""
    out = []

    def walk(t, path):
        if t is None:
            return
        kids = _children(t)
        if kids is None:
            out.append((path, t))
            return
        for piece, c in kids:
            walk(c, path + piece)

    walk(tree, "")
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves):
    """A tree of `like`'s structure holding `new_leaves` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}      # `like`'s key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and of each tree in `rest` (same
    structure), as `jax.tree.map`."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_count_params(tree) -> int:
    return sum(math.prod(x.shape) for x in leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's f32 sum
    of squares (the reference's order: one sum a leaf, then their sum).
    A sharded leaf (DTensor) sums its block's squares, then sums them
    over the mesh axes that shard it, so every rank gets the same norm."""
    xs = leaves(tree)
    sharded = [isinstance(x, DTensor) for x in xs]
    if not any(sharded):
        sq = [torch.sum(torch.square(x.float())) for x in xs]
        return torch.sqrt(torch.sum(torch.stack(sq)))
    from .sharding import shard_sums       # sharding imports this module
    sq = [torch.sum(torch.square(x.to_local().float())) if s
          else torch.sum(torch.square(x.float())) for x, s in zip(xs, sharded)]
    return torch.sqrt(torch.sum(torch.stack(shard_sums(sq, xs))))


def tree_cast(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype), tree)
