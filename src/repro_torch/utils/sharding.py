"""Mesh and sharding helpers over `torch.distributed` (port of
`repro.utils.sharding`), and the collectives the sharded paths run.

Sharding conventions (the reference's):
  mesh axes: ("data", "model") single-pod / ("pod", "data", "model") multi-pod
  - batch-like dims        -> ("pod", "data") when multi_pod else ("data",)
  - tensor-parallel dims   -> "model"
  - replicated             -> None

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dims carry
those names; every rank runs the same program and holds its own block of
each array.  A spec is `P(*dims)`, the reference's `PartitionSpec`: one
entry per tensor dim, None, an axis name or a tuple of names (a leaf of
`utils.tree`, not a tuple node).  `placements(mesh, spec)` turns it into
DTensor placements, one per mesh dim (`Shard(d)` / `Replicate()`).

A sharded leaf is a `DTensor` holding this rank's block; a leaf
replicated over the whole mesh stays a plain tensor (the same on every
rank).  `shard_leaf` cuts a full tensor, the same on every rank, into
this rank's block without communication; `full_tensor` gathers it back
(every rank of the mesh joins).  Blocks are even, as in the reference:
a dim that its axes do not divide raises (`ShardCtx.sanitize` drops
such a sharding first where the reference does).

Collectives (`all_reduce` with a sum or a max, `all_gather`,
`reduce_scatter`, `all_to_all`, `broadcast`, `reduce`, and
`ring_shift`, one step of a ring over one axis or over all of a
mesh's axes) run on a mesh axis's process group and are counted in
`comm_log` by kind: calls, payload bytes (what this rank sends) and
result bytes (what it holds after: the gathered whole of an all-gather,
the one block of a reduce-scatter -- the reference's HLO byte count).  They take the tensors
where they lie, on the card too: a backend that refuses a device raises,
and nothing moves to the host instead.  The autograd faces
(`reduce_from`, `copy_to`, `gather_view`, `compute_view`) are Megatron's
conjugate pairs: an all-reduce forward is an identity backward and the
reverse, an all-gather forward is a reduce-scatter backward and the
reverse (`scatter_view`); the tiled all-to-all is its own inverse
exchange backward.
"""
from __future__ import annotations

import collections
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .tree import tree_map


class P:
    """A PartitionSpec: one entry per tensor dim (None, an axis name, or
    a tuple of axis names; a tuple of one name is that name, an empty one
    None, as JAX normalises them); trailing dims unnamed are
    replicated."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(_entry(d) for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"P{self.dims!r}"


def _entry(d):
    if isinstance(d, (list, tuple)):
        d = tuple(d)
        return None if not d else d[0] if len(d) == 1 else d
    return d


def _axes(entry) -> tuple:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# The reference's helpers
# ---------------------------------------------------------------------------
def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def batch_axes(mesh) -> tuple:
    """The mesh axes that jointly shard the batch dimension."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def spec_batch(mesh, *rest: Any) -> P:
    """PartitionSpec with the leading dim sharded over the data(+pod) axes."""
    return P(batch_axes(mesh), *rest)


def mesh_size(mesh) -> int:
    return math.prod(mesh.shape)


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    if name not in names:
        return 1
    return mesh.shape[names.index(name)]


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")


def dp_size(mesh) -> int:
    return axis_size(mesh, "data") * axis_size(mesh, "pod")


def check_divisible(dim: int, parts: int, what: str) -> None:
    if dim % parts != 0:
        raise ValueError(f"{what}={dim} not divisible by mesh factor {parts}")


def specs_like(tree, spec_fn) -> Any:
    """Map a function leaf->PartitionSpec over a tree of tensors."""
    return tree_map(spec_fn, tree)


def map_specs(fn, specs, shapes):
    """fn(spec, shape tuple) at each leaf of a spec tree (P or None in
    dicts and lists), paired with the same position of `shapes` (tensors,
    or shape tuples)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, shapes[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, x) for v, x in zip(specs, shapes)]
    if specs is None or shapes is None:
        return specs
    return fn(specs, tuple(getattr(shapes, "shape", shapes)))


def placements(mesh, spec: Optional[P]) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dim: Shard(d)
    on each axis that names tensor dim d, Replicate() elsewhere.  A dim
    named by several axes is split over them in mesh order (the first
    axis outermost), as the reference's tuple entries are."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec or ()):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two "
                                 f"dims")
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A mesh and a spec (the reference's `NamedSharding`)."""

    def __init__(self, mesh, spec: Optional[P]):
        self.mesh = mesh
        self.spec = spec if spec is not None else P()

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {self.spec})"


def ns(mesh, spec: Optional[P]) -> NamedSharding:
    return NamedSharding(mesh, spec)


def coordinate(mesh, axes) -> tuple[int, int]:
    """(this rank's block index, block count) over `axes` (mesh order,
    the first outermost)."""
    idx, n = 0, 1
    for a in _axes(axes):
        if a in axis_names(mesh):
            s = axis_size(mesh, a)
            idx = idx * s + mesh.get_local_rank(a)
            n *= s
    return idx, n


def local_block(mesh, spec: Optional[P], x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the full tensor `x` under `spec` (a view)."""
    for d, entry in enumerate(spec or ()):
        i, n = coordinate(mesh, entry)
        if n > 1:
            check_divisible(x.shape[d], n, f"dim {d} of {tuple(x.shape)}")
            c = x.shape[d] // n
            x = x.narrow(d, i * c, c)
    return x


def shard_leaf(mesh, spec: Optional[P], x):
    """The full tensor `x` (the same on every rank; a DTensor is gathered
    first, unless it is laid out as `spec` already on `mesh`, when it is
    returned as it is) laid out as `spec`: a DTensor holding a copy of
    this rank's block, or, when `spec` replicates it over the whole mesh,
    the plain tensor.  No communication for a plain `x`; not
    differentiable."""
    if x is None:
        return None
    where = placements(mesh, spec)
    if (isinstance(x, DTensor) and x.device_mesh is mesh
            and tuple(x.placements) == where):
        return x            # laid out as asked already: no gather
    x = full_tensor(x)
    if not any(isinstance(p, Shard) for p in where):
        return x
    block = local_block(mesh, spec, x.detach()).clone()
    return DTensor.from_local(block, mesh, where, run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_tree(tree, specs, mesh):
    """`shard_leaf` over a tree and its spec tree (a None spec where the
    tree has a tensor means replicated)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_tree(v, None if specs is None else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, None if specs is None else specs[i],
                                     mesh) for i, v in enumerate(tree))
    return shard_leaf(mesh, specs, tree)


def local(x):
    """This rank's block: the local tensor of a DTensor, else `x`."""
    return x.to_local() if isinstance(x, DTensor) else x


def sharded_dims(x) -> list[tuple[str, int]]:
    """[(mesh axis, tensor dim)] that shard the DTensor `x` ([] for a
    plain tensor)."""
    if not isinstance(x, DTensor):
        return []
    names = axis_names(x.device_mesh)
    return [(names[i], p.dim) for i, p in enumerate(x.placements)
            if isinstance(p, Shard)]


def full_tensor(x):
    """The full value of a DTensor, gathered over each axis that shards it
    (every rank of its mesh must call); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, out = x.device_mesh, x.to_local()
    # innermost axis first: each gather restores one level of blocks
    for axis, d in reversed(sharded_dims(x)):
        out = all_gather(out, mesh, axis, d)
    return out


def shard_sums(sums: list, xs: list) -> list:
    """Each leaf's partial sum (`sums[i]`, over this rank's block of
    `xs[i]`) summed over the mesh axes that shard the leaf: one
    all-reduce for each set of axes."""
    out = list(sums)
    groups: dict = collections.defaultdict(list)
    for i, x in enumerate(xs):
        axes = tuple(a for a, _ in sharded_dims(x))
        if axes:
            groups[(id(x.device_mesh), axes)].append(i)
    for (_, axes), idx in sorted(groups.items(), key=lambda kv: kv[1][0]):
        total = all_reduce(torch.stack([sums[i] for i in idx]),
                           xs[idx[0]].device_mesh, axes)
        for j, i in enumerate(idx):
            out[i] = total[j]
    return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
class CommLog:
    """This process's collectives: calls and payload bytes by kind."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.out_bytes = collections.Counter()

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "out_bytes": dict(self.out_bytes)}


comm_log = CommLog()


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(kind: str, payload: torch.Tensor,
           result: Optional[torch.Tensor] = None) -> None:
    """One collective of `kind` sending `payload` and leaving `result`
    (`payload` where that is the same size) in `comm_log`."""
    comm_log.calls[kind] += 1
    comm_log.bytes[kind] += _nbytes(payload)
    comm_log.out_bytes[kind] += _nbytes(payload if result is None
                                        else result)


# torch >= 2.13 names the two tensor collectives *_single
_all_gather_1 = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_1 = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """The reduction of `x` over the ranks of `axes` (each in turn), as a
    new tensor; `x` is left as it is."""
    out = x.contiguous().clone()
    for a in _axes(axes):
        if axis_size(mesh, a) > 1:
            _count("all_reduce" if op == "sum" else f"all_reduce_{op}", out)
            dist.all_reduce(out, op=_OPS[op], group=_group(mesh, a))
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of `axis`'s ranks concatenated along `dim`, in the axis's
    coordinate order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    buf = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", src, buf)
    _all_gather_1(buf, src, group=_group(mesh, axis))
    return buf.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of `x` over `axis`'s ranks, cut along `dim` into one block a
    rank: this rank's block."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    check_divisible(x.shape[dim], n, f"dim {dim} of {tuple(x.shape)}")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce_scatter", src, out)
    _reduce_scatter_1(out, src, group=_group(mesh, axis))
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Tiled all-to-all along `dim` over `axis`: `x` cut into one block a
    rank, block j sent to the rank at coordinate j, the received blocks
    concatenated in coordinate order (`jax.lax.all_to_all(x, axis, dim,
    dim, tiled=True)`)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    check_divisible(x.shape[dim], n, f"dim {dim} of {tuple(x.shape)}")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty_like(src)
    _count("all_to_all", src)
    dist.all_to_all_single(out, src, group=_group(mesh, axis))
    return out.movedim(0, dim)


def ring_group(mesh, axes):
    """(process group, this rank's position, ring size) of the ring over
    `axes`: one mesh axis (its group), or every axis of a mesh laid over
    the whole world in rank order (the world group, the position the
    flat coordinate).  Other sets of axes raise."""
    axes = _axes(axes)
    me, p = coordinate(mesh, axes)
    if len(axes) == 1:
        return _group(mesh, axes[0]), me, p
    if (axes == axis_names(mesh)
            and mesh.mesh.flatten().tolist()
            == list(range(dist.get_world_size()))):
        return dist.group.WORLD, me, p
    raise ValueError(f"a ring over {axes} of a mesh {axis_names(mesh)} "
                     f"that is not the whole world in rank order")


def ring_shift(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """One step of the ring over `axes` (`ring_group`): `x` sent to the
    next rank, (me + 1) % P, the previous rank's returned (the
    reference's `lax.ppermute` with perm [(j, j + 1 mod P)]).  An
    `all_to_all_single` whose one nonzero split goes to the next rank
    and comes from the previous one; counted as "collective-permute", the
    reference's name.  A backend that refuses it raises."""
    group, me, p = ring_group(mesh, axes)
    if p == 1:
        return x
    src = x.contiguous()
    out = torch.empty_like(src)
    rows = src.shape[0]
    send = [0] * p
    recv = [0] * p
    send[(me + 1) % p] = rows
    recv[(me - 1) % p] = rows
    _count("collective-permute", src)
    dist.all_to_all_single(out, src, recv, send, group=group)
    return out


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The block of the rank at coordinate `src` of `axis`, on every rank
    of the axis (a new tensor; `x` of the others only gives the shape)."""
    out = x.contiguous().clone()
    if axis_size(mesh, axis) == 1:
        return out
    g = _group(mesh, axis)
    _count("broadcast", out)
    dist.broadcast(out, src=dist.get_global_rank(g, src), group=g)
    return out


def reduce(x: torch.Tensor, mesh, axis: str, dst: int) -> torch.Tensor:
    """The sum of `x` over `axis`'s ranks, valid on the rank at coordinate
    `dst` (a new tensor)."""
    out = x.contiguous().clone()
    if axis_size(mesh, axis) == 1:
        return out
    g = _group(mesh, axis)
    _count("reduce", out)
    dist.reduce(out, dst=dist.get_global_rank(g, dst), group=g)
    return out


def barrier(mesh) -> None:
    """Every rank of `mesh` has arrived: an all-reduce over each axis in
    turn (each rank's peers along the last axis had heard from all of
    theirs)."""
    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    all_reduce(torch.ones((), device=dev), mesh, axis_names(mesh))


# ---------------------------------------------------------------------------
# Autograd faces
# ---------------------------------------------------------------------------
class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_to_all(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # the inverse exchange: each block goes back to the rank it came from
        return _all_to_all(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _LayerFrom(torch.autograd.Function):
    """Layer `li` of a stack whose dim 0 is sharded over `axis`: broadcast
    from its owner forward, its gradient summed onto the owner backward.
    Every rank passes all of its local layers, so the node runs (and its
    collective with it) on every rank."""

    @staticmethod
    def forward(ctx, mesh, axis, owner, mine, *views):
        ctx.mesh, ctx.axis, ctx.owner, ctx.mine = mesh, axis, owner, mine
        ctx.n = len(views)
        src = views[mine] if mine is not None else views[0]
        return broadcast(src, mesh, axis, owner)

    @staticmethod
    def backward(ctx, g):
        g = reduce(g, ctx.mesh, ctx.axis, ctx.owner)
        grads = [None] * ctx.n
        if ctx.mine is not None:
            grads[ctx.mine] = g
        return (None, None, None, None, *grads)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over `axes`' ranks forward, identity backward (Megatron's g)."""
    return _ReduceFrom.apply(x, mesh, _axes(axes))


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity forward, gradient summed over `axes`' ranks backward
    (Megatron's f)."""
    return _CopyTo.apply(x, mesh, _axes(axes))


def all_to_all(x: torch.Tensor, mesh, axis: str,
               split_dim: int = 0) -> torch.Tensor:
    """The tiled all-to-all of `x` along `split_dim` over `axis` (block j
    to the rank at coordinate j, the blocks received concatenated in
    coordinate order); backward, the inverse exchange."""
    return _AllToAll.apply(x, mesh, axis, split_dim)


def gather_view(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather along `dim` over `axis` forward, reduce-scatter back."""
    return _Gather.apply(x, mesh, axis, dim)


def scatter_view(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Reduce-scatter along `dim` over `axis` forward, all-gather back."""
    return _Scatter.apply(x, mesh, axis, dim)


def compute_view(p, mesh, batch: tuple, skip_dim0: bool = False):
    """The block of parameter `p` (DTensor or plain) that this rank
    computes with: gathered over the batch axes that shard it (FSDP),
    kept local on the others (tensor parallel).  Backward, its gradient
    is reduce-scattered over the axes it was gathered on and summed over
    the other batch axes, whose ranks saw other rows of the batch (the
    data-parallel sum).  `skip_dim0` leaves a dim 0 sharded over one
    batch axis to `layer_views`."""
    if p is None:
        return None
    x, gathered = local(p), set()
    for axis, d in sharded_dims(p):
        if axis in batch and not (skip_dim0 and d == 0):
            x = gather_view(x, mesh, axis, d)
            gathered.add(axis)
        elif axis in batch:
            gathered.add(axis)
    rest = tuple(a for a in batch if a not in gathered)
    return copy_to(x, mesh, rest) if rest else x


def _layer_axis(p, batch) -> Optional[str]:
    """The one batch axis that shards dim 0 of the stack `p`, if any."""
    axes = [a for a, d in sharded_dims(p) if d == 0 and a in batch]
    return axes[0] if len(axes) == 1 else None


def layer_views(stacks: dict, mesh, batch: tuple) -> list:
    """Per-layer compute blocks of stacked (L, ...) weights, as a list of
    L callables, each returning one layer's dict.  A stack whose dim 0 is
    sharded over a batch axis (FSDP over layers) is gathered a layer at a
    time by a broadcast from the layer's owner, when the callable runs;
    the others go through `compute_view` whole, then `unbind`."""
    n = next(v.shape[0] for v in stacks.values() if v is not None)
    cols: dict = {}
    for k, p in stacks.items():
        if p is None:
            cols[k] = None
            continue
        axis = _layer_axis(p, batch)
        view = compute_view(p, mesh, batch, skip_dim0=axis is not None)
        if axis is None:
            cols[k] = view.unbind(0)
        else:
            per = view.shape[0]
            me = mesh.get_local_rank(axis)
            cols[k] = (axis, per, me, view.unbind(0))

    def one(li):
        out = {}
        for k, c in cols.items():
            if c is None or not isinstance(c[0], str):
                out[k] = None if c is None else c[li]
                continue
            axis, per, me, views = c
            owner = li // per
            out[k] = _LayerFrom.apply(mesh, axis, owner,
                                      li - owner * per if owner == me
                                      else None, *views)
        return out

    return [(lambda li=li: one(li)) for li in range(n)]
