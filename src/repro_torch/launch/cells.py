"""Cell builder: (arch, shape, mesh) -> the rank's step function and its
arguments' global shapes, dtypes and specs (port of
`repro.launch.cells`).

A *cell* is one dry-run unit: the step a production job would run for
that architecture and input shape.  The reference jits it under GSPMD;
here it is the program of one rank of an SPMD mesh (`DeviceMesh` over a
process group, one process a rank), and every collective it needs is
explicit.  Each argument is a tree of meta tensors (global shape and
dtype, no storage: the reference's ShapeDtypeStructs) with a matching
tree of `utils.sharding.P` specs (None: replicated); `Cell.rank_args`
lays whole tensors out as this rank's blocks (`shard_leaf`: a DTensor
where a spec shards a leaf).  The model code takes a batch laid out so:
`ShardCtx.batch_rows` and DIN's row pick read the local block of a
DTensor already laid out as they ask.  `launch/dryrun.py` runs rank 0's
step on meta tensors over a fake process group; `roofline/` reads the
counts.

Family mapping:
  lm     train_4k -> fwd+bwd+AdamW over FSDP("data") x TP("model")
         parameters, micro-batches summed in f32 (the reference's
         accumulation scan); prefill_32k -> serve_prefill;
         decode_* -> decode_step (kv_mode "auto" -> "head" / "seq")
  gnn    all shapes -> train step on the shape's (padded) graph: edges
         and triplets over every mesh axis, node arrays too (padded so
         they divide), the state replicated; `gnn_rank_loss`
  recsys train_batch -> train step (ZeRO-1 moments); serve_* ->
         forward_scores; retrieval_cand -> retrieval cascade (l2
         shortlist + DIN re-rank)

The GNN rank program (the reference leaves it to GSPMD): the node
features (and DimeNet's edge messages) stay in row blocks, and every
gather or sum at global ids goes through the models' `gather_fn` /
`scatter_fn` hooks: the ring (`models.gnn.ring_gather`) where the
reference's gates take it (`RING_*`), else the whole table all-gathered
and taken, or the local sum reduce-scattered into row blocks.  `pos`
(and DimeNet's `species`) are gathered whole (`full_tensor`, counted);
`species` and `graph_ids` of NequIP, MACE and the node arrays of
GraphCast are this rank's row block.  Per-graph energies (GraphCast's
masked error sums) are this rank's partial sums, added by `reduce_from`
before the loss; the replicated state's gradients are this rank's
shares, summed in one all-reduce before AdamW.  `ring_hooks` always
takes the ring (tests and the card's smoke reach it below the gates).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..configs.base import ShapeSpec, pad_to_multiple
from ..configs.registry import get_arch
from ..models.gnn.common import scatter_rows, take_rows
from ..models.gnn.ring_gather import ring_gather, ring_scatter_add
from ..models.transformer import (LMConfig, ShardCtx, cache_len_for,
                                  cache_specs, decode_step, lm_loss,
                                  lm_param_shapes, lm_param_specs,
                                  serve_prefill)
from ..train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                               opt_state_specs)
from ..train.trainer import loss_and_grads
from ..utils import sharding
from ..utils.sharding import P, axis_names, local
from ..utils.tree import leaves, tree_map, unflatten

F32, I32 = torch.float32, torch.int32
META = torch.device("meta")

# the reference's ring gates (cells.py:358-423), on global sizes
RING_GATHER_ROWS = 1_000_000         # gnn_gather: table rows
RING_SCATTER_ELEMS = 100_000_000     # gnn_scatter: rows x width
RING_PAIR_ROWS = 1_000_000           # DimeNet's gather and scatter: rows


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable                  # the rank's step, positional args
    args: tuple                   # meta-tensor trees: global shape, dtype
    specs: tuple                  # P trees matching args (None: replicated)
    model_flops: float            # useful-FLOPs estimate (MODEL_FLOPS)
    comment: str = ""
    donate: tuple = ()            # donated arg indices (state / KV caches)

    def rank_args(self, mesh, values: Optional[tuple] = None) -> tuple:
        """This rank's arguments: `values` (whole tensors in the trees of
        `args`, the same on every rank; default the meta tensors
        themselves) laid out by the specs."""
        return sharding.shard_tree(self.args if values is None else values,
                                   self.specs, mesh)


class _ShapeDtype:
    def __init__(self, x):
        self.shape, self.dtype = tuple(x.shape), x.dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _meta_like(make: Callable):
    """The tree that `make()` returns, as meta tensors, without computing
    it (the reference's `jax.eval_shape`)."""
    with FakeTensorMode():
        tree = tree_map(_ShapeDtype, make())
    return tree_map(lambda s: _meta(s.shape, s.dtype), tree)


def _specs_like(tree, spec):
    """`spec` at every tensor leaf of `tree` (None where it holds None)."""
    return tree_map(lambda _: spec, tree)


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _dp(mesh) -> int:
    return math.prod(sharding.axis_size(mesh, a) for a in _batch_axes(mesh))


def _nmesh(mesh) -> int:
    return sharding.mesh_size(mesh)


def build_cell(arch_id: str, shape_name: str, mesh,
               opt_overrides: Optional[dict] = None) -> Cell:
    mod = get_arch(arch_id)
    shape = mod.SHAPES[shape_name]
    if mod.FAMILY == "lm":
        return _build_lm(mod, shape, mesh, opt_overrides or {})
    if mod.FAMILY == "gnn":
        return _build_gnn(mod, shape, mesh, opt_overrides or {})
    if mod.FAMILY == "recsys":
        return _build_recsys(mod, shape, mesh, opt_overrides or {})
    raise ValueError(mod.FAMILY)


def _state_args(params) -> dict:
    """{"step", "params", "opt"} of meta `params` (the train state)."""
    return {"step": _meta((), I32), "params": params,
            "opt": adamw_init(params)}


def _adamw_step(opt_cfg, state, g):
    """AdamW on the donated state, in place; (state, metrics)."""
    _, _, om = adamw_update(opt_cfg, g, state["opt"], state["params"],
                            inplace=True)
    state["step"].add_(1)
    return state, om


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_params_meta(cfg: LMConfig, dtype) -> dict:
    def one(shape):
        return None if shape is None else _meta(shape, dtype)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return one(t)

    return walk(lm_param_shapes(cfg))


def _lm_flops(cfg: LMConfig, tokens: int, seq: int, train: bool) -> float:
    """6*N_active*D (+ causal attention term) for train; 2*N*D for fwd."""
    n_act = cfg.n_active_params()
    mult = 6.0 if train else 2.0
    core = mult * n_act * tokens
    # attention scores+values: 2 * 2 * S_eff * H * dh per token (x3 for bwd)
    s_eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    attn = (2 if not train else 6) * 2 * tokens * (s_eff / 2) \
        * cfg.n_heads * cfg.d_head * cfg.n_layers
    return core + attn


def _micro(x, i: int, accum: int):
    """Micro-batch i of `accum` of this rank's rows of the global batch
    `x`, laid out as `x` is (a DTensor of those rows where `x` is one)."""
    if accum == 1:
        return x
    rows = local(x)
    part = rows.reshape((accum, -1) + tuple(rows.shape[1:]))[i]
    if not isinstance(x, DTensor):
        return part
    shape = (x.shape[0] // accum,) + tuple(x.shape[1:])
    return DTensor.from_local(part, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device=META).stride())


def _build_lm(mod, shape: ShapeSpec, mesh, opt_over) -> Cell:
    cfg: LMConfig = mod.model_config()
    ctx = ShardCtx(mesh=mesh)
    ba = _batch_axes(mesh)
    dp = _dp(mesh)
    b = shape.global_batch
    rows_split = b % max(dp, 1) == 0 and b >= dp
    batch_spec = P(ba, None) if rows_split else P(None, None)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(**opt_over) if opt_over else AdamWConfig()
        # 2D FSDP("data") x TP("model") parameter layout: params, grads and
        # AdamW moments all fully sharded (ZeRO-3-style memory)
        p_specs = lm_param_specs(cfg, ctx, fsdp_axis="data")
        state_specs = {"step": P(), "params": p_specs,
                       "opt": opt_state_specs(p_specs, zero1=False)}
        state = _state_args(_lm_params_meta(cfg, F32))
        accum = max(getattr(mod, "TRAIN_ACCUM", shape.accum), 1)

        def loss_fn(p, bt):
            return lm_loss(p, cfg, bt[0], bt[1], ctx)

        def train_step(state, tokens, labels):
            # the micro-batches' gradients summed in f32, as the
            # reference's scan: each micro-batch this rank's share of it
            g = loss = None
            for i in range(accum):
                l_i, _, g_i = loss_and_grads(
                    loss_fn, state["params"],
                    (_micro(tokens, i, accum), _micro(labels, i, accum)))
                if g is None:
                    g, loss = tree_map(lambda x: x.float(), g_i), l_i
                else:
                    for a, c in zip(leaves(g), leaves(g_i)):
                        a.add_(c.float())
                    loss = loss + l_i
                del g_i
            if accum > 1:
                g = tree_map(lambda x: x / accum, g)
                loss = loss / accum
            state, om = _adamw_step(opt_cfg, state, g)
            return state, {"loss": loss, **om}

        tok = _meta((b, shape.seq_len), I32)
        return Cell(mod.ARCH_ID, shape.name, "train", train_step,
                    (state, tok, tok), (state_specs, batch_spec, batch_spec),
                    _lm_flops(cfg, b * shape.seq_len, shape.seq_len, True),
                    donate=(0,))

    # serving holds parameters in bf16 (standard practice; halves HBM)
    p_specs = lm_param_specs(cfg, ctx)
    params = _lm_params_meta(cfg, torch.bfloat16)

    if shape.kind == "prefill":
        def prefill(params, tokens):
            return serve_prefill(params, cfg, tokens, ctx)
        tok = _meta((b, shape.seq_len), I32)
        return Cell(mod.ARCH_ID, shape.name, "prefill", prefill,
                    (params, tok), (p_specs, batch_spec),
                    _lm_flops(cfg, b * shape.seq_len, shape.seq_len, False))

    # decode
    kv_mode = shape.kv_mode
    if kv_mode == "auto":
        kv_mode = "head" if cfg.n_kv_heads % ctx.tp == 0 else "seq"
    sc = cache_len_for(cfg, shape.seq_len)
    ck_spec, cv_spec, len_spec = cache_specs(cfg, ctx, kv_mode)
    if b < dp:  # batch=1 cells: batch dim replicated
        ck_spec = P(None, *list(ck_spec)[1:])
        cv_spec = ck_spec
    cache = (_meta((cfg.n_layers, b, sc, cfg.n_kv_heads, cfg.d_head),
                   cfg.compute_dtype),) * 2 + (_meta((b,), I32),)

    def decode(params, tokens, positions, caches):
        # the plain decode attention: no kernel launches on meta tensors
        return decode_step(params, cfg, tokens, positions,
                           tuple(local(c) for c in caches), kv_mode,
                           backend="ref", ctx=ctx)

    tok_spec = P(ba, None) if b >= dp else P(None, None)
    pos_spec = P(ba) if b >= dp else P(None)
    # decode model-flops: one token per sequence + KV-cache attention reads
    n_act = cfg.n_active_params()
    attn = 2 * 2 * b * sc * cfg.n_heads * cfg.d_head * cfg.n_layers
    return Cell(mod.ARCH_ID, shape.name, "decode", decode,
                (params, _meta((b, 1), I32), _meta((b,), I32), cache),
                (p_specs, tok_spec, pos_spec, (ck_spec, cv_spec, len_spec)),
                2.0 * n_act * b + attn,
                comment=f"kv_mode={kv_mode} cache_len={sc}", donate=(3,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def _gnn_sizes(shape: ShapeSpec, mesh):
    nd = _nmesh(mesh)
    if shape.name == "minibatch_lg":
        from ..models.gnn.sampler import expected_sizes
        n, e = expected_sizes(shape.batch_nodes, list(shape.fanout))
    elif shape.name == "molecule":
        n = shape.n_nodes * shape.batch_graphs
        e = shape.n_edges * shape.batch_graphs
    else:
        n, e = shape.n_nodes, shape.n_edges
    n_pad = pad_to_multiple(n, 2 * nd)
    # 16*nd: keeps every edge-chunk slice (graphcast edge_chunks<=16)
    # aligned with the all-axes edge sharding
    e_pad = pad_to_multiple(e, 16 * nd)
    return n_pad, e_pad


def _gnn_batch_sds(arch_id: str, shape: ShapeSpec, mesh, cfg) -> dict:
    n, e = _gnn_sizes(shape, mesh)
    ng = shape.batch_graphs if shape.name == "molecule" else 1
    d_feat = shape.d_feat if shape.d_feat else 16
    base = {"edge_src": _meta((e,), I32), "edge_dst": _meta((e,), I32)}
    if arch_id == "graphcast":
        base["node_feat"] = _meta((n, d_feat), F32)
        base["edge_feat"] = _meta((e, cfg.d_edge), F32)
        base["targets"] = _meta((n, cfg.n_vars), F32)
        base["node_mask"] = _meta((n,), F32)
    else:
        base["species"] = _meta((n,), I32)
        base["pos"] = _meta((n, 3), F32)
        base["graph_ids"] = _meta((n,), I32)
        base["energy"] = _meta((ng,), F32)
        if arch_id == "dimenet":
            t = pad_to_multiple(4 * e, _nmesh(mesh))
            base["tri_in"] = _meta((t,), I32)
            base["tri_out"] = _meta((t,), I32)
    return base


def _gnn_batch_specs(batch_sds: dict, mesh) -> dict:
    """Edges/triplets over every axis; node arrays over the data axes."""
    all_axes = axis_names(mesh)
    ba = _batch_axes(mesh)
    specs = {}
    nd = _nmesh(mesh)
    for k, v in batch_sds.items():
        rest = [None] * (v.dim() - 1)
        if k.startswith(("edge_", "tri_")):
            specs[k] = P(all_axes, *rest)
        elif k == "energy":
            specs[k] = P(None)
        elif v.shape[0] % nd == 0:
            # node arrays: all axes when divisible (padded that way)
            specs[k] = P(all_axes, *rest)
        else:
            specs[k] = P(ba, *rest)
    return specs


def _gnn_flops(arch_id: str, cfg, n: int, e: int, t: int = 0) -> float:
    """Per-edge/node MAC counts from the config dims (x2 MACs, x3 train)."""
    if arch_id == "graphcast":
        h = cfg.d_hidden
        per_edge = 3 * h * h + h * h        # edge MLP (2 layers) approx
        per_node = 2 * h * h + h * h
        enc = n * (cfg.d_feat * h + h * h) + e * (cfg.d_edge * h + h * h)
        dec = n * (h * h + h * cfg.n_vars)
        return 6.0 * (cfg.n_layers * (e * per_edge + n * per_node) + enc + dec)
    if arch_id in ("nequip", "mace"):
        # per path (l1,l2,l3): radial MLP MACs + CG contraction ~27 mults/C
        c = cfg.channels
        paths = 15  # l<=2 CG paths
        per_edge = 2 * paths * (cfg.n_rbf * cfg.radial_hidden
                                + cfg.radial_hidden * c + 27 * c)
        n_mix = 3 if arch_id == "nequip" else (1 + 2 * paths)
        per_node = 2 * n_mix * 9 * c * c
        return 6.0 * cfg.n_layers * (e * per_edge + n * per_node)
    if arch_id == "dimenet":
        h = cfg.d_hidden
        per_tri = h * cfg.n_bilinear * (1 + h)
        per_edge = 2 * h * h
        return 6.0 * cfg.n_blocks * (t * per_tri + e * per_edge)
    raise ValueError(arch_id)


def ring_hooks(mesh):
    """(gather_fn, scatter_fn) that always take the ring over all of the
    mesh's axes: the table and the result in row blocks."""
    axes = axis_names(mesh)
    p = sharding.mesh_size(mesh)

    def gather(table, ix):
        return ring_gather(table, ix, mesh, axes)

    def scatter(vals, ix, rows):
        sharding.check_divisible(rows, p, "ring scatter rows")
        return ring_scatter_add(vals, ix, mesh, axes, rows // p)

    return gather, scatter


def plain_hooks(mesh):
    """(gather_fn, scatter_fn) without the ring: the row blocks gathered
    whole over every axis (innermost first) and taken at the ids; the
    whole local sum reduce-scattered into row blocks (outermost axis
    first).  Both differentiable (all-gather <-> reduce-scatter)."""
    axes = axis_names(mesh)

    def gather(table, ix):
        for a in reversed(axes):
            table = sharding.gather_view(table, mesh, a, 0)
        return take_rows(table, ix)

    def scatter(vals, ix, rows):
        out = scatter_rows(vals, ix, rows)
        for a in axes:
            out = sharding.scatter_view(out, mesh, a, 0)
        return out

    return gather, scatter


def gated_hooks(arch_id: str, mesh):
    """The cells' hooks: the ring where the reference's gates take it for
    `arch_id` (sizes global: a table block's rows times the ranks), the
    plain hooks elsewhere; GraphCast never takes the ring."""
    p = sharding.mesh_size(mesh)
    ring_g, ring_s = ring_hooks(mesh)
    plain_g, plain_s = plain_hooks(mesh)
    pair = arch_id == "dimenet"

    def gather(table, ix):
        rows = table.shape[0] * p
        if arch_id != "graphcast" and rows >= (RING_PAIR_ROWS if pair
                                               else RING_GATHER_ROWS):
            return ring_g(table, ix)
        return plain_g(table, ix)

    def scatter(vals, ix, rows):
        big = (rows >= RING_PAIR_ROWS if pair
               else rows * vals[0].numel() >= RING_SCATTER_ELEMS)
        if arch_id != "graphcast" and rows % p == 0 and big:
            return ring_s(vals, ix, rows)
        return plain_s(vals, ix, rows)

    return gather, scatter


def _rows_over(x, axes) -> None:
    """`x` must be a DTensor split over exactly `axes` on dim 0."""
    got = tuple(a for a, d in sharding.sharded_dims(x) if d == 0)
    if got != tuple(axes):
        raise ValueError(f"a node array split over {got}, not over every "
                         f"mesh axis {tuple(axes)}: pad the nodes to a "
                         f"multiple of the mesh")


def gnn_rank_loss(arch_id: str, mod, cfg, mesh, hooks) -> Callable:
    """loss_fn(params, batch) -> (loss, {}) of one rank of the GNN cells'
    program (module docstring): `batch` laid out by `_gnn_batch_specs`,
    `params` replicated, `hooks` (gather_fn, scatter_fn) the mesh's.
    The loss is the global one on every rank; each parameter's gradient
    is this rank's share (`sum_grads` adds them)."""
    axes = axis_names(mesh)
    gather_fn, scatter_fn = hooks

    def loss_fn(params, batch):
        bt = {k: local(v) for k, v in batch.items()}
        node = "node_feat" if arch_id == "graphcast" else "species"
        _rows_over(batch[node], axes)
        n_nodes = batch[node].shape[0]
        if arch_id == "graphcast":
            pred = mod.forward(params, cfg, bt, gather_fn=gather_fn,
                               scatter_fn=scatter_fn, n_nodes=n_nodes)
            err = (pred.float() - bt["targets"]) ** 2
            w = bt["node_mask"][:, None]
            sums = sharding.reduce_from(
                torch.stack([(err * w).sum(), w.sum()]), mesh, axes)
            return sums[0] / torch.clamp(sums[1] * cfg.n_vars, min=1.0), {}
        bt["pos"] = sharding.full_tensor(batch["pos"])
        if arch_id == "dimenet":
            bt["species"] = sharding.full_tensor(batch["species"])
            e = mod.forward(params, cfg, bt, gather_fn=gather_fn,
                            scatter_fn=scatter_fn,
                            n_edges=batch["edge_src"].shape[0])
        else:
            e = mod.forward_energy(params, cfg, bt, gather_fn=gather_fn,
                                   scatter_fn=scatter_fn, n_nodes=n_nodes)
        e = sharding.reduce_from(e, mesh, axes)
        return torch.mean((e - bt["energy"].float()) ** 2), {}

    return loss_fn


def sum_grads(grads, mesh):
    """Each rank's gradient shares summed over the whole mesh: one
    all-reduce of the leaves laid end to end (one a mesh axis)."""
    gs = leaves(grads)
    flat = sharding.all_reduce(torch.cat([g.reshape(-1) for g in gs]), mesh,
                               axis_names(mesh))
    out, at = [], 0
    for g in gs:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return unflatten(grads, out)


def gnn_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, mesh):
    """The GNN cells' step (state, batch) -> (state, metrics): a rank
    loss (`gnn_rank_loss`), its gradient shares summed (`sum_grads`),
    AdamW on the donated replicated state."""
    def train_step(state, batch):
        loss, _, g = loss_and_grads(loss_fn, state["params"], batch)
        state, om = _adamw_step(opt_cfg, state, sum_grads(g, mesh))
        return state, {"loss": loss, **om}

    return train_step


def _gnn_model(arch_id: str, mod, shape: ShapeSpec, mesh):
    """(model module, config) of a GNN cell."""
    if arch_id == "graphcast":
        from ..models.gnn import graphcast as m
        d_feat = shape.d_feat if shape.d_feat else 16
        _, e_est = _gnn_sizes(shape, mesh)
        return m, mod.model_config(d_feat=d_feat,
                                   edge_chunks=16 if e_est > 4_000_000 else 1)
    if arch_id == "nequip":
        from ..models.gnn import nequip as m
    elif arch_id == "mace":
        from ..models.gnn import mace as m
    else:
        from ..models.gnn import dimenet as m
    return m, mod.model_config()


def _build_gnn(mod, shape: ShapeSpec, mesh, opt_over) -> Cell:
    arch_id = mod.ARCH_ID
    m, cfg = _gnn_model(arch_id, mod, shape, mesh)
    loss_fn = gnn_rank_loss(arch_id, m, cfg, mesh, gated_hooks(arch_id, mesh))
    opt_cfg = AdamWConfig(**opt_over) if opt_over else AdamWConfig()
    batch_sds = _gnn_batch_sds(arch_id, shape, mesh, cfg)
    batch_specs = _gnn_batch_specs(batch_sds, mesh)
    params = _meta_like(lambda: m.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    state = _state_args(params)
    state_specs = _specs_like(state, P())
    train_step = gnn_train_step(loss_fn, opt_cfg, mesh)
    n, e = _gnn_sizes(shape, mesh)
    t = batch_sds.get("tri_in")
    flops = _gnn_flops(arch_id, cfg, n, e, t.shape[0] if t is not None else 0)
    return Cell(arch_id, shape.name, "train", train_step,
                (state, batch_sds), (state_specs, batch_specs),
                flops, comment=f"n={n} e={e}", donate=(0,))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------
def _din_batch_sds(cfg, b: int) -> dict:
    s = cfg.seq_len
    return {"hist_items": _meta((b, s), I32),
            "hist_cates": _meta((b, s), I32),
            "hist_len": _meta((b,), I32),
            "target_item": _meta((b,), I32),
            "target_cate": _meta((b,), I32),
            "label": _meta((b,), F32)}


def _din_flops(cfg, b: int, train: bool) -> float:
    d = cfg.d_feat
    attn = cfg.seq_len * (4 * d * cfg.attn_mlp[0]
                          + cfg.attn_mlp[0] * cfg.attn_mlp[1] + cfg.attn_mlp[1])
    mlp = 3 * d * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1]
    return (6.0 if train else 2.0) * b * (attn + mlp)


def _build_recsys(mod, shape: ShapeSpec, mesh, opt_over) -> Cell:
    from ..models.recsys import din as m
    cfg = mod.model_config()
    ba = _batch_axes(mesh)
    dp = _dp(mesh)
    b = shape.batch
    mdl = "model"
    p_specs = m.param_specs(cfg, mesh, mdl)
    params = m._skeleton(cfg).param_tree()
    params = tree_map(lambda x: _meta(x.shape, x.dtype), params)
    batch_sds = _din_batch_sds(cfg, b)
    rows_split = b % max(dp, 1) == 0 and b >= dp
    row = ba if rows_split else None
    batch_specs = {k: P(row, *([None] * (v.dim() - 1)))
                   for k, v in batch_sds.items()}
    bx = ba if rows_split else ()

    if shape.kind == "train":
        opt_cfg = AdamWConfig(**opt_over) if opt_over else AdamWConfig()
        o_specs = opt_state_specs(p_specs, zero1=True, params_shapes=params,
                                  mesh=mesh)
        state_specs = {"step": P(), "params": p_specs, "opt": o_specs}

        def loss_fn(p, bt):
            return m.loss_fn(p, cfg, bt, mesh, mdl, bx), {}

        def train_step(state, batch):
            loss, _, g = loss_and_grads(loss_fn, state["params"], batch)
            state, om = _adamw_step(opt_cfg, state, g)
            return state, {"loss": loss, **om}

        return Cell(mod.ARCH_ID, shape.name, "train", train_step,
                    (_state_args(params), batch_sds),
                    (state_specs, batch_specs),
                    _din_flops(cfg, b, True), donate=(0,))

    if shape.kind == "serve":
        def serve(params, batch):
            with torch.no_grad():
                return m.forward_scores(params, cfg, batch, mesh, mdl, bx)
        return Cell(mod.ARCH_ID, shape.name, "serve", serve,
                    (params, batch_sds), (p_specs, batch_specs),
                    _din_flops(cfg, b, False))

    # retrieval_cand: the candidate set is the item table itself; using all
    # n_items (= 2^20 >= the 10^6 cell spec) keeps the slice shard-aligned
    n_cand = cfg.n_items

    def retrieval(params, batch):
        # the plain shortlist (the reference's backend="ref"): no kernel
        # launches on meta tensors
        with torch.no_grad():
            return m.retrieval_step(params, cfg, batch, n_cand, k=100,
                                    mesh=mesh, model_axis=mdl, batch_axes=bx,
                                    backend="ref")
    shortlist = 2.0 * b * n_cand * cfg.embed_dim
    rerank = _din_flops(cfg, b * cfg.rerank_k, False)
    return Cell(mod.ARCH_ID, shape.name, "retrieval", retrieval,
                (params, batch_sds), (p_specs, batch_specs),
                shortlist + rerank, comment=f"n_cand={n_cand}")
