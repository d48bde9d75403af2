"""GraphCast-style encoder-processor-decoder mesh GNN [arXiv:2212.12794]
(port of `repro.models.gnn.graphcast`).

The assigned config (16 processor layers, d_hidden=512, sum aggregation,
n_vars=227) runs on whatever graph the shape cell provides (the benchmark
shapes are generic graphs; the icosahedral mesh refinement belongs to the
weather pipeline, which is out of scope -- the *architecture* is the
encoder + 16 interaction-network processor blocks + decoder).

Each processor block is a standard interaction network:
  e' = e + MLP([e, x_src, x_dst])          (edge update)
  x' = x + MLP([x, sum_{e into v} e'])     (node update, sum aggregation)

The processor's parameters are stacked over layers (a leading (L,) axis,
the reference's `_stack` layout), and each layer runs under
`torch.utils.checkpoint` as the reference's `jax.checkpoint` body under
its layer scan.  The reference's `_residual_barrier` (an XLA
`optimization_barrier` that pins GSPMD's saved residuals) and
`constrain_fn` (sharding constraints) have no torch counterpart on one
device and are not ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..._device import resolve_device
from ...core.distances import f32_matmul
from ...utils.tree import tree_map
from .common import (check_depth, edge_mask, gather_src_dst, init_mlp,
                     mlp_apply, scatter_to_nodes, tree_from_numpy)


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227           # output variables per node
    d_feat: int = 227           # input features per node (grid vars)
    d_edge: int = 8
    aggregator: str = "sum"
    mlp_layers: int = 2
    dtype: str = "float32"      # activation dtype ("bfloat16" for big cells)
    edge_chunks: int = 1        # run the edge update in chunks (memory
                                # lever for 10^7..10^8-edge full-batch cells)


def init_params(cfg: GraphCastConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree and scales (weights N(0, 1/d_in), zero biases,
    f32), drawn from `generator` in the reference's key order, on
    `device` (None means the CUDA device)."""
    dev = resolve_device(device)
    h = cfg.d_hidden
    params = {
        "enc_node": init_mlp(generator, [cfg.d_feat, h, h], dev),
        "enc_edge": init_mlp(generator, [cfg.d_edge, h, h], dev),
        "dec_node": init_mlp(generator, [h, h, cfg.n_vars], dev),
    }
    edge, node = [], []
    for _ in range(cfg.n_layers):
        edge.append(init_mlp(generator, [3 * h, h, h], dev))
        node.append(init_mlp(generator, [2 * h, h, h], dev))
    params["layers"] = {"edge_mlp": _stack(edge), "node_mlp": _stack(node)}
    return params


def params_from_jax(tree: dict, cfg: GraphCastConfig, device=None) -> dict:
    """The port's tree from the reference's `init_params` tree (numpy
    arrays), float32 on `device`, in the same stacked layout."""
    check_depth(cfg.name, tree["layers"]["edge_mlp"]["w"][0].shape[0],
                cfg.n_layers)
    return tree_from_numpy(tree, device)


def _stack(mlps: list) -> dict:
    return tree_map(lambda *xs: torch.stack(xs), *mlps)


def forward(params, cfg: GraphCastConfig, batch, gather_fn=None,
            scatter_fn=None, n_nodes=None) -> torch.Tensor:
    """batch: node_feat (N, d_feat), edge_src/dst (E,), edge_feat (E,
    d_edge).  Returns per-node predictions (N, n_vars) in cfg.dtype.

    gather_fn(table, idx) / scatter_fn(values, idx, rows), with
    `n_nodes` the node count the edge ids index: the hooks of a mesh
    (`launch.cells`' GNN rank program: node arrays this rank's row block,
    edges this rank's block of global ids; the source and destination
    rows in one gather a layer, the sum aggregation through the
    scatter).  None keeps the single-device path."""
    n = batch["node_feat"].shape[0]
    n_all = n if n_nodes is None else n_nodes
    dt = getattr(torch, cfg.dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    mask = edge_mask(src)
    nc = cfg.edge_chunks
    e_total = src.shape[0]
    if e_total % nc:
        raise ValueError(f"{e_total} edges do not split into {nc} chunks")
    if scatter_fn is not None and cfg.aggregator != "sum":
        raise ValueError(f"a scatter_fn sums; aggregator "
                         f"{cfg.aggregator!r}")

    def chunk(e_c, xs, xd, mlp):
        return e_c + mlp_apply(mlp, torch.cat([e_c, xs, xd], -1))

    def ends(x):
        if gather_fn is None:
            return gather_src_dst(x, src, dst)
        return gather_fn(x, torch.cat([src, dst])).split(e_total)

    def aggregate(e):
        if scatter_fn is None:
            return scatter_to_nodes(e, dst, n, mask, agg=cfg.aggregator)
        return scatter_fn(torch.where(mask[:, None], e, 0.0),
                          torch.where(mask, dst, -1), n_all)

    def body(x, e, lp):
        xs, xd = ends(x)
        if nc == 1:
            e = chunk(e, xs, xd, lp["edge_mlp"])
        else:
            # edge-chunked update: x is gathered once a layer, then each
            # chunk's edge MLP runs under its own checkpoint
            e = torch.cat([
                checkpoint(chunk, *part, lp["edge_mlp"], use_reentrant=False)
                for part in zip(e.chunk(nc), xs.chunk(nc), xd.chunk(nc))])
        agg = aggregate(e)
        x = x + mlp_apply(lp["node_mlp"], torch.cat([x, agg], -1))
        return x, e

    with f32_matmul():
        x = mlp_apply(params["enc_node"], batch["node_feat"].to(dt))
        e = mlp_apply(params["enc_edge"], batch["edge_feat"].to(dt))
        layers = params["layers"]
        for i in range(layers["edge_mlp"]["w"][0].shape[0]):
            lp = tree_map(lambda a: a[i], layers)
            x, e = checkpoint(body, x, e, lp, use_reentrant=False)
        return mlp_apply(params["dec_node"], x)


def loss_fn(params, cfg: GraphCastConfig, batch) -> torch.Tensor:
    """MSE regression against per-node targets (B-step forecast proxy)."""
    pred = forward(params, cfg, batch)
    return torch.mean((pred.float() - batch["targets"].float()) ** 2)
