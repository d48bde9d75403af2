"""DimeNet: directional message passing with triplet interactions
[arXiv:2003.03123] (port of `repro.models.gnn.dimenet`).

Assigned config: 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6.  Messages live on *edges*; each interaction block updates edge
message m_ji from the messages of incoming edges m_kj using a 2D
spherical-radial basis of (angle kji, distance kj):

  a_SBF(kji)[l, n] = j-ish radial basis(d_kj)[n] * P_l(cos angle)[l]
  m_ji <- MLP(m_ji) + sum_k  W_bilinear . (a_SBF(kji), MLP(m_kj))

Triplet index arrays (edge_in = kj, edge_out = ji) are built host-side
(`build_triplets`, numpy, bitwise the reference's).  Output: per-node
scalar from incoming messages, summed per graph.  Each block runs under
`torch.utils.checkpoint`, as the reference's `jax.checkpoint(block)`;
the reference's `constrain_fn` (sharding constraints) has no counterpart
on one device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..._device import resolve_device
from ...core.distances import f32_matmul
from .common import (bessel_rbf, check_depth, clip_index, edge_mask,
                     edge_vectors, graph_energies, init_mlp, mlp_apply,
                     scatter_rows, take_rows, tree_from_numpy)


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 8


def _legendre(cos_t: torch.Tensor, n: int) -> torch.Tensor:
    """P_0..P_{n-1}(cos) -> (..., n) by recursion."""
    p = [torch.ones_like(cos_t), cos_t]
    for l in range(2, n):
        p.append(((2 * l - 1) * cos_t * p[-1] - (l - 1) * p[-2]) / l)
    return torch.stack(p[:n], dim=-1)


def init_params(cfg: DimeNetConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree and scales, drawn from `generator` in the
    reference's order on `device` (None means the CUDA device)."""
    dev = resolve_device(device)
    h, nb = cfg.d_hidden, cfg.n_bilinear
    params = {
        "embed": torch.randn((cfg.n_species, h), generator=generator,
                             device=generator.device).to(dev) * 0.5,
        "rbf_proj": init_mlp(generator, [cfg.n_radial, h], dev),
        "msg_init": init_mlp(generator, [3 * h, h, h], dev),
        "readout": init_mlp(generator, [h, h, 1], dev),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "msg_mlp": init_mlp(generator, [h, h, h], dev),
            "src_proj": init_mlp(generator, [h, h], dev),
            "sbf_proj": init_mlp(generator,
                                 [cfg.n_radial * cfg.n_spherical, nb], dev),
            "bilinear": torch.randn((nb, h, h), generator=generator,
                                    device=generator.device).to(dev)
            / math.sqrt(h * nb),
        })
    return params


def params_from_jax(tree: dict, cfg: DimeNetConfig, device=None) -> dict:
    """The port's tree from the reference's `init_params` tree (numpy
    arrays), float32 on `device`, in the same layout."""
    check_depth(cfg.name, len(tree["blocks"]), cfg.n_blocks)
    return tree_from_numpy(tree, device)


def bilinear(mk: torch.Tensor, a: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """The reference's einsum("th,tb,bhd->td", mk, a, w) in an explicit
    order: the per-triplet outer product (T, nb * h), then one product
    with w reshaped to (nb * h, d)."""
    t = mk.shape[0]
    outer = (a[:, :, None] * mk[:, None, :]).reshape(t, -1)
    return outer @ w.reshape(-1, w.shape[-1])


def forward(params, cfg: DimeNetConfig, batch, gather_fn=None,
            scatter_fn=None, n_edges=None) -> torch.Tensor:
    """batch: species (N,), pos (N,3), edge_src/dst (E,), tri_in/tri_out
    (T,) edge-index pairs (kj -> ji), graph_ids, energy.  Per-graph
    energies.

    gather_fn(table, idx): row gather for the triplet -> edge-message
    lookup (and the triplets' edge geometry); scatter_fn(values, idx,
    rows): the mirrored triplet -> edge aggregation and the edge -> atom
    sum (-1 dropped).  On a mesh (`launch.cells`' GNN rank program) the
    edges and triplets are this rank's blocks of global ids, species and
    pos whole, graph_ids this rank's row block, `n_edges` the global
    edge count, the hooks the mesh's (the ring, `ring_gather`), and the
    energies this rank's partial sums; None keeps the single-device
    path."""
    take = gather_fn or take_rows
    scat = scatter_fn or scatter_rows
    species = batch["species"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = species.shape[0]
    e = src.shape[0] if n_edges is None else n_edges
    with f32_matmul():
        emask = edge_mask(src)
        unit, r = edge_vectors(batch["pos"], src, dst)
        rbf = bessel_rbf(r, cfg.n_radial, cfg.cutoff) * emask[:, None]

        hs = take_rows(params["embed"], species)
        m = mlp_apply(params["msg_init"], torch.cat(
            [take_rows(hs, src), take_rows(hs, dst),
             mlp_apply(params["rbf_proj"], rbf)], -1))
        m = m * emask[:, None]

        # triplet geometry: angle between edge_in (k->j) and edge_out (j->i)
        ti, to = batch["tri_in"], batch["tri_out"]
        tmask = (ti >= 0) & (to >= 0)
        ti_c = clip_index(ti, e)
        to_c = clip_index(to, e)
        # angle at j: between -unit(k->j) (incoming) and unit(j->i)
        cos_t = torch.clamp(((-take(unit, ti_c)) * take(unit, to_c))
                            .sum(-1), -1.0, 1.0)
        sbf_ang = _legendre(cos_t, cfg.n_spherical)            # (T, n_sph)
        sbf_rad = bessel_rbf(take(r[:, None], ti_c)[:, 0], cfg.n_radial,
                             cfg.cutoff)                       # (T, n_rad)
        sbf = ((sbf_rad[:, :, None] * sbf_ang[:, None, :]).reshape(
            ti.shape[0], -1) * tmask[:, None])
        to_idx = torch.where(tmask, to_c, -1)

        def block(m, bp):
            mk = take(mlp_apply(bp["src_proj"], m), ti_c)     # (T, h)
            a = mlp_apply(bp["sbf_proj"], sbf)                 # (T, nb)
            t = torch.where(tmask[:, None],
                            bilinear(mk, a, bp["bilinear"]), 0.0)
            agg = scat(t, to_idx, e)
            m = m + mlp_apply(bp["msg_mlp"], m) + agg
            return m * emask[:, None]

        for bp in params["blocks"]:
            m = checkpoint(block, m, bp, use_reentrant=False)

        x = scat(m, torch.where(emask, dst, -1), n)
        e_atom = mlp_apply(params["readout"], x)[:, 0]
        return graph_energies(e_atom, batch)


def loss_fn(params, cfg: DimeNetConfig, batch, gather_fn=None,
            scatter_fn=None, n_edges=None) -> torch.Tensor:
    e = forward(params, cfg, batch, gather_fn=gather_fn,
                scatter_fn=scatter_fn, n_edges=n_edges)
    return torch.mean((e - batch["energy"].float()) ** 2)


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray,
                   max_triplets: int | None = None):
    """Host-side triplet builder: pairs (edge kj, edge ji) sharing node j.
    Returns (tri_in, tri_out) int32 padded with -1."""
    e = len(edge_src)
    by_dst: dict[int, list[int]] = {}
    for idx in range(e):
        if edge_src[idx] < 0:
            continue
        by_dst.setdefault(int(edge_dst[idx]), []).append(idx)
    ti, to = [], []
    for ji in range(e):
        j = int(edge_src[ji])
        if j < 0:
            continue
        for kj in by_dst.get(j, ()):
            if int(edge_src[kj]) == int(edge_dst[ji]):
                continue  # exclude k == i backtrack
            ti.append(kj)
            to.append(ji)
    ti = np.asarray(ti, np.int32)
    to = np.asarray(to, np.int32)
    if max_triplets is not None:
        ti, to = ti[:max_triplets], to[:max_triplets]
        pad = max_triplets - len(ti)
        if pad > 0:
            ti = np.concatenate([ti, -np.ones(pad, np.int32)])
            to = np.concatenate([to, -np.ones(pad, np.int32)])
    return ti, to
