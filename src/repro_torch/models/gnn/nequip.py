"""NequIP: E(3)-equivariant interatomic potential [arXiv:2101.03164]
(port of `repro.models.gnn.nequip`).

Assigned config: 5 layers, 32 channels, l_max=2, n_rbf=8, cutoff=5 A.

Features are dicts of irreps {l: (N, 2l+1, C)}.  One interaction layer:
  for each CG path (l1 in features) x (l2 of edge harmonic) -> l3:
      msg^(l3) += R_path(rbf(|r|)) * CG[l3,l1,l2] . (V_src^(l1) (x) Y^(l2)(r))
  aggregate msg to nodes (segment sum), then per-l linear self-interaction
  + gated nonlinearity (scalars: silu; l>0: sigmoid(scalar gate) * tensor).

The CG tensors come from so3.real_cg (numerically derived, equivariance
property-tested).  Readout: scalar channel MLP -> per-atom energy; total
energy = sum; loss = MSE on energies (forces omitted -- autodiff forces
are exposed via `forces_fn`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..._device import resolve_device
from ...core.distances import f32_matmul
from .common import (bessel_rbf, check_depth, clip_index, edge_mask,
                     edge_vectors, graph_energies, init_mlp, mlp_apply,
                     scatter_rows, take_rows, tree_from_numpy)
from .so3 import DIMS, real_cg, sph_harm_torch


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    radial_hidden: int = 64


def _paths(l_max: int):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if real_cg(l1, l2, l3) is not None:
                    out.append((l1, l2, l3))
    return out


def init_params(cfg: NequIPConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree and scales, drawn from `generator` on
    `device` (None means the CUDA device).  As in the reference, whose
    layer draws every l's self-interaction matrix from one key, a layer's
    "self" matrices start equal (separate tensors of one draw)."""
    dev = resolve_device(device)
    c = cfg.channels

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    params = {"embed": normal(cfg.n_species, c) * 0.5,
              "readout": init_mlp(generator, [c, c, 1], dev), "layers": []}
    for _ in range(cfg.n_layers):
        lp = {"radial": {f"{l1}{l2}{l3}": init_mlp(
            generator, [cfg.n_rbf, cfg.radial_hidden, c], dev)
            for (l1, l2, l3) in _paths(cfg.l_max)}}
        w_self = normal(c, c) / math.sqrt(c)
        lp["self"] = {str(l): w_self.clone() for l in range(cfg.l_max + 1)}
        lp["gate"] = init_mlp(generator, [c, cfg.l_max + 1], dev)
        params["layers"].append(lp)
    return params


def params_from_jax(tree: dict, cfg: NequIPConfig, device=None) -> dict:
    """The port's tree from the reference's `init_params` tree (numpy
    arrays), float32 on `device`, in the same layout."""
    check_depth(cfg.name, len(tree["layers"]), cfg.n_layers)
    return tree_from_numpy(tree, device)


def cg_tensors(paths, device) -> dict:
    """{(l1, l2, l3): real_cg as an f32 (2l3+1, 2l1+1, 2l2+1) tensor}."""
    return {p: torch.tensor(real_cg(*p), dtype=torch.float32, device=device)
            for p in paths}


def cg_message(cg: torch.Tensor, v: torch.Tensor, y: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """The reference's einsum("kij,eic,ej,ec->ekc", cg, v, y, w) in an
    explicit order: CG . Y per edge (E, K, I), then a batched product with
    V (E, I, C), then the radial weights -- no intermediate beyond
    (E, K, C)."""
    cy = torch.einsum("kij,ej->eki", cg, y)
    return torch.bmm(cy, v) * w[:, None, :]


def edge_basis(cfg, batch):
    """(mask, unit vectors, rbf (E, n_rbf) zeroed on pads, {l: Y_l})."""
    src, dst = batch["edge_src"], batch["edge_dst"]
    mask = edge_mask(src)
    unit, r = edge_vectors(batch["pos"], src, dst)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * mask[:, None]
    ylm = {l: sph_harm_torch(l, unit) for l in range(cfg.l_max + 1)}
    return mask, rbf, ylm


def point_messages(feats, lp_radial, cfg, batch, mask, rbf, ylm, cgs,
                   take, scat, n_nodes=None) -> dict:
    """sum over CG paths of the edge messages, aggregated at the
    destination atoms: {l3: (N, 2l3+1, C)} (NequIP's message, MACE's
    atomic basis A).  `n_nodes`: the node count that the edge ids index
    (None: the features' rows; on a mesh the global count, the features
    this rank's row block, which `take` and `scat` read and write)."""
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = feats[0].shape[0]
    n_all = n if n_nodes is None else n_nodes
    s_idx = clip_index(src, n_all)
    d_idx = torch.where(mask, dst, -1)
    out = {l: feats[0].new_zeros((n, DIMS[l], cfg.channels))
           for l in range(cfg.l_max + 1)}
    for (l1, l2, l3), cg in cgs.items():
        w = mlp_apply(lp_radial[f"{l1}{l2}{l3}"], rbf)           # (E, C)
        v = take(feats[l1].reshape(n, -1), s_idx).reshape(
            s_idx.shape[0], *feats[l1].shape[1:])                # (E, I, C)
        m = torch.where(mask[:, None, None], cg_message(cg, v, ylm[l2], w),
                        0.0)
        agg = scat(m.reshape(m.shape[0], -1), d_idx, n_all)
        out[l3] = out[l3] + agg.reshape(n, m.shape[1], cfg.channels)
    return out


def forward_energy(params, cfg: NequIPConfig, batch,
                   gather_fn=None, scatter_fn=None,
                   n_nodes=None) -> torch.Tensor:
    """batch: species (N,) int, pos (N, 3), edge_src/dst (E,), graph_ids
    (N,), energy (n_graphs,).  Returns per-graph energy (n_graphs,).

    gather_fn(table_2d, idx): row gather for the per-edge source-feature
    lookup; scatter_fn(values, idx, rows): the mirrored aggregation (-1
    dropped).  On a mesh (`launch.cells`' GNN rank program) species and
    graph_ids are this rank's row block, pos whole, the edges this rank's
    block of global ids, `n_nodes` the global node count, the hooks the
    mesh's (the ring, `ring_gather`), and the energies this rank's
    partial sums; None keeps the single-device path."""
    take = gather_fn or take_rows
    scat = scatter_fn or scatter_rows
    species = batch["species"]
    n = species.shape[0]
    with f32_matmul():
        mask, rbf, ylm = edge_basis(cfg, batch)
        cgs = cg_tensors(_paths(cfg.l_max), rbf.device)
        feats = {0: take_rows(params["embed"], species)[:, None, :]}
        for l in range(1, cfg.l_max + 1):
            feats[l] = rbf.new_zeros((n, DIMS[l], cfg.channels))

        for lp in params["layers"]:
            msgs = point_messages(feats, lp["radial"], cfg, batch, mask, rbf,
                                  ylm, cgs, take, scat, n_nodes)
            # self-interaction + gate
            gates = torch.sigmoid(mlp_apply(lp["gate"], feats[0][:, 0, :]))
            new = {}
            for l in range(cfg.l_max + 1):
                h = (feats[l] + msgs[l]) @ lp["self"][str(l)]
                new[l] = F.silu(h) if l == 0 else h * gates[:, None, l:l + 1]
            feats = new

        e_atom = mlp_apply(params["readout"], feats[0][:, 0, :])[:, 0]
        return graph_energies(e_atom, batch)


def loss_fn(params, cfg: NequIPConfig, batch, gather_fn=None,
            scatter_fn=None, n_nodes=None) -> torch.Tensor:
    e = forward_energy(params, cfg, batch, gather_fn=gather_fn,
                       scatter_fn=scatter_fn, n_nodes=n_nodes)
    return torch.mean((e - batch["energy"].float()) ** 2)


def forces_fn(params, cfg: NequIPConfig, batch) -> torch.Tensor:
    """F = -dE/dpos (autodiff through the equivariant network)."""
    pos = batch["pos"].detach().requires_grad_(True)
    with torch.enable_grad(), f32_matmul():
        e = forward_energy(params, cfg, {**batch, "pos": pos}).sum()
        (g,) = torch.autograd.grad(e, pos)
    return -g
