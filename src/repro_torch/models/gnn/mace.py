"""MACE: higher-order equivariant message passing (ACE) [arXiv:2206.07697]
(port of `repro.models.gnn.mace`).

Assigned config: 2 layers, 128 channels, l_max=2, correlation order 3,
n_rbf=8.  Per layer:

  1. atomic basis  A_i^(l) = sum_j R_l(|r_ij|) * CG . (h_j (x) Y(r_ij))
     (one-particle basis -- the same contraction as a NequIP message,
     `nequip.point_messages`)
  2. product basis B: channel-wise CG products of A up to correlation 3:
        order 1:  A^(l)
        order 2:  (A (x) A)^(l)      via real CG
        order 3:  ((A (x) A) (x) A)^(l)
     each order/path gets a learned channel mixing, path by path.
  3. message m_i = sum over basis elements (linear) ; update h <- lin(m)+res.

Readout: scalars -> atom energy; total = segment sum over graphs.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..._device import resolve_device
from ...core.distances import f32_matmul
from .common import (check_depth, graph_energies, init_mlp, mlp_apply,
                     scatter_rows, take_rows, tree_from_numpy)
from .nequip import cg_tensors, edge_basis, point_messages
from .so3 import DIMS, real_cg


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    radial_hidden: int = 64


def _paths(l_max: int):
    return [(l1, l2, l3)
            for l1 in range(l_max + 1) for l2 in range(l_max + 1)
            for l3 in range(l_max + 1) if real_cg(l1, l2, l3) is not None]


def init_params(cfg: MACEConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree and scales, drawn from `generator` in the
    reference's order on `device` (None means the CUDA device)."""
    dev = resolve_device(device)
    c = cfg.channels

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    def mix():
        return normal(c, c) / math.sqrt(c)

    params = {"embed": normal(cfg.n_species, c) * 0.5,
              "readout": init_mlp(generator, [c, c, 1], dev), "layers": []}
    for _ in range(cfg.n_layers):
        lp = {"radial": {}, "mix_a": {}, "mix_b2": {}, "mix_b3": {},
              "upd": {}}
        for (l1, l2, l3) in _paths(cfg.l_max):
            key = f"{l1}{l2}{l3}"
            lp["radial"][key] = init_mlp(
                generator, [cfg.n_rbf, cfg.radial_hidden, c], dev)
            lp["mix_b2"][key] = mix()
            lp["mix_b3"][key] = mix()
        for l in range(cfg.l_max + 1):
            lp["mix_a"][str(l)] = mix()
            lp["upd"][str(l)] = mix()
        params["layers"].append(lp)
    return params


def params_from_jax(tree: dict, cfg: MACEConfig, device=None) -> dict:
    """The port's tree from the reference's `init_params` tree (numpy
    arrays), float32 on `device`, in the same layout."""
    check_depth(cfg.name, len(tree["layers"]), cfg.n_layers)
    return tree_from_numpy(tree, device)


def cg_product(cg: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The reference's einsum("kij,nic,njc->nkc", cg, a, b) in an explicit
    order: the channel-wise outer product (N, I*J, C), then CG (K, I*J)
    over it."""
    n, i, c = a.shape
    outer = (a[:, :, None, :] * b[:, None, :, :]).reshape(n, -1, c)
    return torch.matmul(cg.reshape(cg.shape[0], -1), outer)


def forward_energy(params, cfg: MACEConfig, batch,
                   gather_fn=None, scatter_fn=None) -> torch.Tensor:
    """batch as `nequip.forward_energy`'s; per-graph energies."""
    take = gather_fn or take_rows
    scat = scatter_fn or scatter_rows
    species = batch["species"]
    n = species.shape[0]
    c = cfg.channels
    with f32_matmul():
        mask, rbf, ylm = edge_basis(cfg, batch)
        paths = _paths(cfg.l_max)
        cgs = cg_tensors(paths, rbf.device)
        feats = {0: take_rows(params["embed"], species)[:, None, :]}
        for l in range(1, cfg.l_max + 1):
            feats[l] = rbf.new_zeros((n, DIMS[l], c))

        for lp in params["layers"]:
            # --- 1. atomic basis A ---------------------------------------
            a = point_messages(feats, lp["radial"], cfg, batch, mask, rbf,
                               ylm, cgs, take, scat)
            a = {l: a[l] @ lp["mix_a"][str(l)] for l in a}
            # --- 2. product basis B (correlation 2 and 3, channel-wise) --
            b = dict(a)                                        # order 1
            a2 = {l: rbf.new_zeros((n, DIMS[l], c)) for l in a}  # order 2
            for (l1, l2, l3) in paths:
                t = cg_product(cgs[(l1, l2, l3)], a[l1], a[l2])
                a2[l3] = a2[l3] + t @ lp["mix_b2"][f"{l1}{l2}{l3}"]
            if cfg.correlation >= 3:
                for (l1, l2, l3) in paths:
                    t = cg_product(cgs[(l1, l2, l3)], a2[l1], a[l2])
                    b[l3] = b[l3] + t @ lp["mix_b3"][f"{l1}{l2}{l3}"]
            for l in a2:
                b[l] = b[l] + a2[l]
            # --- 3. update ------------------------------------------------
            feats = {l: feats[l] + b[l] @ lp["upd"][str(l)] for l in b}
            feats[0] = F.silu(feats[0])

        e_atom = mlp_apply(params["readout"], feats[0][:, 0, :])[:, 0]
        return graph_energies(e_atom, batch)


def loss_fn(params, cfg: MACEConfig, batch, gather_fn=None,
            scatter_fn=None) -> torch.Tensor:
    e = forward_energy(params, cfg, batch, gather_fn=gather_fn,
                       scatter_fn=scatter_fn)
    return torch.mean((e - batch["energy"].float()) ** 2)
