"""The port's GNN family on the card against the same code on the CPU.

Every test here needs an NVIDIA GPU; elsewhere each one skips.  The file
imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gnn_cuda.py

At the reduced configs, in f32: one loss-and-gradient evaluation of each
arch at the same parameters and batch, the loss within rtol 1e-5 and
every gradient leaf within 1e-4 x its CPU max + 1e-6 (`index_add_` sums
with float atomics on the card, so not bitwise); `scatter_to_nodes`
with -1 pads for all three reductions; one train step of each arch.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data.synthetic import molecules_batch, random_graph
from repro_torch.models.gnn import dimenet, graphcast, mace, nequip
from repro_torch.models.gnn.common import scatter_to_nodes
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                       make_train_step)
from repro_torch.utils.tree import flatten_with_path, tree_map

pytestmark = pytest.mark.cuda
PORT = {"graphcast": graphcast, "nequip": nequip, "mace": mace,
        "dimenet": dimenet}
CPU = torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _batch(arch, cfg):
    """A numpy batch with 8 -1 edges: graphcast's random_graph, the
    others' molecules_batch (dimenet with its triplets)."""
    rng = np.random.default_rng(0)
    pad = -np.ones(8, np.int32)
    if arch == "graphcast":
        g = random_graph(300, 2400, d_feat=cfg.d_feat, seed=1)
        return {"node_feat": g.node_feat,
                "edge_src": np.concatenate([g.edge_src, pad]),
                "edge_dst": np.concatenate([g.edge_dst, pad]),
                "edge_feat": rng.normal(size=(2408, cfg.d_edge))
                .astype(np.float32),
                "targets": rng.normal(size=(300, cfg.n_vars))
                .astype(np.float32)}
    mol, gid = molecules_batch(8, 30, 64, seed=0)
    b = {"species": (np.abs(mol.labels) % 8).astype(np.int32),
         "pos": mol.pos, "edge_src": np.concatenate([mol.edge_src, pad]),
         "edge_dst": np.concatenate([mol.edge_dst, pad]), "graph_ids": gid,
         "energy": rng.normal(size=8).astype(np.float32)}
    if arch == "dimenet":
        b["tri_in"], b["tri_out"] = dimenet.build_triplets(
            b["edge_src"], b["edge_dst"], max_triplets=4 * 520)
    return b


def _on(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _loss(arch, cfg):
    return lambda p, b: (PORT[arch].loss_fn(p, cfg, b), {})


@pytest.mark.parametrize("arch", list(PORT))
def test_loss_and_grads_card_equal_cpu(arch, dev):
    cfg = registry.get_arch(arch).model_config(reduced=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = PORT[arch].init_params(cfg, gen, device=dev)
    batch = _batch(arch, cfg)
    loss, _, grads = loss_and_grads(_loss(arch, cfg), params, _on(batch, dev))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_loss, _, cpu_grads = loss_and_grads(_loss(arch, cfg), cpu_params,
                                            _on(batch, CPU))
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-5, atol=0.0)
    for (k, g), (_, c) in zip(flatten_with_path(grads),
                              flatten_with_path(cpu_grads)):
        err = float((g.cpu() - c).abs().max())
        assert err <= 1e-4 * float(c.abs().max()) + 1e-6, (k, err)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_scatter_to_nodes_card_equal_cpu(agg, dev):
    rng = np.random.default_rng(3)
    n, e, d = 1000, 20000, 16
    dst = rng.integers(0, n - 10, e).astype(np.int32)
    dst[rng.random(e) < 0.1] = -1
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    want = scatter_to_nodes(msg, torch.from_numpy(dst), n, agg=agg)
    got = scatter_to_nodes(msg.to(dev), torch.from_numpy(dst).to(dev), n,
                           agg=agg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert not got[n - 10:].any()


@pytest.mark.parametrize("arch", list(PORT))
def test_train_step_on_card(arch, dev):
    cfg = registry.get_arch(arch).model_config(reduced=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    state = init_train_state(PORT[arch].init_params(cfg, gen, device=dev),
                             opt)
    step = make_train_step(_loss(arch, cfg), opt)
    state, metrics = step(state, _on(_batch(arch, cfg), dev))
    assert int(state["step"]) == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(t.device.type == "cuda"
               for _, t in flatten_with_path(state["params"]))
