"""The port's GNN family against the JAX reference (CPU, f32).

Bitwise: the graph generators, the SO(3) tables, the fanout sampler and
the triplet builder (numpy on both sides).  Within rtol 1e-4 / atol 1e-5,
with the reference's parameters carried across by `params_from_jax`:
`scatter_to_nodes`, each model's forward, loss and every gradient leaf,
and NequIP's forces.  Products and sums run in other orders (XLA's
einsums, PyTorch's explicit contractions), so floats agree within that
tolerance, not bitwise.  Then every test of tests/test_gnn.py and
tests/test_arch_smoke.py::test_gnn_smoke_train_step, run on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro.configs import registry as jregistry
from repro.data import synthetic as jsyn
from repro.models.gnn import common as jcommon
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import graphcast as jgraphcast
from repro.models.gnn import mace as jmace
from repro.models.gnn import nequip as jnequip
from repro.models.gnn import sampler as jsampler
from repro.models.gnn import so3 as jso3
from repro_torch.configs import registry
from repro_torch.data.synthetic import molecules_batch, random_graph
from repro_torch.models.gnn import dimenet, graphcast, mace, nequip, so3
from repro_torch.models.gnn.common import (bessel_rbf, degree, edge_vectors,
                                           scatter_to_nodes)
from repro_torch.models.gnn.sampler import (csr_from_edges, expected_sizes,
                                            padded_sample, sample_subgraph)
from repro_torch.models.gnn.so3 import (_random_rotations, allowed_paths,
                                        real_cg, real_sph_harm_np,
                                        wigner_d_real_np)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                       make_train_step)
from repro_torch.utils.tree import flatten_with_path

RTOL, ATOL = 1e-4, 1e-5
PORT = {"graphcast": graphcast, "nequip": nequip, "mace": mace,
        "dimenet": dimenet}
REF = {"graphcast": jgraphcast, "nequip": jnequip, "mace": jmace,
       "dimenet": jdimenet}
ARCHS = list(PORT)
N_PAD = 8      # -1 edges appended to every parity batch


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pad(a, n=N_PAD):
    return np.concatenate([a, -np.ones(n, a.dtype)])


def _graph_batch(cfg, n=60, e=240, seed=1, pad=N_PAD):
    """graphcast's batch: random_graph plus `pad` -1 edges, N(0, 1)
    targets."""
    g = random_graph(n, e, d_feat=cfg.d_feat, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return {"node_feat": g.node_feat, "edge_src": _pad(g.edge_src, pad),
            "edge_dst": _pad(g.edge_dst, pad),
            "edge_feat": np.concatenate(
                [g.edge_feat, rng.normal(size=(pad, cfg.d_edge))
                 .astype(np.float32)]),
            "targets": rng.normal(size=(n, cfg.n_vars)).astype(np.float32)}


def _mol_batch(arch, n_mol=3, n_nodes=10, n_edges=24, seed=2, pad=N_PAD):
    """A molecules_batch with `pad` -1 edges, species abs(labels) % 8,
    N(0, 1) energies; dimenet's triplets padded with -1."""
    mol, gid = molecules_batch(n_mol, n_nodes, n_edges, seed=seed)
    b = {"species": (np.abs(mol.labels) % 8).astype(np.int32),
         "pos": mol.pos, "edge_src": _pad(mol.edge_src, pad),
         "edge_dst": _pad(mol.edge_dst, pad), "graph_ids": gid,
         "energy": np.random.default_rng(seed).normal(size=n_mol)
         .astype(np.float32)}
    if arch == "dimenet":
        b["tri_in"], b["tri_out"] = dimenet.build_triplets(
            b["edge_src"], b["edge_dst"], max_triplets=4 * len(b["edge_src"]))
    return b


def _setup(arch, reduced=True, **over):
    """(cfg (with `over`), the reference's cfg, numpy parameters from the
    reference's init, the batch)."""
    cfg = dataclasses.replace(
        registry.get_arch(arch).model_config(reduced=reduced), **over)
    jcfg = dataclasses.replace(
        jregistry.get_arch(arch).model_config(reduced=reduced), **over)
    params = jax.tree.map(np.asarray, REF[arch].init_params(
        jcfg, jax.random.PRNGKey(3)))
    batch = _graph_batch(cfg) if arch == "graphcast" else _mol_batch(arch)
    return cfg, jcfg, params, batch


def _forward(mod, arch):
    return mod.forward if arch in ("graphcast", "dimenet") else \
        mod.forward_energy


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# Bitwise: generators, SO(3) tables, sampler, triplets
# ---------------------------------------------------------------------------
def _same_graph(a, b):
    for f in dataclasses.fields(jsyn.GraphBatch):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("geometric", [False, True])
def test_random_graph_bitwise(geometric):
    args = (50, 160, 7) if geometric else (300, 2000, 5)
    _same_graph(random_graph(*args, d_edge=3, seed=4, geometric=geometric),
                jsyn.random_graph(*args, d_edge=3, seed=4,
                                  geometric=geometric))


def test_molecules_batch_bitwise():
    mol, gid = molecules_batch(4, 12, 30, seed=5)
    jmol, jgid = jsyn.molecules_batch(4, 12, 30, seed=5)
    _same_graph(mol, jmol)
    assert gid.dtype == jgid.dtype
    np.testing.assert_array_equal(gid, jgid)


def test_sph_harm_and_wigner_bitwise():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rots = _random_rotations(3, seed=8)
    np.testing.assert_array_equal(rots, jso3._random_rotations(3, seed=8))
    for l in (0, 1, 2):
        np.testing.assert_array_equal(real_sph_harm_np(l, v),
                                      jso3.real_sph_harm_np(l, v))
        for r in rots:
            np.testing.assert_array_equal(wigner_d_real_np(l, r),
                                          jso3.wigner_d_real_np(l, r))
    assert so3.L_MAX == jso3.L_MAX and so3.DIMS == jso3.DIMS


@pytest.mark.parametrize("path", jso3.allowed_paths(2))
def test_real_cg_bitwise(path):
    assert allowed_paths(2) == jso3.allowed_paths(2)
    np.testing.assert_array_equal(real_cg(*path), jso3.real_cg(*path))


def test_sph_harm_torch_matches_reference():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for l in (0, 1, 2):
        _close(so3.sph_harm_torch(l, torch.from_numpy(v)),
               jso3.sph_harm_jax(l, jnp.asarray(v)), rtol=1e-6, atol=1e-7)


def test_build_triplets_bitwise():
    mol, _ = molecules_batch(2, 12, 30, seed=3)
    src, dst = _pad(mol.edge_src, 3), _pad(mol.edge_dst, 3)
    for cap in (None, 50, 400):
        got = dimenet.build_triplets(src, dst, max_triplets=cap)
        want = jdimenet.build_triplets(src, dst, max_triplets=cap)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_sampler_bitwise():
    g = random_graph(500, 5000, d_feat=4, seed=5)
    csr = csr_from_edges(500, g.edge_src, g.edge_dst)
    jcsr = jsampler.csr_from_edges(500, g.edge_src, g.edge_dst)
    np.testing.assert_array_equal(csr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(csr.indices, jcsr.indices)
    assert csr.n_nodes == jcsr.n_nodes
    seeds = np.random.default_rng(0).choice(500, 32, replace=False)
    got = sample_subgraph(csr, seeds, [5, 3], np.random.default_rng(1))
    want = jsampler.sample_subgraph(jcsr, seeds, [5, 3],
                                    np.random.default_rng(1))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert expected_sizes(16, [4, 2]) == jsampler.expected_sizes(16, [4, 2])
    mn, me = expected_sizes(16, [4, 2])
    for step in (0, 3):
        a = padded_sample(csr, g.node_feat, g.labels, 16, [4, 2], step=step,
                          max_nodes=mn, max_edges=me - 5, seed=1)
        b = jsampler.padded_sample(jcsr, g.node_feat, g.labels, 16, [4, 2],
                                   step=step, max_nodes=mn,
                                   max_edges=me - 5, seed=1)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# Within tolerance: segment ops, forward, loss, gradients, forces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_scatter_to_nodes_matches_reference(agg):
    rng = np.random.default_rng(7)
    n, e, d = 30, 200, 5
    dst = rng.integers(0, n - 5, e).astype(np.int32)   # 5 nodes get nothing
    dst[rng.random(e) < 0.2] = -1                      # -1 pads
    msg = rng.normal(size=(e, d)).astype(np.float32)
    got = scatter_to_nodes(torch.from_numpy(msg), torch.from_numpy(dst), n,
                           agg=agg)
    want = jax.jit(lambda m, i: jcommon.scatter_to_nodes(m, i, n, agg=agg))(
        msg, dst)
    _close(got, want)
    assert not np.asarray(got)[n - 5:].any()


@pytest.mark.parametrize("arch,chunks", [("graphcast", 1), ("graphcast", 4),
                                         ("nequip", 1), ("mace", 1),
                                         ("dimenet", 1)])
def test_forward_matches_reference(arch, chunks):
    over = {"edge_chunks": chunks} if arch == "graphcast" else {}
    cfg, jcfg, params, batch = _setup(arch, **over)
    got = _forward(PORT[arch], arch)(
        PORT[arch].params_from_jax(params, cfg, device="cpu"), cfg,
        _t(batch))
    want = jax.jit(lambda p, b: _forward(REF[arch], arch)(p, jcfg, b))(
        params, _j(batch))
    assert tuple(got.shape) == want.shape
    _close(got, want)


# the reduced configs, then every arch at full width (graphcast in f32,
# with 2 of its 16 layers and with all 16)
LOSS_CASES = [("graphcast", True, {"edge_chunks": 1}),
              ("graphcast", True, {"edge_chunks": 4}),
              ("nequip", True, {}), ("mace", True, {}), ("dimenet", True, {}),
              ("graphcast", False, {"n_layers": 2, "dtype": "float32"}),
              ("graphcast", False, {"n_layers": 16, "dtype": "float32"}),
              ("nequip", False, {}), ("mace", False, {}),
              ("dimenet", False, {})]
# GraphCast's 16 layers at the reference's init give a loss near 1e12
# on this graph: its f32 gradients cancel, and a few elements of a leaf
# land up to 6.5e-4 apart relative (0.047 on entries near 1e2; the worst
# leaf's max |port - jax| is 9.1e-5 of its max |jax|).  There each leaf
# is held as a whole, max |port - jax| <= 1e-3 x max |jax|: sums split
# over another number of threads round in another order
LEAF_MAX_RTOL = {("graphcast", 16): 1e-3}


@pytest.mark.parametrize("arch,reduced,over", LOSS_CASES, ids=[
    f"{a}-{'reduced' if r else 'full'}"
    + "".join(f"-{o[k]}" for k in ("edge_chunks", "n_layers") if k in o)
    for a, r, o in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, reduced, over):
    cfg, jcfg, params, batch = _setup(arch, reduced, **over)
    tparams = PORT[arch].params_from_jax(params, cfg, device="cpu")
    loss, _, grads = loss_and_grads(
        lambda p, b: (PORT[arch].loss_fn(p, cfg, b), {}), tparams, _t(batch))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: REF[arch].loss_fn(p, jcfg, b)))(params, _j(batch))
    _close(loss, jloss, what="loss")
    flat = flatten_with_path(grads)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(k) for k, _ in jflat]
    leaf_rtol = LEAF_MAX_RTOL.get((arch, over.get("n_layers")))
    for (k, g), (_, jg) in zip(flat, jflat):
        assert tuple(g.shape) == jg.shape, k
        if leaf_rtol is None:
            _close(g, jg, what=k)
        else:
            err = float(np.abs(g.numpy() - np.asarray(jg)).max())
            assert err <= leaf_rtol * float(np.abs(jg).max()), (k, err)
    assert any(float(g.abs().max()) > 0 for _, g in flat)


def test_nequip_forces_match_reference():
    cfg, jcfg, params, batch = _setup("nequip")
    got = nequip.forces_fn(nequip.params_from_jax(params, cfg, device="cpu"),
                           cfg, _t(batch))
    want = jax.jit(lambda p, b: jnequip.forces_fn(p, jcfg, b))(params,
                                                               _j(batch))
    _close(got, want)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_tree_and_scales(arch):
    cfg, jcfg, params, _ = _setup(arch)
    full = registry.get_arch(arch).model_config()
    ours = PORT[arch].init_params(full, torch.Generator().manual_seed(0),
                                  device="cpu")
    shapes = jax.eval_shape(lambda: REF[arch].init_params(
        jregistry.get_arch(arch).model_config(), jax.random.PRNGKey(0)))
    flat = flatten_with_path(ours)
    jflat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(k) for k, _ in jflat]
    for (k, t), (_, s) in zip(flat, jflat):
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32, k
        if k.endswith("['b'][0]") or k.endswith("['b'][1]"):
            assert not t.any(), k
        elif "['w']" in k and t.numel() >= 4096:
            d_in = t.shape[-2]
            assert abs(float(t.std()) * d_in ** 0.5 - 1) < 0.1, k
    if arch == "nequip":
        for lp in ours["layers"]:
            s = [lp["self"][str(l)] for l in range(full.l_max + 1)]
            assert all(torch.equal(s[0], x) for x in s[1:])
            assert s[0].data_ptr() != s[1].data_ptr()
    with pytest.raises(ValueError, match="layers"):
        PORT[arch].params_from_jax(params, dataclasses.replace(
            cfg, **{("n_blocks" if arch == "dimenet" else "n_layers"): 7}),
            device="cpu")


# ---------------------------------------------------------------------------
# tests/test_gnn.py on the port
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.integers(0, 1000))
def test_scatter_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    n, e, d = 20, 60, 4
    src = rng.integers(-1, n, e).astype(np.int32)   # -1 = padding
    dst = rng.integers(0, n, e).astype(np.int32)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    out = scatter_to_nodes(torch.from_numpy(msg), torch.from_numpy(dst), n,
                           torch.from_numpy(src >= 0)).numpy()
    ref = np.zeros((n, d), np.float32)
    for i in range(e):
        if src[i] >= 0:
            ref[dst[i]] += msg[i]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _mean_and_max():
    msg = torch.tensor([[1.0], [3.0], [5.0]])
    dst = torch.tensor([0, 0, 1], dtype=torch.int32)
    mask = torch.tensor([True, True, True])
    mean = scatter_to_nodes(msg, dst, 2, mask, agg="mean")
    mx = scatter_to_nodes(msg, dst, 2, mask, agg="max")
    np.testing.assert_allclose(mean[:, 0].numpy(), [2.0, 5.0])
    np.testing.assert_allclose(mx[:, 0].numpy(), [3.0, 5.0])


def _degree_counts():
    deg = degree(torch.tensor([0, 0, 1, -1], dtype=torch.int32), 3)
    np.testing.assert_allclose(deg.numpy(), [2, 1, 0])


def _edge_vectors_unit_norm():
    pos = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 3))
                           .astype(np.float32))
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([3, 4, 5], dtype=torch.int32)
    u, r = edge_vectors(pos, src, dst)
    np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=1), 1.0,
                               rtol=1e-5)
    assert (r.numpy() > 0).all()


def _bessel_rbf_cutoff():
    rbf = bessel_rbf(torch.tensor([0.5, 4.9, 5.1, 10.0]), 4, 5.0).numpy()
    assert np.abs(rbf[2:]).max() < 1e-3   # beyond cutoff ~ 0


@pytest.mark.parametrize("check", [_mean_and_max, _degree_counts,
                                   _edge_vectors_unit_norm,
                                   _bessel_rbf_cutoff],
                         ids=lambda f: f.__name__.strip("_"))
def test_segment_and_geometry_ops(check):
    check()


def _sph_harm_orthonormal():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(200000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for l in (0, 1, 2):
        for y in (real_sph_harm_np(l, v),
                  so3.sph_harm_torch(l, torch.from_numpy(v)).numpy()):
            gram = 4 * np.pi * (y.T @ y) / len(v)
            np.testing.assert_allclose(gram, np.eye(2 * l + 1), atol=0.05)


def _wigner_d_composition():
    rots = _random_rotations(2, seed=3)
    r12 = rots[0] @ rots[1]
    for l in (1, 2):
        d1 = wigner_d_real_np(l, rots[0])
        d2 = wigner_d_real_np(l, rots[1])
        d12 = wigner_d_real_np(l, r12)
        np.testing.assert_allclose(d1 @ d2, d12, atol=1e-6)


def _cg_equivariance_all_paths():
    for (l1, l2, l3) in allowed_paths(2):
        c = real_cg(l1, l2, l3)
        assert c is not None
        for rr in _random_rotations(2, seed=17):
            d1, d2, d3 = (wigner_d_real_np(l, rr) for l in (l1, l2, l3))
            lhs = np.einsum("kij,ia,jb->kab", c, d1, d2)
            rhs = np.einsum("kl,lab->kab", d3, c)
            np.testing.assert_allclose(lhs, rhs, atol=1e-6)


@pytest.mark.parametrize("check", [_sph_harm_orthonormal,
                                   _wigner_d_composition,
                                   _cg_equivariance_all_paths],
                         ids=lambda f: f.__name__.strip("_"))
def test_so3(check):
    check()


@pytest.fixture(scope="module")
def mol_batch():
    mol, gid = molecules_batch(3, 10, 24, seed=2)
    return _t({"species": (np.abs(mol.labels) % 8).astype(np.int32),
               "pos": mol.pos, "edge_src": mol.edge_src,
               "edge_dst": mol.edge_dst, "graph_ids": gid,
               "energy": np.zeros(3, np.float32)})


@pytest.mark.parametrize("which", ["nequip", "mace"])
def test_energy_invariance_under_rotation_translation(which, mol_batch):
    m = PORT[which]
    cfg = (nequip.NequIPConfig(n_layers=2, channels=8) if which == "nequip"
           else mace.MACEConfig(n_layers=1, channels=8))
    params = m.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    e0 = m.forward_energy(params, cfg, mol_batch)
    r = torch.from_numpy(_random_rotations(1, seed=9)[0].astype(np.float32))
    rot = dict(mol_batch, pos=mol_batch["pos"] @ r.T
               + torch.tensor([1.7, -0.3, 2.2]))
    e1 = m.forward_energy(params, cfg, rot)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-4, atol=1e-4)


def test_nequip_force_equivariance(mol_batch):
    cfg = nequip.NequIPConfig(n_layers=2, channels=8)
    params = nequip.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    f = nequip.forces_fn(params, cfg, mol_batch)
    r = torch.from_numpy(_random_rotations(1, seed=11)[0].astype(np.float32))
    f_rot = nequip.forces_fn(params, cfg,
                             dict(mol_batch, pos=mol_batch["pos"] @ r.T))
    np.testing.assert_allclose(f_rot.numpy(), (f @ r.T).numpy(), rtol=1e-3,
                               atol=1e-4)


def _sampler_subgraph_valid():
    g = random_graph(500, 5000, d_feat=4, seed=5)
    csr = csr_from_edges(500, g.edge_src, g.edge_dst)
    rng = np.random.default_rng(0)
    seeds = rng.choice(500, 32, replace=False)
    nodes, es, ed = sample_subgraph(csr, seeds, [5, 3], rng)
    assert len(set(nodes.tolist())) == len(nodes)
    assert es.max() < len(nodes) and ed.max() < len(nodes)
    # every sampled edge exists in the original graph
    eset = set(zip(g.edge_src.tolist(), g.edge_dst.tolist()))
    for s_, d_ in zip(es.tolist()[:50], ed.tolist()[:50]):
        assert (int(nodes[d_]), int(nodes[s_])) in eset \
            or (int(nodes[s_]), int(nodes[d_])) in eset


def _padded_sample_fixed_shape_and_determinism():
    g = random_graph(400, 4000, d_feat=6, seed=6)
    csr = csr_from_edges(400, g.edge_src, g.edge_dst)
    mn, me = expected_sizes(16, [4, 2])
    a = padded_sample(csr, g.node_feat, g.labels, 16, [4, 2], step=3,
                      max_nodes=mn, max_edges=me, seed=1)
    b = padded_sample(csr, g.node_feat, g.labels, 16, [4, 2], step=3,
                      max_nodes=mn, max_edges=me, seed=1)
    np.testing.assert_array_equal(a["edge_src"], b["edge_src"])
    assert a["node_feat"].shape == (mn, 6)


def _triplets_share_pivot_node():
    mol, _ = molecules_batch(1, 12, 30, seed=3)
    ti, to = dimenet.build_triplets(mol.edge_src, mol.edge_dst)
    for a, b in zip(ti.tolist()[:100], to.tolist()[:100]):
        if a < 0:
            continue
        # edge_in (k->j) ends where edge_out (j->i) starts
        assert mol.edge_dst[a] == mol.edge_src[b]
        # no immediate backtrack k == i
        assert mol.edge_src[a] != mol.edge_dst[b]


@pytest.mark.parametrize("check", [_sampler_subgraph_valid,
                                   _padded_sample_fixed_shape_and_determinism,
                                   _triplets_share_pivot_node],
                         ids=lambda f: f.__name__.strip("_"))
def test_sampler_and_triplets(check):
    check()


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py::test_gnn_smoke_train_step on the port
# ---------------------------------------------------------------------------
def _smoke_batch(arch, cfg):
    rng = np.random.default_rng(0)
    if arch == "graphcast":
        g = random_graph(60, 240, d_feat=cfg.d_feat, seed=1)
        return _t({"node_feat": g.node_feat, "edge_src": g.edge_src,
                   "edge_dst": g.edge_dst, "edge_feat": g.edge_feat,
                   "targets": rng.normal(size=(60, cfg.n_vars))
                   .astype(np.float32)})
    mol, gid = molecules_batch(3, 10, 24, seed=1)
    batch = {"species": (np.abs(mol.labels) % 8).astype(np.int32),
             "pos": mol.pos, "edge_src": mol.edge_src,
             "edge_dst": mol.edge_dst, "graph_ids": gid,
             "energy": rng.normal(size=3).astype(np.float32)}
    if arch == "dimenet":
        batch["tri_in"], batch["tri_out"] = dimenet.build_triplets(
            mol.edge_src, mol.edge_dst, max_triplets=800)
    return _t(batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_smoke_train_step(arch):
    cfg = registry.get_arch(arch).model_config(reduced=True)
    m = PORT[arch]
    batch = _smoke_batch(arch, cfg)
    params = m.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    if arch == "graphcast":
        assert tuple(m.forward(params, cfg, batch).shape) == (60, cfg.n_vars)
    loss, _, grads = loss_and_grads(lambda p, b: (m.loss_fn(p, cfg, b), {}),
                                    params, batch)
    assert np.isfinite(float(loss))
    gn = sum(float(g.abs().sum()) for _, g in flatten_with_path(grads))
    assert np.isfinite(gn) and gn > 0
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(lambda p, b: (m.loss_fn(p, cfg, b), {}), opt)
    state = init_train_state(params, opt)
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
