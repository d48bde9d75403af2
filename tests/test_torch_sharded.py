"""The port's sharded paths against the JAX package (CPU).

Mirrors tests/test_sharded.py: dense tensor parallelism, FSDP x TP, the
manual data-parallel step with int8 error feedback and the row-sharded
embedding lookup, plus gradients, train steps, ZeRO-1, DIN's sharded loss
and an elastic restore from 4 ranks into 2.  The port runs SPMD: one
process a rank, spawned with `repro_torch.launch.mesh.run_ranks` over gloo
(a `file://` rendezvous under the test's tmp dir, so parallel test runs
never share a port), at the reference test's tiny configs on a (2, 2)
mesh.  The rank functions live in the jax-free `_torch_mesh_ranks`; every
rank case runs in one 4-rank spawn a module (one 2-rank spawn reads the
checkpoint back), and this process holds the results against the JAX
package's unsharded results on the same parameters.  Tolerances: the
reference's 2e-5 on LM losses, the port's LM bar (rtol 1e-4, atol 1e-5)
on gradients and steps, DIN's (1e-5 / 1e-6), the lookup at 1e-6, the DP
loss at the reference's 0.05; the sharded sums add in another order
than one device does.

Mesh B, in the same spawn: sequence-sharded decode ("seq" and
"seq_all" on the (2, 2) mesh, "seq" on a (1, 4) mesh of the same ranks,
where 2 kv heads do not divide tp 4) and "head" decode, at the reference
test's dims (tests/test_sharded.py:93) and rtol / atol 3e-4, on its
prefilled cache (new length 17) and on a random one whose rows write at
the first and last row of a shard and leave later shards empty; the
sharded prefill at the LM bar; the expert-parallel MoE's loss (2e-5) and
every gradient leaf at no-drop capacities (tests/test_sharded.py:71),
and at the published capacities, on a batch that drops slots, each
rank's output (1e-5 / 1e-6) and dropped slots against the reference's
own sharded body `_moe_local`, run under `jax.vmap(axis_name="model")`
in this process (its slots drop where one device's would not).

Then process-free cases: the port's spec helpers give the reference's
`PartitionSpec`s leaf by leaf (every LM config of the registry, reduced,
with `fsdp_axis` and ZeRO-1; DIN; `cache_specs` in each mode), on mesh
stand-ins that carry only axis names and sizes; `_decode_partial` and
`shard_lengths` against the reference's, an empty shard included; and
the mesh-less paths are bitwise what they were.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from test_torch_ring_ops import ring_reference
from repro.configs import registry as jregistry
from repro.data.synthetic import din_batch, lm_batch
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.attention import _decode_partial as j_decode_partial
from repro.models.attention import shard_lengths as j_shard_lengths
from repro.models.recsys import din as jdin
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.data.synthetic import molecules_batch, random_graph
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.gnn import dimenet, graphcast, mace, nequip
from repro_torch.models.gnn.common import tree_from_numpy
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import din
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.train.optimizer import AdamWConfig, opt_state_specs
from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                       make_train_step)
from repro_torch.utils import sharding
from repro_torch.utils.sharding import P
from repro_torch.utils.tree import flatten_with_path

TP = dict(name="tp", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
          d_head=16, d_ff=128, vocab=256, remat="none", loss_chunks=2,
          dtype="float32")
FSDP = dict(TP, name="f", remat="full")
DP = dict(name="c", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
          d_head=8, d_ff=64, vocab=64, remat="none", loss_chunks=2,
          dtype="float32")
MOE = dict(name="m", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
           d_head=16, d_ff=0, vocab=256, remat="none", loss_chunks=2,
           dtype="float32",
           moe=dict(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                    d_ff_shared=64, pad_multiple=4, capacity_factor=8.0,
                    expert_capacity_factor=8.0, groups=2))
DEC = dict(name="d", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
           d_head=16, d_ff=128, vocab=256, remat="none", dtype="float32")
# (kv_mode, mesh shape, cache, positions): the reference test's prefilled
# cache at position 16 (new length 17), then a random cache with each row
# writing at a shard's first or last row, later shards left empty
DECODE_RUNS = [
    ("seq", (2, 2), "prefill", (16, 16, 16, 16)),
    ("seq_all", (2, 2), "prefill", (16, 16, 16, 16)),
    ("seq", (1, 4), "prefill", (16, 16, 16, 16)),
    ("head", (2, 2), "prefill", (16, 16, 16, 16)),
    ("seq_all", (2, 2), "random", (8, 23, 31, 0)),
    ("seq", (2, 2), "random", (16, 15, 0, 31)),
    ("seq", (1, 4), "random", (8, 23, 31, 0)),
    ("head", (2, 2), "random", (16, 15, 0, 31)),
]
OPT = dict(lr=1e-2, warmup_steps=5, total_steps=100)
STEPS = 3
CTX0 = jtf.ShardCtx(mesh=None)


def _np(tree):
    """A tree of tensors as numpy (the reference's layout, both sides)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _freeze(cfg: dict) -> tuple:
    return tuple((k, tuple(v.items()) if isinstance(v, dict) else v)
                 for k, v in cfg.items())


@functools.lru_cache(maxsize=None)
def _twin_params(cfg_items, seed):
    """Twin parameters: the port's init (the reference's eager init takes
    seconds), as numpy."""
    cfg = ranks.lm_config({k: dict(v) if k == "moe" else v
                           for k, v in cfg_items})
    return _np(tf.init_lm_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu"))


def _lm_input(cfg: dict, fsdp=None, zero1=False, seed=0, steps=STEPS):
    toks = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    first = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    rest = [dict(zip(("tokens", "labels"), lm_batch(s, 4, 16, cfg["vocab"],
                                                   seed=0)))
            for s in range(1, STEPS + 1)]
    return {"cfg": cfg, "params": _twin_params(_freeze(cfg), seed),
            "fsdp": fsdp, "zero1": zero1, "opt": OPT, "steps": steps,
            "batches": [first] + rest}


def _decode_input():
    """The reference decode test's model and prompt, its prefill placed in
    a 32-slot cache, and a random 32-slot cache."""
    params = _twin_params(_freeze(DEC), 2)
    toks = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    jcfg = _jcfg(DEC)
    lg, (ck, cv), lens = jax.jit(lambda p, t: jtf.serve_prefill(
        p, jcfg, t, CTX0))(params, toks)
    shape = (DEC["n_layers"], 4, 32, DEC["n_kv_heads"], DEC["d_head"])
    pre = [np.zeros(shape, np.float32) for _ in range(2)]
    pre[0][:, :, :16], pre[1][:, :, :16] = np.asarray(ck), np.asarray(cv)
    rng = np.random.default_rng(5)
    rand = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    return {"cfg": DEC, "params": params, "tokens": toks,
            "caches": {"prefill": (*pre, np.asarray(lens)),
                       "random": (*rand, np.zeros(4, np.int32))},
            "runs": [dict(mode=m, mesh=sh, cache=c, positions=np.asarray(
                p, np.int32)) for m, sh, c, p in DECODE_RUNS],
            "jprefill": (np.asarray(lg), np.asarray(ck), np.asarray(cv),
                         np.asarray(lens))}


def _moe_grad_input():
    """Two rows of 7 tokens, one a data rank: 7 tokens do not split over 2
    model ranks, so each runs them all; no-drop capacities (8.0)."""
    case = _moe_drop_input()
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    return {"moe": dict(case["moe"], capacity_factor=8.0,
                        expert_capacity_factor=8.0),
            "params": case["params"], "x": x,
            "g": rng.normal(size=x.shape).astype(np.float32)}


def _moe_drop_input():
    """A batch that overflows at the published capacities (1.25 / 1.5):
    experts 0 and 1, both on model rank 0, are most tokens' choices.  The
    widths are tests/test_torch_moe.py's (d 16, experts' 24), whose
    outputs its MoE bar (1e-5 / 1e-6) holds, and the skew is put in the
    router rather than in the activations: at d 64, or with the first
    feature 2 above its draw, the single-device layer itself differs from
    the reference's by up to 4.3e-6 on outputs of 3.8 to 8.3 (f32
    products in another order)."""
    mk = dict(n_experts=8, top_k=2, d_ff_expert=24, n_shared=1,
              d_ff_shared=32, pad_multiple=4)
    rng = np.random.default_rng(11)
    d, f = 16, 24
    x = rng.normal(size=(4, 16, d)).astype(np.float32)
    router = rng.normal(size=(d, 8)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 0.5
    router[0, 0], router[0, 1] = 6.0, 5.5

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    params = {"router": router, "we_gate": w(8, d, f), "we_in": w(8, d, f),
              "we_out": w(8, f, d), "ws_gate": w(d, 32), "ws_in": w(d, 32),
              "ws_out": w(32, d)}
    return {"moe": mk, "x": x, "params": params, "groups": (1, 2)}


def _din_input():
    jcfg = jregistry.get_arch("din").model_config(reduced=True)
    p = _np(din.init_params(din.DINConfig(**dataclasses.asdict(jcfg)),
                            torch.Generator().manual_seed(0),
                            device="cpu").param_tree())
    keys = ("hist_items", "hist_cates", "hist_len", "target_item",
            "target_cate", "label")
    batch = dict(zip(keys, din_batch(0, 8, jcfg.seq_len, jcfg.n_items,
                                     jcfg.n_cates, seed=0)))
    return {"cfg": dataclasses.asdict(jcfg), "params": p, "batch": batch,
            "n_candidates": 1000}


def _dp_input():
    return {"cfg": DP, "opt": OPT,
            "params": _twin_params(tuple(DP.items()), 0),
            "batches": [dict(zip(("tokens", "labels"),
                                 lm_batch(s, 16, 8, DP["vocab"], seed=0)))
                        for s in range(10)],
            "grads": np.random.default_rng(7).normal(
                size=(4, 5, 3)).astype(np.float32)}


GNN = {"nequip": nequip, "mace": mace, "dimenet": dimenet,
       "graphcast": graphcast}
# (name, arch, hooks): the ring below the gates, the plain hooks, and
# GraphCast's (the gated hooks, which never ring for it)
GNN_RUNS = [("nequip", "nequip", "ring"), ("mace", "mace", "ring"),
            ("dimenet", "dimenet", "ring"), ("nequip_plain", "nequip", "plain"),
            ("dimenet_plain", "dimenet", "plain"),
            ("graphcast", "graphcast", "gated")]


def _pad(a, n):
    return np.concatenate([a, -np.ones(n, a.dtype)])


def _mol(n_mol, n_edges, pad, seed=2):
    """molecules_batch of n_mol x 10 atoms, `pad` -1 edges, species
    abs(labels) % 8, N(0, 1) energies (tests/test_torch_gnn.py's)."""
    mol, gid = molecules_batch(n_mol, 10, n_edges, seed=seed)
    return {"species": (np.abs(mol.labels) % 8).astype(np.int32),
            "pos": mol.pos, "edge_src": _pad(mol.edge_src, pad),
            "edge_dst": _pad(mol.edge_dst, pad), "graph_ids": gid,
            "energy": np.random.default_rng(seed).normal(size=n_mol)
            .astype(np.float32)}


def _gnn_input():
    """Reduced configs, port-drawn parameters, 4 molecules of 10 atoms
    (40 nodes, 104 edge slots, 416 triplet slots: each a multiple of the
    4 ranks); GraphCast on a 40-node random graph; the nequip cell's
    molecule shape (n 40, e 128) and batch."""
    cfgs = {a: registry.get_arch(a).model_config(reduced=True) for a in GNN}
    params = {a: _np(m.init_params(cfgs[a], torch.Generator().manual_seed(i),
                                   device="cpu"))
              for i, (a, m) in enumerate(GNN.items())}
    mol = _mol(4, 24, 8)
    tri = dimenet.build_triplets(mol["edge_src"], mol["edge_dst"],
                                 max_triplets=4 * len(mol["edge_src"]))
    gc = cfgs["graphcast"]
    g = random_graph(40, 96, d_feat=gc.d_feat, seed=1)
    rng = np.random.default_rng(101)
    batches = {"nequip": mol, "mace": mol,
               "dimenet": dict(mol, tri_in=tri[0], tri_out=tri[1]),
               "graphcast": {
                   "node_feat": g.node_feat, "edge_src": _pad(g.edge_src, 8),
                   "edge_dst": _pad(g.edge_dst, 8),
                   "edge_feat": np.concatenate([g.edge_feat, rng.normal(
                       size=(8, gc.d_edge)).astype(np.float32)]),
                   "targets": rng.normal(size=(40, gc.n_vars)).astype(
                       np.float32),
                   "node_mask": np.ones(40, np.float32)}}
    return {"cfgs": cfgs, "params": params, "batches": batches,
            "runs": GNN_RUNS,
            "cell_shape": dict(name="molecule", kind="train", n_nodes=10,
                               n_edges=24, batch_graphs=4),
            "cell_batch": _mol(4, 24, 32, seed=3)}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(3)
    return {"tp": _lm_input(TP), "fsdp": _lm_input(FSDP, fsdp="data"),
            "zero1": dict(_lm_input(TP, zero1=True), ckpt=str(d / "zero1")),
            "lookup": {"table": rng.normal(size=(64, 6)).astype(np.float32),
                       "ids": np.random.default_rng(4).integers(
                           0, 64, (4, 5)).astype(np.int32)},
            "din": _din_input(), "dp": _dp_input(),
            "moe": _lm_input(MOE, seed=1, steps=0), "decode": _decode_input(),
            "moe_drop": _moe_drop_input(), "moe_grad": _moe_grad_input(),
            "ring": ring_reference(d / "ring.npz"), "gnn": _gnn_input()}


@pytest.fixture(scope="module")
def run4(cases, tmp_path_factory):
    """Every rank case in one spawn of 4 gloo ranks, a (2, 2) mesh."""
    init = tmp_path_factory.mktemp("rdv4") / "init"
    return run_ranks(ranks.mesh4, (2, 2), device="cpu",
                     init_method=f"file://{init}", args=(cases,),
                     timeout=300, threads=1)


@pytest.fixture(scope="module")
def run2(cases, run4, tmp_path_factory):
    """The 4-rank checkpoint read back on 2 ranks, a (1, 2) mesh."""
    init = tmp_path_factory.mktemp("rdv2") / "init"
    return run_ranks(ranks.restore_case, (1, 2), device="cpu",
                     init_method=f"file://{init}", args=(cases["zero1"],),
                     timeout=180, threads=1)


def _jcfg(cfg: dict):
    if cfg.get("moe") is not None:
        cfg = dict(cfg, moe=jmoe.MoEConfig(**cfg["moe"]))
    return jtf.LMConfig(**cfg)


def _jloss(case, batch):
    cfg = _jcfg(case["cfg"])
    return float(jax.jit(lambda p, t, l: jtf.lm_loss(p, cfg, t, l, CTX0)[0])(
        case["params"], batch["tokens"], batch["labels"]))


def _jgrads(case):
    cfg = _jcfg(case["cfg"])
    b = case["batches"][0]
    g = jax.jit(jax.grad(lambda p: jtf.lm_loss(
        p, cfg, b["tokens"], b["labels"], CTX0)[0]))(case["params"])
    flat, _ = jax.tree_util.tree_flatten_with_path(g)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


_STEPS_DONE: dict = {}


def _jsteps(case):
    """(losses, final params by path) of the reference's train steps (the
    tp and zero1 cases share theirs)."""
    key = (tuple(case["cfg"].items()), case["steps"], id(case["params"]))
    if key not in _STEPS_DONE:
        _STEPS_DONE[key] = _jsteps_of(case)
    return _STEPS_DONE[key]


def _jsteps_of(case):
    cfg = _jcfg(case["cfg"])
    ocfg = jopt.AdamWConfig(**case["opt"])
    step = jtrainer.make_train_step(
        lambda p, b: jtf.lm_loss(p, cfg, b["tokens"], b["labels"], CTX0),
        ocfg, donate=False)
    st = jtrainer.init_train_state(jax.tree.map(jnp.asarray, case["params"]),
                                   ocfg)
    losses = []
    for b in case["batches"][:case["steps"]]:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    flat, _ = jax.tree_util.tree_flatten_with_path(st["params"])
    return losses, {"['params']" + jax.tree_util.keystr(k): np.asarray(v)
                    for k, v in flat}


# ---------------------------------------------------------------------------
# Sharded runs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tp", "fsdp", "zero1"])
def test_sharded_loss_matches_unsharded_reference(cases, run4, name):
    """tests/test_sharded.py:43 (dense TP) and :57 (FSDP, remat full)."""
    case = cases[name]
    np.testing.assert_allclose(run4[name]["loss"],
                               _jloss(case, case["batches"][0]), rtol=2e-5)


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_sharded_grads_match_unsharded_reference(cases, run4, name):
    want = _jgrads(cases[name])
    got = run4[name]["grads"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["tp", "fsdp", "zero1"])
def test_sharded_train_steps_match_reference(cases, run4, name):
    """`make_train_step` run as it is on the sharded leaves (in place):
    each step's loss within rtol 1e-4 of the reference's (as
    tests/test_torch_train.py holds one device: Adam amplifies rounding in
    the parameters, so they are held through the losses they give)."""
    losses, params = _jsteps(cases[name])
    np.testing.assert_allclose(run4[name]["losses"], losses, rtol=1e-4)
    assert set(run4[name]["params"]) == {k.removeprefix("['params']")
                                         for k in params}


def test_layouts_follow_the_specs(run4):
    """FSDP x TP: a stacked layer weight holds half its layers and half
    its columns on a rank; ZeRO-1's moments half the layers of a weight
    whose parameter keeps them all."""
    f, z = run4["fsdp"]["layout"], run4["zero1"]["layout"]
    assert f["['params']['layers']['wq']"][0] == (1, 64, 64)
    assert f["['params']['embed']"][0] == (128, 32)
    assert f["['params']['lm_head']"][0] == (32, 128)
    assert z["['params']['layers']['wq']"][0] == (2, 64, 64)
    assert z["['opt']['m']['layers']['wq']"][0] == (1, 64, 64)
    assert z["['params']['final_norm']"] == ((64,), "plain")
    assert z["['step']"] == ((), "plain")


def test_manual_dp_compressed_convergence(cases, run4):
    """tests/test_sharded.py:119 on a (4,) data mesh: ten int8_ef steps
    end within 0.05 of `make_train_step`'s loss."""
    case = cases["dp"]
    losses, _ = _jsteps(dict(case, steps=10))
    assert abs(run4["dp"]["losses"][-1] - losses[-1]) < 0.05


@pytest.mark.parametrize("method", ["none", "bf16", "int8_ef"])
def test_compressed_psum_is_the_replicas_mean(cases, run4, method):
    """The mean over the 4 replicas of what each puts on the wire: f32,
    bf16, or int8 q times its scale (the reference's arithmetic)."""
    from repro.train import compression as jcomp

    g = cases["dp"]["grads"]
    per = {"none": lambda x: x,
           "bf16": lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16),
                                        np.float32),
           "int8_ef": lambda x: np.asarray(jcomp.dequantize_int8(
               *jcomp.quantize_int8(jnp.asarray(x))))}[method]
    want_w = np.mean([per(x) for x in g], axis=0)
    want_b = np.mean([per(x[0]) for x in g], axis=0)
    got = run4["dp"]["psum"][method]
    tol = dict(rtol=1e-2, atol=1e-2) if method == "bf16" else dict(rtol=1e-6,
                                                                   atol=1e-7)
    np.testing.assert_allclose(got["w"], want_w, **tol)
    np.testing.assert_allclose(got["b"], want_b, **tol)
    if method == "int8_ef":
        me = 0                      # rank 0's error feedback came back
        np.testing.assert_allclose(run4["dp"]["psum"]["err"]["w"],
                                   g[me] - per(g[me]), rtol=1e-6, atol=1e-7)


def test_sharded_embedding_lookup_matches(cases, run4):
    """tests/test_sharded.py:149: bitwise the plain lookup."""
    case, got = cases["lookup"], run4["lookup"]
    np.testing.assert_array_equal(got["sharded"], got["plain"])
    np.testing.assert_allclose(got["sharded"],
                               case["table"][case["ids"]], rtol=1e-6)


def test_din_sharded_loss_and_grads_match_reference(cases, run4):
    case = cases["din"]
    jcfg = jdin.DINConfig(**case["cfg"])
    b = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jdin.loss_fn(p, jcfg, b)))(case["params"])
    np.testing.assert_allclose(run4["din"]["loss"], float(loss), rtol=1e-5,
                               atol=1e-6)
    flat, _ = jax.tree_util.tree_flatten_with_path(g)
    for k, v in flat:
        np.testing.assert_allclose(run4["din"]["grads"][
            jax.tree_util.keystr(k)], np.asarray(v), rtol=1e-5, atol=1e-6,
            err_msg=jax.tree_util.keystr(k))
    assert run4["din"]["layout"]["['item_emb']"][0] == (
        jcfg.n_items // 2, jcfg.embed_dim)


def test_din_sharded_shortlist_matches_single_device(cases, run4):
    """The retrieval shortlist with row-sharded tables (the history lookup
    on the mesh, candidates over the whole table): the same item ids as
    one device's, and the reference's stage (a) of `retrieval_step` (its
    lookup, masked mean and `l2_topk`) as sets."""
    from repro.kernels.l2_topk import l2_topk as jl2_topk
    from repro.models.recsys.embedding import sharded_lookup as jlookup

    got, one = run4["din"]["shortlist"], run4["din"]["shortlist_one"]
    np.testing.assert_array_equal(got, one)
    case = cases["din"]
    jcfg = jdin.DINConfig(**case["cfg"])
    b = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    table = jnp.asarray(case["params"]["item_emb"])
    e = jlookup(table, b["hist_items"], None, None)
    mask = jnp.arange(e.shape[1])[None, :] < b["hist_len"][:, None]
    q = (jnp.sum(jnp.where(mask[..., None], e, 0.0), 1)
         / jnp.maximum(b["hist_len"], 1)[:, None].astype(e.dtype))
    kk = min(jcfg.rerank_k, case["n_candidates"])
    _, want = jl2_topk(q, table[:case["n_candidates"]], kk, backend="ref")
    np.testing.assert_array_equal(np.sort(got, axis=1),
                                  np.sort(np.asarray(want), axis=1))


def test_elastic_restore_into_two_ranks(run4, run2):
    """Saved from the (2, 2) run, restored into a (1, 2) mesh: every leaf
    bitwise the saved one, and the next loss the uninterrupted run's."""
    saved, restored = run4["zero1"]["saved"], run2["restored"]
    assert set(saved) == set(restored)
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    np.testing.assert_allclose(run2["next_loss"], run4["zero1"]["next_loss"],
                               rtol=1e-4)
    assert run2["layout"]["['params']['layers']['wq']"][0] == (2, 64, 64)


def test_rank_failure_raises(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(ranks.fail_on_rank_1, (2,), ("data",), device="cpu",
                  init_method=f"file://{tmp_path / 'init'}", timeout=60,
                  threads=1)


# ---------------------------------------------------------------------------
# Mesh B: sharded decode and prefill, expert-parallel MoE
# ---------------------------------------------------------------------------
_JDECODE: dict = {}


def _jdecode(case, run):
    """The reference's single-device decode step ("local") on the run's
    full cache: (logits, ck, cv, lengths) as numpy."""
    if "fn" not in _JDECODE:
        jcfg = _jcfg(case["cfg"])
        _JDECODE["fn"] = jax.jit(lambda p, t, q, c: jtf.decode_step(
            p, jcfg, t, q, c, CTX0, "local"))
    lg, (ck, cv, ln) = _JDECODE["fn"](case["params"], case["tokens"][:, :1],
                                      run["positions"],
                                      case["caches"][run["cache"]])
    return tuple(np.asarray(a) for a in (lg, ck, cv, ln))


@pytest.mark.parametrize("i", range(len(DECODE_RUNS)), ids=[
    f"{m}-{sh[0]}x{sh[1]}-{c}" for m, sh, c, _ in DECODE_RUNS])
def test_sharded_decode_matches_reference(cases, run4, i):
    """tests/test_sharded.py:93: every rank's logits within rtol / atol
    3e-4 of the reference's single-device step; the cache written at the
    new row only (by the rank whose slice holds it), the lengths new."""
    case = cases["decode"]
    run, got = case["runs"][i], run4["decode"]["runs"][i]
    lg, ck, cv, ln = _jdecode(case, run)
    assert got["logits"].shape == (4,) + lg.shape
    for r in range(4):
        np.testing.assert_allclose(got["logits"][r], lg, rtol=3e-4,
                                   atol=3e-4, err_msg=f"rank {r}")
    np.testing.assert_allclose(got["ck"], ck, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got["cv"], cv, rtol=3e-4, atol=3e-4)
    np.testing.assert_array_equal(got["lengths"], ln)
    if run["cache"] == "prefill":
        assert (got["lengths"] == 17).all()


def test_sharded_decode_blocks_follow_cache_specs(run4):
    """Each rank's cache block: "seq" halves the rows and the sequence on
    (2, 2), quarters the sequence on (1, 4) with both kv heads whole;
    "seq_all" quarters the sequence with every row; "head" halves the
    rows and the kv heads."""
    blocks = {(m, sh): r["block"] for (m, sh, _, _), r in
              zip(DECODE_RUNS, run4["decode"]["runs"])}
    assert blocks[("seq", (2, 2))] == (2, 2, 16, 2, 16)
    assert blocks[("seq", (1, 4))] == (2, 4, 8, 2, 16)
    assert blocks[("seq_all", (2, 2))] == (2, 4, 8, 2, 16)
    assert blocks[("head", (2, 2))] == (2, 2, 32, 1, 16)


def test_sharded_prefill_matches_reference(cases, run4):
    """`serve_prefill(ctx=)`: the last-token logits whole on every rank,
    the "head" cache blocks reassembled, within the LM bar of the
    reference's single-device prefill."""
    lg, ck, cv, ln = cases["decode"]["jprefill"]
    got = run4["decode"]["prefill"]
    for r in range(4):
        np.testing.assert_allclose(got["logits"][r], lg, rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {r}")
    np.testing.assert_allclose(got["ck"], ck, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["cv"], cv, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["lengths"], ln)


def test_moe_sharded_loss_and_grads_match_reference(cases, run4):
    """tests/test_sharded.py:71 (capacities 8.0, groups 2, no slot
    drops): the expert-parallel loss within rtol 2e-5 of the reference's
    unsharded loss, and every gradient leaf, the router's and the
    experts' included, within the LM bar of its unsharded gradient."""
    case = cases["moe"]
    np.testing.assert_allclose(run4["moe"]["loss"],
                               _jloss(case, case["batches"][0]), rtol=2e-5)
    want, got = _jgrads(case), run4["moe"]["grads"]
    assert set(got) == set(want)
    assert "['layers']['we_gate']" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _ref_drops(eids: np.ndarray, mp: int, cfg) -> np.ndarray:
    """(mp, 3) [slots, send drops, expert drops] of each model rank, as
    the reference's `_moe_local` / `_moe_group_local` arithmetic makes
    them: each rank its 1/mp slice of the tokens, in groups; a sender's
    slots to a rank past `cap` (in expert-sorted order) drop, then a
    local expert's received rows past `cap_e`."""
    t_full, k = eids.shape
    e_l = cfg.n_experts_padded // mp
    sl = t_full // mp
    g = max(gg for gg in range(1, min(cfg.groups, sl) + 1) if sl % gg == 0)
    n = sl // g
    out = np.zeros((mp, 3), np.int64)
    for gi in range(g):
        n_slot = n * k
        cap = jmoe._round8(int(cfg.capacity_factor * n_slot / mp))
        cap_e = jmoe._round8(int(cfg.expert_capacity_factor * mp * n_slot
                                 / cfg.n_experts_padded))
        recv = np.zeros((mp, e_l), np.int64)
        for r in range(mp):
            lo = r * sl + gi * n
            s_e = np.sort(eids[lo:lo + n].reshape(-1), kind="stable")
            out[r, 0] += n_slot
            for dest in range(mp):
                to = s_e[s_e // e_l == dest]
                out[r, 1] += max(len(to) - cap, 0)
                recv[dest] += np.bincount(to[:cap] % e_l, minlength=e_l)
        out[:, 2] += np.maximum(recv - cap_e, 0).sum(1)
    return out


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_published_capacities_match_sharded_reference(cases, run4,
                                                          groups):
    """At capacities 1.25 / 1.5 on a batch that drops slots, each rank's
    `moe_ffn(mesh=...)` output within 1e-5 / 1e-6 of the reference's
    sharded body `_moe_local` (the expert stacks split over a vmapped
    "model" axis; its router as `moe_ffn` runs it, its shared expert's
    two column blocks' partials summed),
    for each data rank's rows, and its dropped slots the reference's; the
    aux loss the whole batch's on every rank."""
    case = cases["moe_drop"]
    got = run4["moe_drop"][groups]
    jcfg = jmoe.MoEConfig(**case["moe"], groups=groups)
    p = {k: jnp.asarray(v) for k, v in case["params"].items()}
    mp, e_l = 2, jcfg.n_experts_padded // 2
    body = jax.jit(jax.vmap(functools.partial(
        jmoe._moe_local, cfg=jcfg, model_axis="model", activation="silu"),
        in_axes=(None, None, None, 0, 0, 0), axis_name="model"))
    stacks = [p[k].reshape((mp, e_l) + p[k].shape[1:])
              for k in ("we_gate", "we_in", "we_out")]
    x = case["x"]
    drops = np.zeros((4, 3), np.int64)
    for di in range(2):
        xt = jnp.asarray(x[2 * di:2 * di + 2].reshape(-1, x.shape[-1]))
        gates, eids, _ = jmoe.route(xt, p["router"], jcfg)
        outs = body(xt, gates.astype(xt.dtype), eids, *stacks)
        # the shared expert tensor-parallel as `lm_param_specs` lays it
        # out (columns, then rows, over "model"): its partials summed
        f = p["ws_in"].shape[1] // mp
        shared = sum(jlayers.gated_mlp(
            xt, p["ws_gate"][:, j * f:(j + 1) * f],
            p["ws_in"][:, j * f:(j + 1) * f],
            p["ws_out"][j * f:(j + 1) * f], "silu") for j in range(mp))
        drops[2 * di:2 * di + 2] = _ref_drops(np.asarray(eids), mp, jcfg)
        for mi in range(mp):
            r = 2 * di + mi
            want = np.asarray(outs[mi] + shared).reshape(2, 16, -1)
            np.testing.assert_allclose(got["out"][r], want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r}")
    # the aux loss is the whole batch's, as the reference routes it
    aux = jmoe.route(jnp.asarray(x.reshape(-1, x.shape[-1])), p["router"],
                     jcfg)[2]
    np.testing.assert_allclose(got["aux"], np.full(4, float(aux)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["drops"], drops)
    if groups == 1:                 # the batch drops at both capacities
        assert drops[:, 1].sum() > 0 and drops[:, 2].sum() > 0
    assert drops[:, 1:].sum() > 0


def test_moe_replicated_path_grads_match_reference(cases, run4):
    """Where "model" does not divide a rank's tokens every model rank
    runs them all, its output's gradient scaled by 1/mp: the input's and
    every leaf's gradient (summed over "data") within the LM bar of the
    reference's single-device layer at no-drop capacities, and the
    input's gradient the same on both model ranks."""
    case = cases["moe_grad"]
    jcfg = jmoe.MoEConfig(**case["moe"])

    def loss(x, p):
        out, aux = jmoe.moe_ffn(x, p, jcfg, mesh=None, batch_axes=(),
                                model_axis=None)
        return jnp.sum(out * case["g"]) + aux

    gx, gp = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(case["x"]),
        {k: jnp.asarray(v) for k, v in case["params"].items()})
    got = run4["moe_grad"]
    want = dict({k: np.asarray(v) for k, v in gp.items()}, x=np.asarray(gx))
    assert set(got["grads"]) == set(want)
    for k in want:
        np.testing.assert_allclose(got["grads"][k], want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    xr = got["x_by_rank"]
    np.testing.assert_array_equal(xr[0], xr[1])
    np.testing.assert_array_equal(xr[2], xr[3])


def test_mesh_b_collectives_are_counted(run4):
    """The 4-rank run's all_to_alls (the MoE exchange) and max-reduces
    (the log-sum-exp merge) are counted in `comm_log` by kind."""
    calls = run4["comm"]["calls"]
    assert calls.get("all_to_all", 0) > 0
    assert calls.get("all_reduce_max", 0) > 0


# ---------------------------------------------------------------------------
# Mesh C: the ring ops and the GNN cells' rank program
# ---------------------------------------------------------------------------
def test_ring_ops_on_gloo_match_reference(cases, run4):
    """ring_gather / ring_scatter_add over the 4 gloo ranks of the (2, 2)
    mesh against the reference's on 4 fake XLA devices: the gather's
    forward bitwise, the scatter and both VJPs within 1e-5 (-1 pads in
    the ids); 3 + 4 permutes for the gather, 4 + 3 for the scatter."""
    got, want = run4["ring"], cases["ring"]
    np.testing.assert_array_equal(got["out"], want["out"])
    for k in ("g_table", "s", "g_vals"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert got["permutes"] == 14


def _meshless(arch, cfg, params, batch):
    """(loss, {path: grad}) of the single-device step on the whole batch
    (GraphCast's loss the cells' masked mean)."""
    m = GNN[arch]
    bt = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _, g = loss_and_grads(lambda p, b: (m.loss_fn(p, cfg, b), {}),
                                tree_from_numpy(params, "cpu"), bt)
    return float(loss), {k: v.numpy() for k, v in flatten_with_path(g)}


@pytest.mark.parametrize("name,arch,kind", GNN_RUNS)
def test_gnn_rank_program_matches_meshless(cases, run4, name, arch, kind):
    """The cells' rank program on the (2, 2) mesh, rows and edges split
    over all 4 ranks: loss and every gradient leaf (summed over the
    ranks) within the GNN bar of the single-device step; the ring's
    permutes counted where the ring hooks run, none elsewhere."""
    c = cases["gnn"]
    got = run4["gnn"][name]
    loss, grads = _meshless(arch, c["cfgs"][arch], c["params"][arch],
                            c["batches"][arch])
    assert got["loss"] == pytest.approx(loss, rel=1e-4, abs=1e-5)
    assert set(got["grads"]) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} {k}")
    permutes = got["comm"]["calls"].get("collective-permute", 0)
    assert (permutes > 0) == (kind == "ring"), got["comm"]["calls"]


def test_gnn_cell_step_matches_meshless(cases, run4):
    """One train step of a nequip cell (reduced config, molecule shape of
    40 nodes and 128 edge slots) on the mesh against `make_train_step` on
    one device: the loss within the GNN bar, the step counted, and each
    parameter's AdamW update within 1e-4 of its size (lr 3e-6 at step 1:
    a flipped gradient sign would move it by 6e-6)."""
    c = cases["gnn"]
    cfg = c["cfgs"]["nequip"]
    params = tree_from_numpy(c["params"]["nequip"], "cpu")
    state = init_train_state(params, AdamWConfig())
    step = make_train_step(lambda p, b: (nequip.loss_fn(p, cfg, b), {}),
                           AdamWConfig(), donate=False)
    bt = {k: torch.from_numpy(np.asarray(v)) for k, v in
          c["cell_batch"].items()}
    new, m = step(state, bt)
    got = run4["gnn"]["cell"]
    assert got["step"] == 1
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4, abs=1e-5)
    old = dict(flatten_with_path(params))
    for k, v in flatten_with_path(new["params"]):
        want = (v - old[k]).numpy()
        np.testing.assert_allclose(got["params"][k] - old[k].numpy(), want,
                                   rtol=1e-4, atol=1e-10, err_msg=k)


# ---------------------------------------------------------------------------
# Process-free: specs against the reference's, mesh-less paths unchanged
# ---------------------------------------------------------------------------
LM_ARCHS = sorted(a for a, m in registry.ARCHS.items() if m.FAMILY == "lm")


def _meshes(shape):
    """(the port's stand-in, the reference's): axis names and sizes."""
    names = ("data", "model")
    return (types.SimpleNamespace(mesh_dim_names=names, shape=tuple(shape)),
            types.SimpleNamespace(axis_names=names, devices=np.empty(shape)))


def _port_cfg(jcfg):
    kw = dataclasses.asdict(jcfg)
    if kw["moe"] is not None:
        kw["moe"] = moe.MoEConfig(**kw["moe"])
    return tf.LMConfig(**kw)


def _ref_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: x is None
        or isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(k): None if v is None else tuple(v)
            for k, v in flat}


def _port_flat(specs, path="") -> dict:
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_flat(v, f"{path}[{k!r}]"))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_flat(v, f"{path}[{i}]"))
        return out
    return {path: None if specs is None else tuple(specs)}


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("fsdp", [None, "data"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_match_reference(arch, fsdp, shape):
    jcfg = jregistry.get_arch(arch).model_config(reduced=True)
    pm, jm = _meshes(shape)
    want = jtf.lm_param_specs(jcfg, jtf.ShardCtx(mesh=jm), fsdp_axis=fsdp)
    got = tf.lm_param_specs(_port_cfg(jcfg), tf.ShardCtx(mesh=pm),
                            fsdp_axis=fsdp)
    assert _port_flat(got) == _ref_flat(want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_zero1_specs_match_reference(arch):
    jcfg = jregistry.get_arch(arch).model_config(reduced=True)
    cfg = _port_cfg(jcfg)
    pm, jm = _meshes((2, 2))
    jspecs = jtf.lm_param_specs(jcfg, jtf.ShardCtx(mesh=jm))
    shapes = jax.eval_shape(lambda: jtf.init_lm_params(
        jcfg, jax.random.PRNGKey(0)))
    want = jopt.opt_state_specs(jspecs, zero1=True, params_shapes=shapes,
                                mesh=jm)
    got = opt_state_specs(tf.lm_param_specs(cfg, tf.ShardCtx(mesh=pm)),
                          zero1=True, params_shapes=tf.lm_param_shapes(cfg),
                          mesh=pm)
    assert _port_flat(got) == _ref_flat(want)
    assert any(s is not None and s[0] == "data"
               for s in _port_flat(got["m"]).values())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shapes_match_init(arch):
    cfg = _port_cfg(jregistry.get_arch(arch).model_config(reduced=True))
    params = tf.init_lm_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return None if t is None else tuple(t.shape)

    assert _port_flat(tf.lm_param_shapes(cfg)) == _port_flat(shapes(params))


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_din_param_specs_match_reference(mesh):
    jcfg = jregistry.get_arch("din").model_config(reduced=True)
    pm, jm = _meshes(mesh) if mesh else (None, None)
    want = jdin.param_specs(jcfg, jm)
    got = din.param_specs(din.DINConfig(**dataclasses.asdict(jcfg)), pm)
    if mesh is None:
        assert jax.tree.leaves(want) == []
        assert sharding.map_specs(lambda s, _: s, got, got) == got
        assert all(v is None for v in _port_flat(got).values())
    else:
        assert _port_flat(got) == _ref_flat(want)


def test_shard_ctx_matches_reference():
    pm, jm = _meshes((2, 4))
    ctx, jctx = tf.ShardCtx(mesh=pm), jtf.ShardCtx(mesh=jm)
    assert ctx.batch_axes == jctx.batch_axes == ("data",)
    assert ctx.tp == jctx.tp == 4
    for spec, shape in ((("data", None, "model"), (1, 16, 8)),
                        ((("data", "model"), None), (8, 3)),
                        ((None, "model"), (4, 6)), (("data",), (6,))):
        assert tuple(ctx.sanitize(P(*spec), shape)) == tuple(
            jctx.sanitize(jax.sharding.PartitionSpec(*spec), shape))
    assert tuple(ctx.batch_spec(None, "model")) == tuple(
        jctx.batch_spec(None, "model"))
    assert tf.ShardCtx().tp == 1 and tf.ShardCtx().batch_axes == ()
    assert tf.ShardCtx().constrain(torch.ones(2), P("data")) is not None


def test_placements_follow_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    assert sharding.placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements(mesh, P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.placements(mesh, None) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements(mesh, P(("data", "pod")))
    assert sharding.batch_axes(mesh) == ("pod", "data")
    assert tuple(sharding.spec_batch(mesh, None)) == (("pod", "data"), None)
    assert sharding.dp_size(mesh) == 4 and sharding.tp_size(mesh) == 2
    assert sharding.mesh_size(mesh) == 8
    assert sharding.specs_like({"a": torch.zeros(2, 3), "b": [None]},
                               lambda x: P(*([None] * x.dim()))) == {
        "a": P(None, None), "b": [None]}
    with pytest.raises(ValueError, match="not divisible"):
        sharding.check_divisible(6, 4, "d")


def test_meshless_paths_are_unchanged():
    """ctx=None / mesh=None: bitwise the calls without them."""
    jcfg = jtf.LMConfig(**TP)
    cfg = tf.LMConfig(**TP)
    params = tf.params_from_jax(_twin_params(tuple(TP.items()), 0), cfg,
                                device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (4, 16)))
    labels = toks.roll(-1, 1)
    base = tf.lm_loss(params, cfg, toks, labels)[0]
    for ctx in (None, tf.ShardCtx(), tf.ShardCtx(mesh=None)):
        assert torch.equal(tf.lm_loss(params, cfg, toks, labels, ctx)[0], base)
    assert tf.lm_param_specs(cfg, tf.ShardCtx()) == sharding.map_specs(
        lambda *_: None, tf.lm_param_shapes(cfg), tf.lm_param_shapes(cfg))
    table = torch.randn(64, 6, generator=torch.Generator().manual_seed(0))
    ids = torch.randint(-3, 70, (4, 5), generator=torch.Generator())
    assert torch.equal(sharded_lookup(table, ids, mesh=None, model_axis="model",
                                      batch_axes=("data",)),
                       table[ids.long().clamp(0, 63)])
    dcfg = din.DINConfig(**dataclasses.asdict(
        jregistry.get_arch("din").model_config(reduced=True)))
    model = din.init_params(dcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    keys = ("hist_items", "hist_cates", "hist_len", "target_item",
            "target_cate", "label")
    batch = dict(zip(keys, din_batch(0, 8, dcfg.seq_len, dcfg.n_items,
                                     dcfg.n_cates, seed=0)))
    assert torch.equal(din.loss_fn(model.param_tree(), dcfg, batch),
                       din.loss_fn(model.param_tree(), dcfg, batch,
                                   mesh=None))
    assert jcfg.n_layers == cfg.n_layers
    # serving: prefill and decode with ctx None or mesh-less are the calls
    # without ctx; every kv_mode without a mesh is the single-device step
    lg, (ck, cv), ln = tf.serve_prefill(params, cfg, toks)
    for ctx in (None, tf.ShardCtx()):
        lg2, (ck2, cv2), ln2 = tf.serve_prefill(params, cfg, toks, ctx=ctx)
        assert torch.equal(lg2, lg) and torch.equal(ck2, ck)
        assert torch.equal(cv2, cv) and torch.equal(ln2, ln)
    pos = torch.full((4,), 15)

    def step(mode, ctx):
        c = (ck.clone(), cv.clone(), ln)
        return tf.decode_step(params, cfg, toks[:, :1], pos, c, mode,
                              ctx=ctx)

    base_lg, base_c = step("local", None)
    for mode in ("local", "head", "seq", "seq_all"):
        for ctx in (None, tf.ShardCtx()):
            got_lg, got_c = step(mode, ctx)
            assert torch.equal(got_lg, base_lg), (mode, ctx)
            assert all(torch.equal(a, b) for a, b in zip(got_c, base_c))
    with pytest.raises(ValueError):
        step("rows", None)
    # the MoE FFN: mesh None, or a mesh without the model axis
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1,
                         d_ff_shared=16, pad_multiple=4)
    g = torch.Generator().manual_seed(3)
    mp = {"router": torch.randn(32, 8, generator=g),
          "we_gate": torch.randn(8, 32, 16, generator=g),
          "we_in": torch.randn(8, 32, 16, generator=g),
          "we_out": torch.randn(8, 16, 32, generator=g),
          "ws_gate": torch.randn(32, 16, generator=g),
          "ws_in": torch.randn(32, 16, generator=g),
          "ws_out": torch.randn(16, 32, generator=g)}
    x = torch.randn(2, 8, 32, generator=g)
    out, aux = moe.moe_ffn(x, mp, mcfg)
    data_only = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    for kw in (dict(mesh=None), dict(mesh=None, model_axis="model"),
               dict(mesh=data_only, model_axis="model")):
        o2, a2 = moe.moe_ffn(x, mp, mcfg, **kw)
        assert torch.equal(o2, out) and torch.equal(a2, aux)
    # the GNN models: no hooks and no global counts are the calls with
    # None, with the default hooks and with the batch's own counts
    from repro_torch.models.gnn.common import scatter_rows, take_rows
    c = _gnn_input()
    for arch, m in GNN.items():
        cfg, b = c["cfgs"][arch], c["batches"][arch]
        bt = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        p = tree_from_numpy(c["params"][arch], "cpu")
        fwd = m.forward if arch in ("graphcast", "dimenet") else \
            m.forward_energy
        count = ({"n_edges": len(b["edge_src"])} if arch == "dimenet" else
                 {"n_nodes": len(b["node_feat" if arch == "graphcast"
                                   else "species"])})
        base = fwd(p, cfg, bt)
        none = {"gather_fn": None, "scatter_fn": None,
                **{k: None for k in count}}
        assert torch.equal(fwd(p, cfg, bt, **none), base), arch
        assert torch.equal(fwd(p, cfg, bt, gather_fn=take_rows,
                               scatter_fn=scatter_rows, **count), base), arch
        if arch != "graphcast":
            assert torch.equal(m.loss_fn(p, cfg, bt, **none),
                               m.loss_fn(p, cfg, bt)), arch


@pytest.mark.parametrize("mode", ["head", "seq", "seq_all"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_match_reference(arch, mode):
    jcfg = jregistry.get_arch(arch).model_config(reduced=True)
    for shape in ((2, 2), (4, 2)):
        pm, jm = _meshes(shape)
        want = jtf.cache_specs(jcfg, jtf.ShardCtx(mesh=jm), mode)
        got = tf.cache_specs(_port_cfg(jcfg), tf.ShardCtx(mesh=pm), mode)
        assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert tf.cache_specs(_port_cfg(jcfg), tf.ShardCtx(), mode) == (
        None, None, None)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_decode_partial_matches_reference(dtype):
    """The unnormalized partial and its stats on one shard, lengths 0
    (an empty shard: m at the finite -1e30, l and acc 0), 1, ragged and
    the whole slice; then `shard_lengths` over every shard."""
    rng = np.random.default_rng(9)
    b, h, hkv, s, dh = 4, 8, 2, 12, 16
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    lens = np.array([0, 1, 7, s], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if dtype == "bfloat16":
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
    got = attention._decode_partial(tq, tk, tv, torch.from_numpy(lens),
                                    dh ** -0.5)
    want = j_decode_partial(jq, jk, jv, jnp.asarray(lens), dh ** -0.5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert (got[1][0] == attention.NEG_INF).all()
    assert not got[2][0].any() and not got[0][0].any()
    total = torch.tensor([0, 5, 8, 17, 31, 32])
    for idx in range(4):
        np.testing.assert_array_equal(
            attention.shard_lengths(total, idx, 8).numpy(),
            np.asarray(j_shard_lengths(jnp.asarray(total.numpy()), idx, 8)))