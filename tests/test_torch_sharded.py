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

Then process-free cases: the port's spec helpers give the reference's
`PartitionSpec`s leaf by leaf (every LM config of the registry, reduced,
with `fsdp_axis` and ZeRO-1; DIN), on mesh stand-ins that carry only
axis names and sizes, and the mesh-less paths are bitwise what they were.
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
from repro.configs import registry as jregistry
from repro.data.synthetic import din_batch, lm_batch
from repro.models import transformer as jtf
from repro.models.recsys import din as jdin
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import din
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.train.optimizer import opt_state_specs
from repro_torch.utils import sharding
from repro_torch.utils.sharding import P

TP = dict(name="tp", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
          d_head=16, d_ff=128, vocab=256, remat="none", loss_chunks=2,
          dtype="float32")
FSDP = dict(TP, name="f", remat="full")
DP = dict(name="c", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
          d_head=8, d_ff=64, vocab=64, remat="none", loss_chunks=2,
          dtype="float32")
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


@functools.lru_cache(maxsize=None)
def _twin_params(cfg_items, seed):
    """Twin parameters: the port's init (the reference's eager init takes
    seconds), as numpy."""
    cfg = tf.LMConfig(**dict(cfg_items))
    return _np(tf.init_lm_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu"))


def _lm_input(cfg: dict, fsdp=None, zero1=False, seed=0):
    toks = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    first = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    rest = [dict(zip(("tokens", "labels"), lm_batch(s, 4, 16, cfg["vocab"],
                                                   seed=0)))
            for s in range(1, STEPS + 1)]
    return {"cfg": cfg, "params": _twin_params(tuple(cfg.items()), seed),
            "fsdp": fsdp, "zero1": zero1, "opt": OPT, "steps": STEPS,
            "batches": [first] + rest}


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


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(3)
    return {"tp": _lm_input(TP), "fsdp": _lm_input(FSDP, fsdp="data"),
            "zero1": dict(_lm_input(TP, zero1=True), ckpt=str(d / "zero1")),
            "lookup": {"table": rng.normal(size=(64, 6)).astype(np.float32),
                       "ids": np.random.default_rng(4).integers(
                           0, 64, (4, 5)).astype(np.int32)},
            "din": _din_input(), "dp": _dp_input()}


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
