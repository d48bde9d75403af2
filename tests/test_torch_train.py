"""The port's training path against the JAX reference (CPU, f32).

First every test of tests/test_train.py, run on the port.  Then the port
against the reference on the same inputs (numpy, from seeds): the LM loss
and its gradients (dense and MoE, whose routes must be equal), DIN's loss
and gradients, the LR schedule and one AdamW update on the reference's
own gradients, state and parameters, multi-step training losses with and
without gradient accumulation, the int8 quantiser, checkpoints crossing
between the packages in both directions, the data pipeline and a
fault-plan-driven recovery.  Products and sums run in other orders
(XLA's on one side, PyTorch's on the other), so floats agree within the
tolerance each test states; the int8 codes, checkpoints, pipeline
batches and restart counts are equal exactly.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din_cfg as jax_din_cfg
from repro.configs import olmo_1b as jax_olmo_1b
from repro.configs import qwen2_moe_a2_7b as jax_qwen2_moe_a2_7b
from repro.data import pipeline as jpipe
from repro.data.synthetic import din_batch, lm_batch
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.attention import causal_attention as jax_causal_attention
from repro.models.recsys import din as jdin
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import ft as jft
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro.utils.faults import FaultPlan as JFaultPlan
from repro.utils.faults import FaultSpec as JFaultSpec
from repro.utils import tree as jtree
from repro_torch.data import pipeline
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.attention import causal_attention
from repro_torch.models.recsys import din
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression, trainer
from repro_torch.train.compression import (dequantize_int8, ef_compress,
                                           ef_init, quantize_int8)
from repro_torch.train.ft import (FTConfig, resume_or_init, run_loop,
                                  run_with_recovery)
from repro_torch.train.optimizer import (AdamWConfig, adamw_update, lr_at)
from repro_torch.train.trainer import init_train_state, make_train_step
from repro_torch.utils.faults import FaultPlan, FaultSpec
from repro_torch.utils import tree as ttree
from repro_torch.utils.tree import flatten_with_path, leaves, tree_map

CFG = tf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                  d_head=16, d_ff=64, vocab=64, remat="none", loss_chunks=2,
                  dtype="float32")
JCFG = jtf.LMConfig(**dataclasses.asdict(CFG))
OPT = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)
JOPT = jopt.AdamWConfig(**dataclasses.asdict(OPT))
JCTX = jtf.ShardCtx(mesh=None)


def _port_cfg(jcfg):
    kw = dataclasses.asdict(jcfg)
    if kw["moe"] is not None:
        kw["moe"] = moe.MoEConfig(**kw["moe"])
    return tf.LMConfig(**kw)


def loss_fn(params, batch):
    return tf.lm_loss(params, CFG, batch["tokens"], batch["labels"])


def batch_fn(step):
    t, l = lm_batch(step, 4, 8, CFG.vocab, seed=0)
    return {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(l)}


def fresh_state():
    gen = torch.Generator().manual_seed(0)
    return init_train_state(tf.init_lm_params(CFG, gen, device="cpu"), OPT)


def _jax_params(jcfg, seed=0):
    """The same LM parameters in both packages: the port's init (torch's
    draws; cheaper than the reference's eager one), copied to JAX."""
    p = tf.init_lm_params(_port_cfg(jcfg), torch.Generator().manual_seed(seed),
                          device="cpu")
    # copied: JAX on the CPU may alias a numpy buffer, and a donated
    # port step updates `p` in place
    return jax.tree.map(jnp.array, tree_map(lambda x: x.numpy().copy(),
                                            p)), p


def _torch_tree(tree):
    """A JAX tree as CPU tensors, same structure (None stays None)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _by_path(tree):
    """{keystr path: numpy leaf} of a JAX tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _grads(loss, params, *args):
    """(loss, aux, grads) of loss(params, *args) by the trainer's path."""
    return trainer.loss_and_grads(lambda p, a: loss(p, *a), params, args)


# ---------------------------------------------------------------------------
# tests/test_train.py, on the port
# ---------------------------------------------------------------------------
def test_adamw_descends():
    state = fresh_state()
    step = make_train_step(loss_fn, OPT, donate=False)
    losses = []
    for s in range(30):
        state, m = step(state, batch_fn(s % 3))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1


def test_lr_schedule():
    assert float(lr_at(OPT, torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr_at(OPT, torch.tensor(5))) == pytest.approx(OPT.lr)
    assert float(lr_at(OPT, torch.tensor(100))) == pytest.approx(
        OPT.lr * OPT.min_lr_frac, rel=1e-3)


def test_grad_clip_bounds_update():
    state = fresh_state()
    big = tree_map(lambda p: torch.full(p.shape, 100.0), state["params"])
    _, _, m = adamw_update(OPT, big, state["opt"], state["params"])
    assert float(m["grad_norm"]) > OPT.clip_norm


def test_checkpoint_roundtrip(tmp_path):
    state = fresh_state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state)
    assert ckpt.latest_step(d) == 7
    restored, step = ckpt.restore(d, state)
    assert step == 7
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_checkpoint_structure_mismatch_errors(tmp_path):
    state = fresh_state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, state)
    wrong = {"params": state["params"]}
    with pytest.raises(ValueError):
        ckpt.restore(d, wrong)


def test_restart_equivalence(tmp_path):
    """Kill at step k, resume: final state identical to uninterrupted
    (bitwise here; the reference's test holds rtol 1e-6)."""
    step = make_train_step(loss_fn, OPT)
    d = str(tmp_path / "ft")
    ft_cfg = FTConfig(ckpt_dir=d, ckpt_every=4, async_save=False)
    s_a, _ = run_loop(fresh_state(), step, batch_fn, 12, ft_cfg)
    shutil.rmtree(d)
    s_b, _, attempts = run_with_recovery(fresh_state, step, batch_fn, 12,
                                         ft_cfg, fail_at=7)
    assert attempts == 1
    for a, b in zip(leaves(s_a), leaves(s_b)):
        assert torch.equal(a, b)


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "async")
    saver = ckpt.AsyncCheckpointer(d, keep=2)
    state = fresh_state()
    for s in (1, 2, 3):
        saver.save(s, state)
    saver.wait()
    steps = sorted(int(f[5:13]) for f in os.listdir(d)
                   if f.startswith("ckpt_"))
    assert steps == [2, 3]  # gc keeps last 2


def test_async_snapshot_ignores_later_inplace_updates(tmp_path):
    """The snapshot is a host copy: a donated step that rewrites the
    state right after `save` returns does not reach the file."""
    d = str(tmp_path / "snap")
    state = fresh_state()
    want = [x.clone() for x in leaves(state)]
    saver = ckpt.AsyncCheckpointer(d)
    saver.save(1, state)
    for x in leaves(state):
        x.add_(1)
    saver.wait()
    got, _ = ckpt.restore(d, state)
    for a, b in zip(leaves(got), want):
        assert torch.equal(a, b)


def test_int8_quant_roundtrip_error_bounded():
    g = np.random.default_rng(0).normal(size=(128,)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(g))
    back = dequantize_int8(q, s).numpy()
    assert np.abs(back - g).max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates_unbiased():
    """Sum of (dequantized + carried error) equals the true running sum."""
    rng = np.random.default_rng(1)
    tree = {"w": torch.zeros(64)}
    err = ef_init(tree)
    true_sum = np.zeros(64)
    sent_sum = np.zeros(64)
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        true_sum += g["w"].numpy()
        qs, err = ef_compress(g, err)
        q, s = qs["w"]
        sent_sum += dequantize_int8(q, s).numpy()
    np.testing.assert_allclose(sent_sum + err["w"].numpy(), true_sum,
                               rtol=1e-4, atol=1e-4)


def test_resume_or_init_fresh_and_restore(tmp_path):
    d = str(tmp_path / "roi")
    ft_cfg = FTConfig(ckpt_dir=d)
    s0 = resume_or_init(fresh_state, ft_cfg)
    assert int(s0["step"]) == 0
    saved = fresh_state()
    saved["step"].fill_(9)
    ckpt.save(d, 9, saved)
    s1 = resume_or_init(fresh_state, ft_cfg)
    assert ckpt.latest_step(d) == 9 and int(s1["step"]) == 9


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def test_tree_paths_are_keystr_paths():
    tree = {"b": {"w": [np.zeros(1), np.ones(2)], "n": None},
            "a": (np.zeros(3), np.zeros(4)), "c": np.zeros(())}
    assert ([k for k, _ in flatten_with_path(tree)]
            == list(_by_path(tree)))


def test_tree_helpers_match_reference():
    """zeros_like, add, scale, count, bytes, cast and global_norm on the
    same tree (a None node included)."""
    rng = np.random.default_rng(6)
    tree = {"w": [rng.normal(size=(3, 4)).astype(np.float32),
                  rng.normal(size=(5,)).astype(np.float32)],
            "n": None, "b": rng.normal(size=(2, 2)).astype(np.float32)}
    tt, jt = _torch_tree(tree), jax.tree.map(jnp.asarray, tree)
    pairs = [(ttree.tree_zeros_like(tt), jtree.tree_zeros_like(jt)),
             (ttree.tree_add(tt, tt), jtree.tree_add(jt, jt)),
             (ttree.tree_scale(tt, 0.5), jtree.tree_scale(jt, 0.5)),
             (ttree.tree_cast(tt, torch.float16),
              jtree.tree_cast(jt, jnp.float16))]
    for got, want in pairs:
        want = _by_path(want)
        assert [k for k, _ in flatten_with_path(got)] == list(want)
        for k, v in flatten_with_path(got):
            np.testing.assert_array_equal(v.numpy(), want[k])
    assert ttree.tree_count_params(tt) == jtree.tree_count_params(jt) == 21
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt) == 84
    np.testing.assert_allclose(float(ttree.global_norm(tt)),
                               float(jtree.global_norm(jt)), rtol=1e-6)


@pytest.mark.parametrize("jmod", [jax_olmo_1b, jax_qwen2_moe_a2_7b],
                         ids=lambda m: m.ARCH_ID)
def test_lm_loss_and_grads_match_reference(jmod, monkeypatch):
    """f32, reduced config: loss within rtol 1e-5, every gradient leaf
    within rtol 1e-4 / atol 1e-6 (but at most one element in 10,000, held
    to atol 1e-5); MoE routes equal layer by layer."""
    jcfg = jmod.model_config(reduced=True)
    cfg = _port_cfg(jcfg)
    jp, p = _jax_params(jcfg)
    t, l = lm_batch(0, 2, 16, jcfg.vocab, seed=0)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda pp: jtf.lm_loss(pp, jcfg, jnp.asarray(t), jnp.asarray(l),
                               JCTX), has_aux=True))(jp)
    loss, aux, g = _grads(lambda pp, a, b: tf.lm_loss(pp, cfg, a, b), p,
                          torch.from_numpy(t), torch.from_numpy(l))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    want = _by_path(jg)
    got = dict(flatten_with_path(g))
    assert set(got) == set(want)
    # f32 sums that cancel to near 0 round apart in the two packages: at
    # most one element in 10,000 of a leaf may exceed the tolerance, and
    # then by no more than atol 1e-5 (qwen's reduced MoE at this seed: 1
    # of the embedding gradient's 65,536, by 1.1e-6)
    for k, v in got.items():
        d = np.abs(v.numpy() - want[k])
        out = d > 1e-6 + 1e-4 * np.abs(want[k])
        assert out.sum() <= out.size // 10_000, (k, int(out.sum()))
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    if not jcfg.moe:
        return
    # routes: each layer's experts, recorded from both packages' `route`
    # (the reference's through a callback from inside its jitted scan)
    routes = {"jax": [], "port": []}

    def jax_route(*a, **kw):
        out = jroute(*a, **kw)
        jax.debug.callback(lambda e: routes["jax"].append(np.asarray(e)),
                           out[1], ordered=True)
        return out

    def port_route(*a, **kw):
        out = proute(*a, **kw)
        routes["port"].append(out[1].numpy())
        return out

    jroute, proute = jmoe.route, moe.route
    monkeypatch.setattr(jmoe, "route", jax_route)
    monkeypatch.setattr(moe, "route", port_route)
    jax.block_until_ready(jax.jit(lambda pp: jtf.forward_hidden(
        pp, jcfg, jnp.asarray(t), JCTX))(jp))
    jax.effects_barrier()
    with torch.no_grad():
        tf.forward_hidden(p, cfg, torch.from_numpy(t))
    assert len(routes["port"]) == len(routes["jax"]) == jcfg.n_layers
    for a, b in zip(routes["port"], routes["jax"]):
        np.testing.assert_array_equal(a, b)


def test_attention_grads_match_reference():
    """The checkpointed query chunks (several, GQA, a sliding window):
    forward unchanged by autograd, gradients within rtol 1e-4 of
    jax.grad's."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 20, 4, 8), (2, 20, 2, 8), (2, 20, 2, 8)))
    w = rng.normal(size=(2, 20, 4, 8)).astype(np.float32)
    kw = dict(window=7, chunk_q=6, chunk_kv=8)
    jf = lambda *a: jnp.sum(jax_causal_attention(*a, **kw) * w)  # noqa: E731
    jgrads = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = causal_attention(*ts, **kw)
    with torch.no_grad():
        assert torch.equal(out, causal_attention(*ts, **kw))
    tgrads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_din_loss_and_grads_match_reference():
    """Reduced config: loss and every gradient leaf within rtol 1e-5 /
    atol 1e-6."""
    jcfg = jax_din_cfg.model_config(reduced=True)
    cfg = din.DINConfig(**dataclasses.asdict(jcfg))
    model = din.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    jp = jax.tree.map(jnp.array,
                      tree_map(lambda x: x.detach().numpy().copy(),
                               model.param_tree()))
    arrays = din_batch(0, 64, jcfg.seq_len, jcfg.n_items, jcfg.n_cates)
    batch = dict(zip(("hist_items", "hist_cates", "hist_len", "target_item",
                      "target_cate", "label"), arrays))
    jl, jg = jax.jit(jax.value_and_grad(jdin.loss_fn), static_argnums=1)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, g = _grads(lambda pp, b: (din.loss_fn(pp, cfg, b), {}),
                        model.param_tree(), batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = _by_path(jg)
    got = dict(flatten_with_path(g))
    assert set(got) == set(want)
    for k, val in got.items():
        np.testing.assert_allclose(val.numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_din_trainable_switch():
    """Serving tensors stay frozen; `trainable=True` lets the module's own
    parameters take gradients through `loss_fn` on `param_tree()`."""
    cfg = din.DINConfig(**dataclasses.asdict(
        jax_din_cfg.model_config(reduced=True)))
    gen = torch.Generator().manual_seed(0)
    assert not any(p.requires_grad for p in
                   din.init_params(cfg, gen, device="cpu").parameters())
    model = din.init_params(cfg, gen, device="cpu", trainable=True)
    arrays = din_batch(1, 16, cfg.seq_len, cfg.n_items, cfg.n_cates)
    batch = dict(zip(("hist_items", "hist_cates", "hist_len", "target_item",
                      "target_cate", "label"), arrays))
    din.loss_fn(model.param_tree(), cfg, batch).backward()
    assert all(p.grad is not None for p in model.parameters())
    assert ({id(x) for x in leaves(model.param_tree())}
            == {id(x) for x in model.parameters()})


@pytest.mark.parametrize("chunks", [1, 2])
def test_remat_modes_bitwise(chunks):
    """4 layers (2level: 2 groups of 2): "none", "full", "dots" and
    "2level" give the same loss and gradients bit for bit at each
    loss_chunks; 1 and 2 chunks differ only in the loss sum's order
    (within rtol 1e-6)."""
    jcfg = dataclasses.replace(JCFG, n_layers=4)
    _, p = _jax_params(jcfg)
    t, l = lm_batch(1, 2, 8, JCFG.vocab)

    def run(remat, n_chunks):
        cfg = dataclasses.replace(_port_cfg(jcfg), remat=remat,
                                  loss_chunks=n_chunks)
        return _grads(lambda pp, a, b: tf.lm_loss(pp, cfg, a, b), p,
                      torch.from_numpy(t), torch.from_numpy(l))

    base = run("none", chunks)
    for remat in ("full", "dots", "2level"):
        got = run(remat, chunks)
        assert torch.equal(got[0], base[0]), remat
        for a, b in zip(leaves(got[2]), leaves(base[2])):
            assert torch.equal(a, b), remat
    other = run("none", 3 - chunks)
    np.testing.assert_allclose(float(other[0]), float(base[0]), rtol=1e-6)
    for a, b in zip(leaves(other[2]), leaves(base[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-8)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    cfg = dataclasses.replace(OPT, schedule=schedule)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(cfg.total_steps + 1, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jcfg, s))(steps))
    got = np.array([float(lr_at(cfg, torch.tensor(int(s)))) for s in steps],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_update_matches_reference():
    """Two updates (clipped; the second from nonzero moments) on the
    reference's own gradients, state and parameters: params, m and v
    within rtol 1e-6 / atol 1e-8, in place and not."""
    jcfg = jax_olmo_1b.model_config(reduced=True)
    jp, _ = _jax_params(jcfg)
    grad = jax.jit(jax.grad(lambda pp, t, l: jtf.lm_loss(
        pp, jcfg, t, l, JCTX)[0]))
    jstate = jopt.adamw_init(jp)
    for s in range(2):
        jgr = grad(jp, *lm_batch(s, 2, 16, jcfg.vocab))
        p, g = _torch_tree(jp), _torch_tree(jgr)
        st = {"m": _torch_tree(jstate["m"]), "v": _torch_tree(jstate["v"]),
              "count": torch.tensor(int(jstate["count"]), dtype=torch.int32)}
        jp, jstate, jm = jopt.adamw_update(JOPT, jgr, jstate, jp)
        for inplace in (False, True):
            st_i = tree_map(torch.clone, st)
            p_i = tree_map(torch.clone, p)
            new_p, new_st, m = adamw_update(OPT, g, st_i, p_i, inplace=inplace)
            for got, want in ((new_p, jp), (new_st["m"], jstate["m"]),
                              (new_st["v"], jstate["v"])):
                want = _by_path(want)
                for k, v in flatten_with_path(got):
                    np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6,
                                               atol=1e-8, err_msg=k)
            assert int(new_st["count"]) == int(jstate["count"])
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
            if inplace:
                assert new_p["embed"] is p_i["embed"]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    """5 steps of make_train_step from the same parameters and batches:
    losses within rtol 1e-4 of the reference's jitted step's."""
    jp, p = _jax_params(JCFG)
    jstep = jtrainer.make_train_step(
        lambda pp, b: jtf.lm_loss(pp, JCFG, b["tokens"], b["labels"], JCTX),
        JOPT, accum=accum, donate=False)
    step = make_train_step(loss_fn, OPT, accum=accum)
    js, st = jtrainer.init_train_state(jp, JOPT), init_train_state(p, OPT)
    for s in range(5):
        b = batch_fn(s)
        js, jm = jstep(js, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        st, m = step(st, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(st["step"]) == int(js["step"]) == 5


def test_quantize_int8_matches_reference():
    """q bitwise (both round half to even), scale within 1e-7."""
    rng = np.random.default_rng(4)
    for g in (rng.normal(size=(257,)).astype(np.float32),
              (rng.integers(-8, 9, (64, 3)) / 2).astype(np.float32)):
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        q, s = quantize_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert abs(float(s) - float(js)) <= 1e-7
        np.testing.assert_array_equal(
            compression.compress_bf16({"g": torch.from_numpy(g)})["g"]
            .float().numpy(),
            np.asarray(jcomp.compress_bf16({"g": jnp.asarray(g)})["g"]
                       .astype(jnp.float32)))


def _twin_states():
    """The same fresh train state in both packages (OLMo's reduced config:
    its norms are None, nodes without leaves)."""
    jp, p = _jax_params(jax_olmo_1b.model_config(reduced=True))
    js = jtrainer.init_train_state(jp, JOPT)
    st = init_train_state(p, OPT)
    return js, st


def _dir_contents(d):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "ckpt_00000003.npz")) as z:
        return manifest, {k: z[k] for k in z.files}


def test_checkpoint_crosses_from_reference(tmp_path):
    js, st = _twin_states()
    d = str(tmp_path / "from_jax")
    jckpt.save(d, 3, js)
    got, step = ckpt.restore(d, st)
    assert step == 3
    want = _by_path(js)
    flat = flatten_with_path(got)
    assert [k for k, _ in flat] == list(want)
    for (k, v), (_, like) in zip(flat, flatten_with_path(st)):
        assert v.dtype == like.dtype
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_checkpoint_crosses_to_reference(tmp_path):
    """Port save -> reference restore; and the two packages' files of the
    same state are equal: keys, manifest.json and arrays, bitwise."""
    js, st = _twin_states()
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save(d_port, 3, st)
    jckpt.save(d_jax, 3, js)
    host, step = jckpt.restore(d_port, js)
    assert step == 3
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    (m_port, a_port), (m_jax, a_jax) = _dir_contents(d_port), \
        _dir_contents(d_jax)
    assert m_port == m_jax
    assert list(a_port) == list(a_jax)
    for k in a_jax:
        assert a_port[k].dtype == a_jax[k].dtype
        np.testing.assert_array_equal(a_port[k], a_jax[k])


def test_checkpoint_reads_compressed_and_refuses_corrupt(tmp_path):
    """`np.savez_compressed` members restore too; a flipped byte in a
    stored member's data fails its CRC-32 check."""
    state = fresh_state()
    d = tmp_path / "z"
    d.mkdir()
    np.savez_compressed(d / "ckpt_00000002.npz",
                        **{k: v.numpy() for k, v in flatten_with_path(state)})
    got, _ = ckpt.restore(str(d), state, step=2)
    for a, b in zip(leaves(got), leaves(state)):
        assert torch.equal(a, b)
    path = ckpt.save(str(d), 3, state)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ckpt.restore(str(d), state, step=3)


def test_checkpoint_refuses_bf16(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path / "bf16"), 1,
                  {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_pipeline_matches_reference():
    def make(step):
        t, l = lm_batch(step, 8, 4, 50, seed=2)
        return {"tokens": t, "labels": l}

    for shard in (None, (1, 4)):
        jp_ = jpipe.ShardedPipeline(
            make, shard_fn=jpipe.shard_rows(*shard) if shard else None)
        p_ = pipeline.ShardedPipeline(
            make, shard_fn=pipeline.shard_rows(*shard) if shard else None)
        got = list(p_.iterate(3, 5))
        want = list(jp_.iterate(3, 5))
        assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5, 6, 7]
        for (_, a), (_, b) in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
        a, b = p_.batch_at(9), jp_.batch_at(9)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_recovery_under_fault_plan_matches_reference(tmp_path):
    """A seeded step_fail_rate plan: the same restart count and final step
    in both packages, and the final parameters' losses within rtol 1e-4."""
    spec = dict(step_fail_rate=0.25)
    jplan = JFaultPlan(JFaultSpec(**spec), seed=5)
    plan = FaultPlan(FaultSpec(**spec), seed=5)
    n = 8
    fails = [s for s in range(1, n + 1) if plan.fail_step(s, 0)]
    assert fails, "the plan must fail at least one step on attempt 0"
    jp, p = _jax_params(JCFG)
    jstep = jtrainer.make_train_step(
        lambda pp, b: jtf.lm_loss(pp, JCFG, b["tokens"], b["labels"], JCTX),
        JOPT, donate=False)

    def jbatch(s):
        return {k: jnp.asarray(v.numpy()) for k, v in batch_fn(s).items()}

    jres = jft.run_with_recovery(
        lambda: jtrainer.init_train_state(jp, JOPT), jstep, jbatch, n,
        jft.FTConfig(ckpt_dir=str(tmp_path / "j"), ckpt_every=2,
                     async_save=False), fault_plan=jplan, max_restarts=8)
    res = run_with_recovery(
        lambda: init_train_state(tree_map(torch.clone, p), OPT),
        make_train_step(loss_fn, OPT), batch_fn, n,
        FTConfig(ckpt_dir=str(tmp_path / "p"), ckpt_every=2),
        fault_plan=plan, max_restarts=8)
    assert res[2] == jres[2] >= 1
    assert int(res[0]["step"]) == int(jres[0]["step"]) == n
    # Adam amplifies rounding in the parameters: compare the final losses
    b = batch_fn(n)
    with torch.no_grad():
        got = loss_fn(res[0]["params"], b)[0]
    want = jtf.lm_loss(jres[0]["params"], JCFG, jnp.asarray(b["tokens"]),
                       jnp.asarray(b["labels"]), JCTX)[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
