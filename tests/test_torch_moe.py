"""The port's MoE FFN against the JAX reference (CPU, f32).

`route` and `moe_ffn(mesh=None)` get the same seeded numpy inputs in both
packages.  Routes are equal (eids bitwise, padded dead experts never
chosen); gates and the aux loss agree within 1e-6.  The layer's outputs
agree within rtol 1e-5 / atol 1e-6: the expert products and the combine
sum in other orders (XLA's on one side, PyTorch's on the other), at f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.models import moe
from repro_torch.models.transformer import (LMConfig, init_lm_params,
                                            params_from_jax, serve_prefill)

RNG = np.random.default_rng(11)
RTOL, ATOL = 1e-5, 1e-6


def _cfgs(**kw):
    """The same MoE config in both packages."""
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _weights(*shapes):
    """N(0, 1/d_in) weights, d_in the second-to-last axis (`dense_init`)."""
    return tuple((RNG.normal(size=shape) / np.sqrt(shape[-2])).astype(
        np.float32) for shape in shapes)


@pytest.mark.parametrize("n_experts,top_k,pad,t,d", [
    (6, 2, 8, 32, 16), (60, 4, 16, 40, 32), (64, 6, 16, 17, 24),
    (8, 1, 8, 9, 8), (5, 5, 8, 12, 16)])
def test_route_matches_reference(n_experts, top_k, pad, t, d):
    jcfg, cfg = _cfgs(n_experts=n_experts, top_k=top_k, d_ff_expert=8,
                      pad_multiple=pad)
    x = RNG.normal(size=(t, d)).astype(np.float32)
    w = RNG.normal(size=(d, n_experts)).astype(np.float32)
    jg, je, ja = jmoe.route(jnp.asarray(x), jnp.asarray(w), jcfg)
    g, e, a = moe.route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    assert e.dtype == torch.int32 and tuple(e.shape) == (t, top_k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert int(e.max()) < n_experts          # dead padded experts
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(a), float(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities: `jax.lax.top_k` takes the lower index first."""
    jcfg, cfg = _cfgs(n_experts=8, top_k=3, d_ff_expert=8, pad_multiple=8)
    x = np.ones((4, 4), np.float32)
    w = np.zeros((4, 8), np.float32)
    w[:, 5] = w[:, 2] = 1.0                  # experts 2 and 5 tie on top
    je = np.asarray(jmoe.route(jnp.asarray(x), jnp.asarray(w), jcfg)[1])
    e = moe.route(torch.from_numpy(x), torch.from_numpy(w), cfg)[1]
    np.testing.assert_array_equal(e.numpy(), je)
    assert e[0].tolist() == [2, 5, 0]


def _dropped_slots(cfg, eids, t):
    """Slots past their expert's capacity in the reference's layer."""
    n_slot = t * cfg.top_k
    cap_e = moe._round8(int(cfg.expert_capacity_factor * n_slot
                            / cfg.n_experts_padded))
    counts = np.bincount(np.asarray(eids).reshape(-1),
                         minlength=cfg.n_experts_padded)
    return int(np.maximum(counts - cap_e, 0).sum())


@pytest.mark.parametrize("top_k,n_shared,overflow", [
    (1, 0, False), (2, 0, False), (4, 0, False), (2, 1, False),
    (4, 2, False), (2, 0, True), (4, 1, True)])
def test_moe_ffn_matches_reference(top_k, n_shared, overflow):
    n_experts, d, f, b, s = 6, 16, 24, 3, 16
    jcfg, cfg = _cfgs(n_experts=n_experts, top_k=top_k, d_ff_expert=f,
                      n_shared=n_shared, d_ff_shared=32 if n_shared else 0,
                      pad_multiple=8)
    x = RNG.normal(size=(b, s, d)).astype(np.float32)
    router = RNG.normal(size=(d, n_experts)).astype(np.float32)
    if overflow:     # expert 3 is everyone's first choice: it overflows
        router[:, 3] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 2.0
        router[0, 3] = 4.0
    e_pad = jcfg.n_experts_padded
    wg, wi, wo = _weights((e_pad, d, f), (e_pad, d, f), (e_pad, f, d))
    params = {"router": router, "we_gate": wg, "we_in": wi, "we_out": wo}
    if n_shared:
        params.update(zip(("ws_gate", "ws_in", "ws_out"),
                          _weights((d, 32), (d, 32), (32, d))))
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in params.items()},
                              jcfg, mesh=None, batch_axes=(), model_axis=None)
    out, aux = moe.moe_ffn(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in params.items()},
                           cfg)
    eids = jmoe.route(jnp.asarray(x.reshape(-1, d)), jnp.asarray(router),
                      jcfg)[1]
    dropped = _dropped_slots(cfg, eids, b * s)
    assert (dropped > 0) == overflow
    assert out.shape == (b, s, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


def test_moe_ffn_without_a_mesh_is_the_single_device_layer():
    """mesh=None (with or without axes named) is the layer as it was,
    bitwise; the expert-parallel path is tests/test_torch_sharded.py's."""
    _, cfg = _cfgs(n_experts=6, top_k=2, d_ff_expert=24, n_shared=1,
                   d_ff_shared=32, pad_multiple=8)
    x = torch.from_numpy(RNG.normal(size=(3, 16, 16)).astype(np.float32))
    wg, wi, wo = _weights((8, 16, 24), (8, 16, 24), (8, 24, 16))
    sg, si, so = _weights((16, 32), (16, 32), (32, 16))
    params = {k: torch.from_numpy(v) for k, v in zip(
        ("router", "we_gate", "we_in", "we_out", "ws_gate", "ws_in",
         "ws_out"),
        (RNG.normal(size=(16, 6)).astype(np.float32), wg, wi, wo, sg, si,
         so))}
    out, aux = moe.moe_ffn(x, params, cfg)
    for kw in (dict(mesh=None), dict(mesh=None, batch_axes=("data",),
                                     model_axis="model")):
        o2, a2 = moe.moe_ffn(x, params, cfg, **kw)
        assert torch.equal(o2, out) and torch.equal(a2, aux)


def test_one_expert_moe_lm_equals_dense():
    """tests/test_lm.py's one-expert case through `serve_prefill`: a top-1
    MoE over one expert with room for every token is the dense FFN with
    the same weights, and both match the reference's logits."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                d_head=16, d_ff=128, vocab=128, remat="none", loss_chunks=2,
                dtype="float32")
    mkw = dict(n_experts=1, top_k=1, d_ff_expert=128, pad_multiple=1,
               capacity_factor=4.0, expert_capacity_factor=4.0,
               aux_loss_weight=0.0)
    jcfg = jtf.LMConfig(**dict(base, d_ff=0, moe=jmoe.MoEConfig(**mkw)))
    cfg = dataclasses.replace(LMConfig(**base), d_ff=0,
                              moe=moe.MoEConfig(**mkw))
    jp = jtf.init_lm_params(jcfg, jax.random.PRNGKey(2))
    mp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    dense_cfg = LMConfig(**base)
    dp = init_lm_params(dense_cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    lyr = dp["layers"]
    for name in ("gate", "in", "out"):
        lyr[f"w_{name}"] = mp["layers"][f"we_{name}"][:, 0]
    for name in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo"):
        lyr[name] = mp["layers"][name]
    dp.update(embed=mp["embed"], final_norm=mp["final_norm"],
              lm_head=mp["lm_head"])
    toks = RNG.integers(0, 128, (2, 8)).astype(np.int32)
    want = jtf.serve_prefill(jp, jcfg, jnp.asarray(toks),
                             jtf.ShardCtx(mesh=None))[0]
    got_moe = serve_prefill(mp, cfg, toks)[0]
    got_dense = serve_prefill(dp, dense_cfg, toks)[0]
    np.testing.assert_allclose(got_moe.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_moe.numpy(), got_dense.numpy(),
                               rtol=1e-5, atol=1e-6)
