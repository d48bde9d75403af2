"""The port's LM serving path against the JAX reference (CPU, f32).

JAX's `init_lm_params` tree crosses over with `params_from_jax`, so both
packages compute the same function; products and softmax sums run in
other orders (XLA's on one side, PyTorch's on the other), so float
outputs agree within rtol = 1e-4 / atol = 1e-5, and greedy tokens are
equal.  The decode path runs the port's `flash_decode` through its plain
version here (CPU tensors under backend="auto"); the card's kernel is
held to that plain version in tests/test_torch_cuda_kernels.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as jax_gemma_7b
from repro.configs import h2o_danube3_4b as jax_h2o_danube3_4b
from repro.configs import moonshot_v1_16b_a3b as jax_moonshot_v1_16b_a3b
from repro.configs import olmo_1b as jax_olmo_1b
from repro.configs import qwen2_moe_a2_7b as jax_qwen2_moe_a2_7b
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.attention import causal_attention as jax_causal_attention
from repro_torch.configs import olmo_1b, qwen2_moe_a2_7b
from repro_torch.configs.base import LM_SHAPES
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import layers
from repro_torch.models.attention import causal_attention
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import (LMConfig, decode_step,
                                            init_cache, init_lm_params,
                                            params_from_jax, serve_prefill)

RNG = np.random.default_rng(7)
RTOL, ATOL = 1e-4, 1e-5
CTX = jtf.ShardCtx(mesh=None)


def _jcfg(**kw):
    """tests/test_lm.py's `_cfg`."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=128, vocab=128, remat="none", loss_chunks=2,
                dtype="float32")
    base.update(kw)
    return jtf.LMConfig(**base)


def _port_cfg(jcfg):
    kw = dataclasses.asdict(jcfg)
    if kw["moe"] is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    return LMConfig(**kw)


CONFIGS = {"test_lm": _jcfg()} | {
    f"{m.ARCH_ID}_reduced": m.model_config(reduced=True)
    for m in (jax_olmo_1b, jax_gemma_7b, jax_h2o_danube3_4b,
              jax_qwen2_moe_a2_7b, jax_moonshot_v1_16b_a3b)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm(request):
    """(JAX config, JAX params, port config, port params)."""
    jcfg = CONFIGS[request.param]
    jp = jtf.init_lm_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    cfg = _port_cfg(jcfg)
    return jcfg, jp, cfg, params_from_jax(tree, cfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_gemma", "nonparam_ln"])
def test_norms_match_reference(kind):
    x = (RNG.normal(size=(4, 5, 32)) * 3 + 1).astype(np.float32)
    p = RNG.normal(size=32).astype(np.float32) if kind != "nonparam_ln" \
        else None
    want = jlayers.apply_norm(kind, jnp.asarray(x),
                              None if p is None else jnp.asarray(p))
    got = layers.apply_norm(kind, torch.from_numpy(x),
                            None if p is None else torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (layers.norm_param(kind, 8) is None) == (kind == "nonparam_ln")


@pytest.mark.parametrize("activation", ["silu", "gelu", "gelu_tanh", "relu"])
def test_gated_mlp_matches_reference(activation):
    x, wg, wi, wo = (RNG.normal(size=shape).astype(np.float32) * 0.5
                     for shape in ((6, 16), (16, 24), (16, 24), (24, 16)))
    want = jlayers.gated_mlp(*map(jnp.asarray, (x, wg, wi, wo)), activation)
    got = layers.gated_mlp(*map(torch.from_numpy, (x, wg, wi, wo)),
                           activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_apply_rope_matches_reference():
    x = RNG.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = RNG.integers(0, 1000, (2, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        layers.rope_frequencies(16).numpy(),
        np.asarray(jlayers.rope_frequencies(16)), rtol=1e-6)


@pytest.mark.parametrize("window,q_offset,chunks", [
    (None, 0, (8, 16)), (5, 0, (8, 16)), (None, 3, (5, 7)), (4, 3, (64, 64)),
    (None, 0, (512, 1024))])
def test_causal_attention_matches_reference(window, q_offset, chunks):
    b, sq, skv, h, hkv, dh = 2, 29, 32, 4, 2, 16
    q = RNG.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = RNG.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = RNG.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    kw = dict(q_offset=q_offset, window=window, chunk_q=chunks[0],
              chunk_kv=chunks[1])
    want = jax_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    got = causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_serve_prefill_matches_reference(lm):
    jcfg, jp, cfg, params = lm
    toks = RNG.integers(0, cfg.vocab, (3, 11)).astype(np.int32)
    jl, (jk, jv), jlen = jtf.serve_prefill(jp, jcfg, jnp.asarray(toks), CTX)
    logits, (ck, cv), lengths = serve_prefill(params, cfg, toks)
    assert logits.shape == (3, cfg.vocab) and logits.dtype == torch.float32
    _close(logits, jl)
    _close(ck, jk)
    _close(cv, jv)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))


def _jax_greedy_with_logits(jcfg, jp, prompt, n_new, cache_size):
    """tests/test_lm.py's `_greedy_decode`, keeping each step's logits."""
    b, s = prompt.shape
    logits, (ck, cv), lens = jtf.serve_prefill(jp, jcfg, jnp.asarray(prompt),
                                               CTX)
    ck0, cv0, _ = jtf.init_cache(jcfg, b, cache_size, dtype=ck.dtype)
    sc = ck.shape[2]
    caches = (ck0.at[:, :, :sc].set(ck), cv0.at[:, :, :sc].set(cv), lens)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks = []
    for i in range(n_new):
        toks.append(np.asarray(tok))
        logits, caches = jtf.decode_step(jp, jcfg, tok, jnp.full((b,), s + i,
                                                                 jnp.int32),
                                         caches, CTX, "local")
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return out, toks


def _prefill_into_cache(cfg, params, prompt, cache_size):
    logits, (ck, cv), lens = serve_prefill(params, cfg, prompt)
    b = prompt.shape[0]
    ck0, cv0, _ = init_cache(cfg, b, cache_size, dtype=ck.dtype,
                             device="cpu")
    sc = ck.shape[2]
    ck0[:, :, :sc], cv0[:, :, :sc] = ck, cv
    return logits, (ck0, cv0, lens)


def test_greedy_decode_matches_reference_every_step(lm):
    jcfg, jp, cfg, params = lm
    prompt = RNG.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    want, jtoks = _jax_greedy_with_logits(jcfg, jp, prompt, 4, 16)
    logits, caches = _prefill_into_cache(cfg, params, prompt, 16)
    before = flash_decode.launches
    for i, tok in enumerate(jtoks):
        _close(logits, want[i])
        np.testing.assert_array_equal(logits.argmax(-1).numpy()[:, None], tok)
        logits, caches = decode_step(params, cfg, tok, np.full(2, 9 + i,
                                                               np.int32),
                                     caches)
        assert caches[2].tolist() == [10 + i] * 2
    _close(logits, want[-1])
    assert flash_decode.launches == before         # the plain version, CPU


def _greedy(cfg, params, prompt, n_new, cache_size):
    b, s = prompt.shape
    logits, caches = _prefill_into_cache(cfg, params, prompt, cache_size)
    out = []
    tok = logits.argmax(-1)[:, None].int()
    for i in range(n_new):
        out.append(tok)
        logits, caches = decode_step(params, cfg, tok,
                                     torch.full((b,), s + i,
                                                dtype=torch.int32), caches)
        tok = logits.argmax(-1)[:, None].int()
    return torch.cat(out, 1)


@pytest.mark.parametrize("window", [None, 8])
def test_decode_matches_teacher_forced_prefill(window):
    """tests/test_lm.py's two properties on the port: greedy decode token t
    is the argmax of a fresh prefill over the extended sequence, also
    through a window-sized SWA ring cache after it wraps."""
    jcfg = _jcfg(sliding_window=window)
    cfg = _port_cfg(jcfg)
    gen = torch.Generator().manual_seed(1)
    params = init_lm_params(cfg, gen, device="cpu")
    prompt = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 20))).int()
    cache = 32 if window is None else window
    if window is not None:
        assert serve_prefill(params, cfg, prompt)[1][0].shape[2] == window
    gen_toks = _greedy(cfg, params, prompt, 4, cache_size=cache)
    seq = prompt
    for i in range(4):
        logits, _, _ = serve_prefill(params, cfg, seq)
        nxt = logits.argmax(-1)[:, None].int()
        assert torch.equal(nxt, gen_toks[:, i:i + 1])
        seq = torch.cat([seq, nxt], 1)


def test_swa_ring_caches_match_reference():
    """Prefill past the window keeps the trailing window in ring order,
    and a decode step writes slot position % window, as in JAX."""
    jcfg = _jcfg(sliding_window=8)
    cfg = _port_cfg(jcfg)
    jp = jtf.init_lm_params(jcfg, jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = RNG.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    jl, (jk, jv), jlen = jtf.serve_prefill(jp, jcfg, jnp.asarray(toks), CTX)
    logits, (ck, cv), lens = serve_prefill(params, cfg, toks)
    _close(logits, jl)
    _close(ck, jk)
    _close(cv, jv)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    pos = np.full(2, 21, np.int32)
    jl2, (jk2, _, jlen2) = jtf.decode_step(jp, jcfg, jnp.asarray(tok),
                                           jnp.asarray(pos),
                                           (jk, jv, jlen), CTX, "local")
    l2, (ck2, _, len2) = decode_step(params, cfg, tok, pos, (ck, cv, lens))
    _close(l2, jl2)
    _close(ck2, jk2)
    np.testing.assert_array_equal(len2.numpy(), np.asarray(jlen2))


def _rope_frequencies_eager(dh, theta=10000.0, _jax=jlayers.rope_frequencies):
    """The reference's RoPE frequencies, evaluated op by op.  Traced into
    the decode scan, XLA's CPU `pow` misses three of reduced Danube's
    eight by one f32 ulp, and at position 524,287 one ulp turns an angle
    by up to 0.03 rad; evaluated alone they equal the port's bitwise."""
    with jax.ensure_compile_time_eval():
        return _jax(dh, theta)


def test_rope_at_long_500k_position_is_exact():
    x = RNG.normal(size=(2, 1, 8, 16)).astype(np.float32)
    pos = np.full((2, 1), LM_SHAPES["long_500k"].seq_len - 1, np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    ang = (pos[..., None].astype(np.float32)
           * layers.rope_frequencies(16).numpy()).astype(np.float64)
    cos, sin = np.cos(ang)[..., None, :], np.sin(ang)[..., None, :]
    x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
    want = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(layers.rope_frequencies(16).numpy(),
                                  np.asarray(_rope_frequencies_eager(16)))


def test_danube_decode_at_long_500k_position_matches_reference(monkeypatch):
    """Reduced h2o-danube-3-4b decodes at position 524,287 (long_500k's
    last) through its 64-slot ring cache, as the reference does: the
    write lands in slot 524,287 % 64 and every slot is read.  The
    reference's RoPE frequencies are evaluated op by op
    (`_rope_frequencies_eager`)."""
    monkeypatch.setattr(jlayers, "rope_frequencies", _rope_frequencies_eager)
    jcfg = jax_h2o_danube3_4b.model_config(reduced=True)
    cfg = _port_cfg(jcfg)
    jp = jtf.init_lm_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    b, pos = 2, LM_SHAPES["long_500k"].seq_len - 1
    shape = (cfg.n_layers, b, cfg.sliding_window, cfg.n_kv_heads,
             cfg.d_head)
    ck, cv = (RNG.normal(size=shape).astype(np.float32) for _ in range(2))
    lens = np.full(b, cfg.sliding_window, np.int32)
    tok = RNG.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    positions = np.full(b, pos, np.int32)
    jl, (jk, jv, jlen) = jtf.decode_step(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(positions),
        (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lens)), CTX, "local")
    caches = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
              torch.from_numpy(lens))
    logits, (k2, v2, len2) = decode_step(params, cfg, tok, positions, caches,
                                         kv_mode="local")
    _close(logits, jl)
    _close(k2, jk)
    _close(v2, jv)
    np.testing.assert_array_equal(len2.numpy(), np.asarray(jlen))
    slot = pos % cfg.sliding_window
    assert not np.allclose(k2[:, :, slot].numpy(), ck[:, :, slot])
    np.testing.assert_array_equal(np.delete(k2.numpy(), slot, axis=2),
                                  np.delete(ck, slot, axis=2))


@pytest.mark.parametrize("step,batch,seq_len,vocab,seed", [
    (0, 8, 1024, 50304, 0), (3, 2, 17, 128, 5)])
def test_lm_batch_is_bitwise_equal(step, batch, seq_len, vocab, seed):
    got = lm_batch(step, batch, seq_len, vocab, seed)
    want = jax_lm_batch(step, batch, seq_len, vocab, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_init_lm_params_shapes_and_std():
    cfg = olmo_1b.model_config(reduced=True)
    jcfg = jax_olmo_1b.model_config(reduced=True)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = jax.eval_shape(lambda: jtf.init_lm_params(
        jcfg, jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == 9                   # nonparam_ln: no norm scales
    for path, sds in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == sds.shape and t.dtype == torch.float32
    assert params["final_norm"] is None
    assert params["layers"]["attn_norm"] is None
    lyr = params["layers"]
    for name, d_in in (("wq", 128), ("w_gate", 128), ("w_out", 256)):
        assert abs(float(lyr[name].std()) * d_in ** 0.5 - 1) < 0.05
    assert abs(float(params["embed"].std()) / 0.02 - 1) < 0.05
    assert cfg.n_params() == jcfg.n_params()


def test_olmo_configs_match_reference():
    for reduced in (False, True):
        got = olmo_1b.model_config(reduced)
        want = jax_olmo_1b.model_config(reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = olmo_1b.model_config()
    assert full.compute_dtype == torch.bfloat16
    assert olmo_1b.SHAPES is LM_SHAPES
    assert LM_SHAPES["decode_32k"].seq_len == 32768


def test_modes_without_a_mesh_are_the_local_step():
    """Without a mesh every kv_mode is the single-device step, as in the
    reference ("head" on one card is it with tp = 1; "seq" and "seq_all"
    shard nothing there); an unknown mode raises.  The sharded modes are
    tests/test_torch_sharded.py's."""
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    _, caches = _prefill_into_cache(cfg, params, prompt, 8)

    def step(mode):
        c = tuple(t.clone() for t in caches)
        return decode_step(params, cfg, prompt[:, :1], torch.tensor([4]), c,
                           kv_mode=mode)

    out = step("head")
    assert out[0].shape == (1, cfg.vocab)
    for mode in ("local", "seq", "seq_all"):
        got = step(mode)
        assert torch.equal(got[0], out[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], out[1]))
    with pytest.raises(ValueError):
        step("rows")
    # MoE layers are ported: a reduced MoE config initialises and decodes
    moe_cfg = qwen2_moe_a2_7b.model_config(reduced=True)
    moe_params = init_lm_params(moe_cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    _, caches = _prefill_into_cache(moe_cfg, moe_params, prompt, 8)
    logits, _ = decode_step(moe_params, moe_cfg, prompt[:, :1],
                            torch.tensor([4]), caches)
    assert logits.shape == (1, moe_cfg.vocab)
    assert bool(torch.isfinite(logits).all())
