"""The port's flash-decode against the JAX reference (CPU).

The port's plain version (`repro_torch.kernels.flash_decode.flash_decode_ref`)
is held to JAX's Pallas kernel in interpret mode and to its plain
`flash_decode_ref` within rtol = atol = 1e-5 on f32 outputs (the softmax
sums run in other orders; the repo's own interpret-vs-ref bar is 3e-4,
tests/test_kernels.py).  bf16 caches are cast to f32 exactly on every
side, so they are held to the same bar.

At the edges the port follows the Pallas kernel: cache_len = 0 gives zeros
(JAX's plain version gives NaN there), and cache_len > S means all S
positions (JAX's plain version; its Pallas path also counts the zero rows
it pads S with).  The split-KV kernel's per-warp rings and merge are
emulated here with the wrapper's own `split_plan` and `stage_rows` and
checked against the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import flash_decode_ref as jax_flash_decode_ref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.flash_decode.ops import (HEADS_PER_CTA, MAX_SPLITS,
                                                  SMS, WARPS, WAVES,
                                                  ctas_per_sm,
                                                  split_plan, stage_rows)
from repro_torch.kernels.flash_decode.ref import NEG_INF

RNG = np.random.default_rng(14)
TOL = 1e-5

# tests/test_kernels.py's sweep (b, h, hkv, dh, s, ts), G = 1 and G > 1,
# and Dh = 120 (danube's head width) and 16
SWEEP = [(2, 8, 4, 64, 300, 128), (1, 4, 1, 32, 512, 512),
         (3, 16, 16, 64, 200, 64), (2, 8, 2, 128, 1000, 256),
         (2, 8, 2, 120, 333, 128), (3, 4, 4, 16, 77, 128)]


def _case(b, h, hkv, dh, s, bf16=False):
    q = RNG.normal(size=(b, h, dh)).astype(np.float32)
    k = RNG.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = RNG.normal(size=(b, s, hkv, dh)).astype(np.float32)
    if bf16:                            # round to bf16 once, on both sides
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    return q, k, v


def _port(q, k, v, lens, kv_bf16=False, **kw):
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if kv_bf16:
        kt, vt = kt.bfloat16(), vt.bfloat16()
    return flash_decode(torch.from_numpy(q), kt, vt,
                        torch.from_numpy(np.asarray(lens, np.int32)),
                        **kw).numpy()


def _jax(q, k, v, lens, ts, kv_bf16=False):
    """(interpret-mode Pallas kernel, plain version) of the reference."""
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    if kv_bf16:
        kj, vj = kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16)
    lj = jnp.asarray(lens, jnp.int32)
    interp = jax_flash_decode(jnp.asarray(q), kj, vj, lj, ts=ts,
                              backend="interpret")
    ref = jax_flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), lj)
    return np.asarray(interp), np.asarray(ref)


@pytest.mark.parametrize("b,h,hkv,dh,s,ts", SWEEP)
def test_flash_decode_matches_reference(b, h, hkv, dh, s, ts):
    q, k, v = _case(b, h, hkv, dh, s)
    lens = RNG.integers(1, s + 1, b)
    got = _port(q, k, v, lens)
    assert got.dtype == np.float32 and got.shape == (b, h, dh)
    interp, ref = _jax(q, k, v, lens, ts)
    np.testing.assert_allclose(got, interp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,h,hkv,dh,s,ts", [
    (2, 8, 4, 64, 256, 128), (2, 16, 16, 128, 300, 128),
    (1, 8, 2, 120, 129, 64)])
def test_flash_decode_bf16_cache(b, h, hkv, dh, s, ts):
    q, k, v = _case(b, h, hkv, dh, s, bf16=True)
    lens = RNG.integers(1, s + 1, b)
    got = _port(q, k, v, lens, kv_bf16=True)
    interp, ref = _jax(q, k, v, lens, ts, kv_bf16=True)
    np.testing.assert_allclose(got, interp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_flash_decode_bf16_query_upcasts_exactly():
    q, k, v = _case(2, 8, 2, 64, 100)
    qb = torch.from_numpy(q).bfloat16()
    lens = torch.tensor([100, 37], dtype=torch.int32)
    got = flash_decode(qb, torch.from_numpy(k), torch.from_numpy(v), lens)
    want = flash_decode(qb.float(), torch.from_numpy(k), torch.from_numpy(v),
                        lens)
    assert torch.equal(got, want)


def test_flash_decode_cache_len_zero_gives_zeros_like_the_kernel():
    q, k, v = _case(3, 8, 2, 64, 300)
    lens = np.array([0, 5, 0])
    got = _port(q, k, v, lens)
    interp, ref = _jax(q, k, v, lens, 128)
    assert (got[[0, 2]] == 0).all() and (interp[[0, 2]] == 0).all()
    assert np.isnan(ref[[0, 2]]).all()      # the reference's plain version
    np.testing.assert_allclose(got, interp, rtol=TOL, atol=TOL)


def test_flash_decode_cache_len_past_s_clamps_like_the_plain_reference():
    q, k, v = _case(3, 8, 2, 64, 300)
    lens = np.array([400, 300, 301])
    got = _port(q, k, v, lens)
    _, ref = _jax(q, k, v, lens, 128)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _port(q, k, v, [300, 300, 300]),
                               rtol=0, atol=0)


def test_flash_decode_scale_and_gqa_head_map():
    """Query head h reads kv head h // G (q.reshape(Hkv, G, Dh)), and an
    explicit scale replaces Dh^-0.5."""
    b, h, hkv, dh, s = 2, 6, 2, 8, 20
    q, k, v = _case(b, h, hkv, dh, s)
    lens = [20, 9]
    got = _port(q, k, v, lens, scale=0.3)
    for hh in range(h):
        n = hh // (h // hkv)
        for bb in range(b):
            sc = 0.3 * k[bb, :lens[bb], n] @ q[bb, hh]
            w = np.exp(sc - sc.max())
            want = (w / w.sum()) @ v[bb, :lens[bb], n]
            np.testing.assert_allclose(got[bb, hh], want, rtol=1e-5,
                                       atol=1e-6)


def _merge(parts):
    """Log-sum-exp merge of unnormalised (m, l, acc) partials."""
    m_star = max(p_[0] for p_ in parts)
    return (m_star, sum(p_[1] * np.exp(p_[0] - m_star) for p_ in parts),
            sum(p_[2] * np.exp(p_[0] - m_star) for p_ in parts))


def _split_emulation(q, k, v, lens, scale=None):
    """The kernel's algorithm in numpy (float64): per split of
    `split_plan`, the split's stages of `stage_rows` positions dealt to
    WARPS warps in turn, each warp an online softmax over its stages giving
    its own unnormalised (m, l, acc); the warps merged into the split's
    partial, then the log-sum-exp combine of the n_split partials."""
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    n_split, chunk = split_plan(b, hkv, g, s, dh, k.itemsize)
    rows = stage_rows(dh, k.itemsize)
    out = np.zeros((b, h, dh))
    for bb in range(b):
        n_len = min(max(int(lens[bb]), 0), s)
        for hh in range(h):
            n = hh // g
            qs = q[bb, hh].astype(np.float64) * scale
            parts = []
            for sp in range(n_split):
                lo, hi = sp * chunk, min(sp * chunk + chunk, n_len)
                stages = list(range(lo, hi, rows))
                warps = []
                for w in range(WARPS):
                    m, l, acc = NEG_INF, 0.0, np.zeros(dh)
                    for t0 in stages[w::WARPS]:
                        t1 = min(t0 + rows, hi)
                        sc = k[bb, t0:t1, n] @ qs
                        m_new = max(m, sc.max())
                        p = np.exp(sc - m_new)
                        corr = np.exp(m - m_new)
                        l = l * corr + p.sum()
                        acc = acc * corr + p @ v[bb, t0:t1, n]
                        m = m_new
                    warps.append((m, l, acc))
                parts.append(_merge(warps))
            m_star, l_star, o = _merge(parts)
            out[bb, hh] = o / max(l_star, 1e-30)
    return out


@pytest.mark.parametrize("b,h,hkv,dh,s,lens", [
    (2, 8, 2, 16, 1000, [1000, 333]), (1, 4, 4, 8, 4097, [4097]),
    (2, 4, 1, 8, 70, [0, 1]), (3, 2, 2, 8, 65, [65, 80, 64])])
def test_split_kv_merge_matches_plain(b, h, hkv, dh, s, lens):
    q, k, v = _case(b, h, hkv, dh, s)
    got = _split_emulation(q, k, v, lens)
    np.testing.assert_allclose(got, _port(q, k, v, lens), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,hkv,g,s", [
    (8, 16, 1, 32768), (1, 16, 1, 524288), (4, 8, 4, 8192), (8, 16, 1, 1056),
    (1, 1, 1, 1), (2, 2, 20, 300), (1, 1, 1, 10 ** 7), (64, 64, 1, 100)])
def test_split_plan_covers_s_in_whole_tiles(b, hkv, g, s):
    """At Dh = 128 in bf16 (the serving caches): whole tiles of one stage
    per warp, S covered, and a grid of at most WAVES whole waves of
    resident CTAs that, at the serving shapes, no further split would fit
    in."""
    dh, itemsize = 128, 2
    n_split, chunk = split_plan(b, hkv, g, s, dh, itemsize)
    tile = WARPS * stage_rows(dh, itemsize)
    assert stage_rows(dh, itemsize) == 8 and ctas_per_sm(dh, itemsize) == 4
    assert 1 <= n_split <= MAX_SPLITS and chunk % tile == 0
    assert (n_split - 1) * chunk < s <= n_split * chunk
    groups = b * hkv * -(-g // HEADS_PER_CTA)
    wave = WAVES * SMS * ctas_per_sm(dh, itemsize)
    if groups <= wave:
        assert groups * n_split <= wave
    if s in (32768, 524288):  # the serving shapes fill the wave
        assert groups * n_split > wave - groups


def test_flash_decode_dispatch():
    q, k, v = (torch.from_numpy(a) for a in _case(1, 4, 2, 8, 10))
    lens = torch.tensor([10], dtype=torch.int32)
    before = flash_decode.launches
    for backend in ("auto", "ref"):
        torch.testing.assert_close(flash_decode(q, k, v, lens,
                                                backend=backend),
                                   flash_decode_ref(q, k, v, lens))
    assert flash_decode.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, k, v, lens, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        flash_decode(q, k, v, lens, backend="interpret")
