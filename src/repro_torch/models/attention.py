"""Attention: chunked causal GQA prefill + KV-cache decode (port of
`repro.models.attention`).

  * `causal_attention`       -- chunked (flash-style) online-softmax loop
                                over KV blocks, plain PyTorch, as plain jnp
                                in the reference (sliding window included);
                                under autograd each query chunk is
                                checkpointed, as the reference's scan body.
  * `decode_attention_local` -- one new token against a KV cache, through
                                `kernels.flash_decode` (the CUDA kernel for
                                CUDA tensors under "auto").

  * `decode_attention_seqsharded` -- one new token against a cache whose
                                sequence is sharded over mesh axes: each
                                rank's partial softmax (`_decode_partial`)
                                merged by a log-sum-exp over the ranks
                                (a max, then one sum of (B, H, Dh + 1)),
                                plain PyTorch, as plain jnp in the
                                reference (it reaches no Pallas kernel).

Supports GQA/MQA (h = g * h_kv) and sliding-window attention.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.distances import f32_matmul
from ..kernels.flash_decode import flash_decode
from ..utils.sharding import all_reduce

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*g, Dh) by head repetition."""
    if g == 1:
        return k
    b, s, hkv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, hkv, g, dh).reshape(
        b, s, hkv * g, dh)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, window: Optional[int] = None,
                     chunk_q: int = 512, chunk_kv: int = 1024,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention, memory-bounded.

    q (B, Sq, H, Dh); k, v (B, Skv, Hkv, Dh).  Query position i attends to
    kv position j iff j <= i + q_offset and (window is None or
    i + q_offset - j < window).  Online softmax over KV chunks keeps the
    live score tile at (B, chunk_q, H, chunk_kv).  The reference pads the
    last chunks and masks the padding; here they are simply shorter.  A KV
    chunk that no query of the chunk may see is skipped: in the reference
    it adds exactly nothing (weights 0, rescale 1).
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    cq = min(chunk_q, sq)
    ck = min(chunk_kv, skv)
    kf = repeat_kv(k, g).float()
    vf = repeat_kv(v, g).float()
    qf = q.float() * scale
    # checkpoint each query chunk under autograd, as the reference does:
    # the backward otherwise holds every chunk's score tiles at once
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for q0 in range(0, sq, cq):
        args = (qf[:, q0:q0 + cq], kf, vf, q_offset + q0, window, ck)
        outs.append(checkpoint(_q_chunk, *args, use_reentrant=False)
                    if remat else _q_chunk(*args))
    return torch.cat(outs, 1).to(q.dtype)


def _q_chunk(qc: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
             q_lo: int, window: Optional[int], ck: int) -> torch.Tensor:
    """Online softmax of the query chunk qc (B, cq, H, Dh), its first row
    at position q_lo, over the KV chunks of kf, vf (B, Skv, H, Dh) f32
    that it may see; returns (B, cq, H, Dh) f32."""
    dev = qc.device
    skv = kf.shape[1]
    q_pos = q_lo + torch.arange(qc.shape[1], device=dev)
    m = torch.full(qc.shape[:3], NEG_INF, device=dev)
    l = torch.zeros(qc.shape[:3], device=dev)
    acc = torch.zeros(qc.shape, device=dev)
    q_hi = q_lo + qc.shape[1] - 1
    with f32_matmul():
        for k0 in range(0, skv, ck):
            k_hi = min(k0 + ck, skv) - 1
            if k0 > q_hi or (window is not None and q_lo - k_hi >= window):
                continue
            kc, vc = kf[:, k0:k0 + ck], vf[:, k0:k0 + ck]
            k_pos = k0 + torch.arange(kc.shape[1], device=dev)
            s = torch.einsum("bqhd,bkhd->bqhk", qc, kc)   # (B, cq, H, ck)
            ok = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                ok &= (q_pos[:, None] - k_pos[None, :]) < window
            ok = ok[None, :, None, :]
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhk,bkhd->bqhd", p, vc)
            m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# Decode (one new token against a KV cache)
# ---------------------------------------------------------------------------
def decode_attention_local(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cache_len: torch.Tensor,
                           backend: str = "auto") -> torch.Tensor:
    """Per-device decode attention. q (B, H, Dh); caches (B, S, Hkv, Dh);
    returns (B, H, Dh) f32."""
    return flash_decode(q, cache_k, cache_v, cache_len, backend=backend)


def _decode_partial(q, cache_k, cache_v, cache_len, scale):
    """Unnormalized local attention + softmax stats for a cross-shard
    merge.  q (B, H, Dh); caches (B, S, Hkv, Dh); cache_len (B,) this
    shard's valid length.  Returns (acc (B, H, Dh) = sum_j exp(s_j - m)
    v_j, m (B, H), l (B, H)), f32.  Masked scores are the finite NEG_INF:
    a shard with no valid row gives m = NEG_INF, l = 0, acc = 0, which
    the merge weighs by exp(NEG_INF - m_glob) = 0 (-inf would give NaN)."""
    b, h, dh = q.shape
    s, hkv = cache_k.shape[1], cache_k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, dh) * scale
    kf = cache_k.float()
    vf = cache_v.float()
    with f32_matmul():
        scores = torch.einsum("bngd,bsnd->bngs", qf, kf)
        ok = (torch.arange(s, device=q.device)[None, :]
              < cache_len.to(q.device)[:, None])[:, None, None, :]
        scores = torch.where(ok, scores, NEG_INF)
        m = scores.amax(-1)                                  # (B, Hkv, G)
        p = torch.where(ok, torch.exp(scores - m[..., None]), 0.0)
        l = p.sum(-1)
        acc = torch.einsum("bngs,bsnd->bngd", p, vf)
    return acc.reshape(b, h, dh), m.reshape(b, h), l.reshape(b, h)


def decode_attention_seqsharded(q, cache_k, cache_v, cache_len, mesh, axes,
                                scale: Optional[float] = None):
    """Decode attention with the KV cache sequence-sharded over the mesh
    `axes` (every rank of them calls, each with its slice and its *local*
    valid length `cache_len`).  Each rank's partial softmax merges with a
    log-sum-exp: the max of m over the ranks, then one sum of (l * w,
    acc * w), w = exp(m - m_glob).  Returns (B, H, Dh) in q's dtype."""
    dh = q.shape[-1]
    scale = dh ** -0.5 if scale is None else scale
    acc, m, l = _decode_partial(q, cache_k, cache_v, cache_len, scale)
    m_glob = all_reduce(m, mesh, axes, op="max")             # (B, H)
    w = torch.exp(m - m_glob)
    # l and acc ride in one sum: (B, H, Dh + 1)
    tot = all_reduce(torch.cat([acc * w[..., None], (l * w)[..., None]], -1),
                     mesh, axes)
    acc_glob, l_glob = tot[..., :dh], tot[..., dh]
    return (acc_glob / l_glob.clamp_min(1e-30)[..., None]).to(q.dtype)


def shard_lengths(total_len: torch.Tensor, shard_idx,
                  shard_size: int) -> torch.Tensor:
    """Local valid length of shard `shard_idx` (of `shard_size` rows) for
    a prefix of `total_len` rows."""
    start = shard_idx * shard_size
    return torch.clamp(total_len - start, 0, shard_size)
