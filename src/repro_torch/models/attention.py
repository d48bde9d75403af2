"""Attention: chunked causal GQA prefill + KV-cache decode (port of
`repro.models.attention`, the single-device path: training, prefill and
decode).

  * `causal_attention`       -- chunked (flash-style) online-softmax loop
                                over KV blocks, plain PyTorch, as plain jnp
                                in the reference (sliding window included);
                                under autograd each query chunk is
                                checkpointed, as the reference's scan body.
  * `decode_attention_local` -- one new token against a KV cache, through
                                `kernels.flash_decode` (the CUDA kernel for
                                CUDA tensors under "auto").

Supports GQA/MQA (h = g * h_kv) and sliding-window attention.  The
sequence-sharded decode (`_decode_partial`, `decode_attention_seqsharded`,
`shard_lengths`) waits for the serving-fleet slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.distances import f32_matmul
from ..kernels.flash_decode import flash_decode

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
