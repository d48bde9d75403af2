"""Decoder-only LM: config, init, prefill + decode (port of
`repro.models.transformer`, the single-device serving path).

Parameters are a dict with the reference's keys and stacked layout: each
per-layer weight is (L, d_in, d_out), applied as `x @ w`, so a JAX
`init_lm_params` tree crosses over without transposes (`params_from_jax`).
Products run in the compute dtype (`cfg.compute_dtype`, IEEE f32 when it
is float32: `core.distances.f32_matmul`); norms, RoPE and attention
arithmetic in f32, as in the reference.

Decode goes through `kernels.flash_decode`: on CUDA tensors under
backend="auto" the split-KV kernel (the reference reaches its Pallas
kernel only under a mesh with kv_mode="head"; on one card that is the
same path with tp = 1), on CPU tensors the plain version.  `decode_step`
writes the new token's K/V into the caches in place and returns them.

MoE layers (`cfg.moe`) run `models.moe.moe_ffn` on one device; serving
drops its aux loss, as the reference's serve path does.

Sharded serving (`ShardCtx`, `lm_param_specs`, `cache_specs`,
`_decode_seqsharded`: kv_mode "seq" / "seq_all") and training
(`forward_hidden`, `lm_loss`, `_layer_scan`, remat) wait for later slices
(ROADMAP Queue 1 items 7.3, 7.4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .._device import resolve_device, to_device
from ..core.distances import f32_matmul
from .attention import causal_attention, decode_attention_local
from .layers import (act_fn, apply_norm, apply_rope, dense_init, embed_init,
                     norm_param)
from .moe import MoEConfig, moe_ffn

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    norm: str = "rmsnorm"            # rmsnorm | rmsnorm_gemma | nonparam_ln
    activation: str = "silu"         # silu (SwiGLU) | gelu_tanh (GeGLU)
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    loss_chunks: int = 8
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def n_params(self) -> int:
        """Total parameter count (dense equivalent; MoE counts all experts)."""
        return self._count(self.moe.n_experts if self.moe else 0)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        return self._count(self.moe.top_k if self.moe else 0)

    def _count(self, experts: int) -> int:
        """Parameters with `experts` routed experts a layer (MoE)."""
        d, v, l = self.d_model, self.vocab, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe:
            m = self.moe
            ffn = (d * m.n_experts  # router
                   + experts * 3 * d * m.d_ff_expert
                   + (3 * d * m.d_ff_shared if m.n_shared else 0))
        else:
            ffn = 3 * d * self.d_ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ffn) + emb


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_lm_params(cfg: LMConfig, generator: torch.Generator,
                   device=None, dtype: torch.dtype = torch.float32) -> dict:
    """Parameters with the reference's initialisation and layout (weights
    N(0, 1/d_in), embedding N(0, 0.02^2), norms at their neutral values;
    MoE: router (L, d, E), experts (L, E_pad, d_in, d_out), the fused
    shared expert), drawn from `generator` (torch's numbers, not
    jax.random's) on its device and stored in `dtype` on `device` (None
    means the CUDA device).  Each matrix is drawn in f32 and stored before
    the next is drawn, so a bf16 model never holds its f32 copy."""
    dev = resolve_device(device)
    d, l = cfg.d_model, cfg.n_layers

    def stack(d_in, d_out, experts=None):
        """(L, [E,] d_in, d_out) in `dtype`, one matrix drawn at a time."""
        lead = (l,) if experts is None else (l, experts)
        out = torch.empty(lead + (d_in, d_out), dtype=dtype, device=dev)
        for w in out.view(-1, d_in, d_out):
            w.copy_(dense_init(generator, d_in, d_out, dev))
        return out

    layers: dict[str, Any] = {
        "attn_norm": _stack_norm(cfg, l, dev, dtype),
        "mlp_norm": _stack_norm(cfg, l, dev, dtype),
        "wq": stack(d, cfg.q_dim),
        "wk": stack(d, cfg.kv_dim),
        "wv": stack(d, cfg.kv_dim),
        "wo": stack(cfg.q_dim, d),
    }
    if cfg.moe:
        m = cfg.moe
        e = m.n_experts_padded
        layers["router"] = stack(d, m.n_experts)
        layers["we_gate"] = stack(d, m.d_ff_expert, e)
        layers["we_in"] = stack(d, m.d_ff_expert, e)
        layers["we_out"] = stack(m.d_ff_expert, d, e)
        if m.n_shared:
            layers["ws_gate"] = stack(d, m.d_ff_shared)
            layers["ws_in"] = stack(d, m.d_ff_shared)
            layers["ws_out"] = stack(m.d_ff_shared, d)
    else:
        layers["w_gate"] = stack(d, cfg.d_ff)
        layers["w_in"] = stack(d, cfg.d_ff)
        layers["w_out"] = stack(cfg.d_ff, d)
    final_norm = norm_param(cfg.norm, d, dev)
    params = {"embed": embed_init(generator, cfg.vocab, d, dev).to(dtype),
              "final_norm": None if final_norm is None
              else final_norm.to(dtype),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, d, cfg.vocab, dev, dtype)
    return params


def _stack_norm(cfg: LMConfig, l: int, device, dtype):
    p = norm_param(cfg.norm, cfg.d_model, device)
    return None if p is None else torch.stack([p] * l).to(dtype)


def params_from_jax(tree: dict, cfg: LMConfig, device=None,
                    dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from the reference's `init_lm_params` tree
    (numpy arrays, or anything `numpy.asarray` reads) on `device` (None
    means the CUDA device), cast to `dtype` where given; no transposes.
    Norm scales are None under nonparam_ln, as in the reference."""
    dev = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: conv(x) for k, x in a.items()}
        return to_device(a, dev, dtype)

    return conv(tree)


def compute_cast(tree, dtype: torch.dtype):
    """Cast every floating tensor of a parameter tree to `dtype` (no copy
    where it already is)."""
    if isinstance(tree, dict):
        return {k: compute_cast(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _layer(layers: dict, li: int) -> dict:
    return {k: None if v is None else v[li] for k, v in layers.items()}


# ---------------------------------------------------------------------------
# Embedding, one layer, head
# ---------------------------------------------------------------------------
def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg: LMConfig) -> torch.Tensor:
    """(V, d) x (B, S) -> (B, S, d) in the compute dtype."""
    out = embed[tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        out = out * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                                 device=out.device)
    return out


def _attn_qkv(x, lp, cfg: LMConfig, positions):
    b, s, _ = x.shape
    h = apply_norm(cfg.norm, x, lp["attn_norm"])
    q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (h @ lp["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(x, lp, cfg: LMConfig):
    """One layer's FFN: the dense gated MLP, or the MoE block (its aux
    loss dropped: serving only)."""
    h = apply_norm(cfg.norm, x, lp["mlp_norm"])
    if cfg.moe:
        return moe_ffn(h, lp, cfg.moe, activation=cfg.activation)[0]
    g = h @ lp["w_gate"].to(h.dtype)
    i = h @ lp["w_in"].to(h.dtype)
    return (act_fn(cfg.activation)(g) * i) @ lp["w_out"].to(h.dtype)


def layer_forward(x, lp, cfg: LMConfig, positions):
    """Full-sequence layer (prefill). Returns (x, (k, v))."""
    q, k, v = _attn_qkv(x, lp, cfg, positions)
    att = causal_attention(q, k, v, q_offset=0, window=cfg.sliding_window,
                           chunk_q=cfg.attn_chunk_q,
                           chunk_kv=cfg.attn_chunk_kv)
    b, s, _, _ = att.shape
    att = att.reshape(b, s, cfg.q_dim)
    x = x + att @ lp["wo"].to(att.dtype)
    return x + _ffn(x, lp, cfg), (k, v)


def lm_head_logits(params, cfg: LMConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def cache_len_for(cfg: LMConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: LMConfig, batch: int, seq_len: int, dtype=None,
               device=None):
    """(k, v) caches (L, B, S_c, Hkv, Dh) of zeros in `dtype` (None: the
    compute dtype) + lengths (B,) int32, on `device` (None: the card)."""
    dev = resolve_device(device)
    sc = cache_len_for(cfg, seq_len)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, sc, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


def serve_prefill(params, cfg: LMConfig, tokens):
    """Prefill: (B, S) -> (last-token logits (B, V), (ck, cv), lengths),
    with caches (L, B, S_c, Hkv, Dh) in the compute dtype.  Under a sliding
    window the cache keeps the trailing window in ring order (slot =
    position % S_c), so that `decode_step`'s ring writes land consistently
    after wraparound."""
    dev = params["embed"].device
    tokens = to_device(tokens, dev)
    b, s = tokens.shape
    sc = cache_len_for(cfg, s)
    layers = compute_cast(params["layers"], cfg.compute_dtype)
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    ck = torch.empty((cfg.n_layers, b, sc, cfg.n_kv_heads, cfg.d_head),
                     dtype=cfg.compute_dtype, device=dev)
    cv = torch.empty_like(ck)
    with f32_matmul():
        x = embed_lookup(params["embed"], tokens, cfg)
        for li in range(cfg.n_layers):
            x, (k, v) = layer_forward(x, _layer(layers, li), cfg, positions)
            if sc < s:
                k, v = k[:, s - sc:], v[:, s - sc:]
                off = (s - sc) % sc
                if off:
                    k = torch.roll(k, off, dims=1)
                    v = torch.roll(v, off, dims=1)
            ck[li], cv[li] = k, v
        x = apply_norm(cfg.norm, x, params["final_norm"])
        logits = lm_head_logits(params, cfg, x[:, -1:])[:, 0]
    lengths = torch.full((b,), sc, dtype=torch.int32, device=dev)
    return logits, (ck, cv), lengths


def _write_cache_local(ck, cv, k_new, v_new, write_pos):
    """Write row write_pos[b] of each batch row b, in place: an index
    write of distinct rows (deterministic).  ck (B, S, Hkv, Dh); k_new
    (B, 1, Hkv, Dh); write_pos (B,)."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    ck[rows, write_pos] = k_new[:, 0].to(ck.dtype)
    cv[rows, write_pos] = v_new[:, 0].to(cv.dtype)


def decode_step(params, cfg: LMConfig, tokens, positions, caches,
                kv_mode: str = "local", backend: str = "auto"):
    """One decode step.

    tokens (B, 1) int; positions (B,) absolute positions of the new token;
    caches = (ck, cv, lengths) with ck/cv (L, B, Sc, Hkv, Dh), contiguous.
    kv_mode "local" or "head" (one card: the same path); backend goes to
    `flash_decode` ("auto": the kernel on CUDA tensors).  Returns (logits
    (B, V), caches): ck and cv are written in place (row position % Sc of
    every layer), lengths are new.
    """
    if kv_mode in ("seq", "seq_all"):
        raise NotImplementedError(
            f"kv_mode={kv_mode!r} (a sequence-sharded cache) waits for the "
            f"sharded slice (ROADMAP Queue 1 item 7.3)")
    if kv_mode not in ("local", "head"):
        raise ValueError(kv_mode)
    ck_all, cv_all, _ = caches
    dev = ck_all.device
    tokens = to_device(tokens, dev)
    positions = to_device(positions, dev)
    b = tokens.shape[0]
    sc = ck_all.shape[2]
    layers = compute_cast(params["layers"], cfg.compute_dtype)
    write_pos = positions % sc                  # ring buffer under SWA
    new_len = torch.clamp(positions + 1, max=sc).to(torch.int32)
    with f32_matmul():
        x = embed_lookup(params["embed"], tokens, cfg)
        for li in range(cfg.n_layers):
            lp = _layer(layers, li)
            q, k, v = _attn_qkv(x, lp, cfg, positions[:, None])
            _write_cache_local(ck_all[li], cv_all[li], k, v, write_pos)
            att = decode_attention_local(q[:, 0], ck_all[li], cv_all[li],
                                         new_len, backend=backend)
            att = att.to(x.dtype).reshape(b, 1, cfg.q_dim)
            x = x + att @ lp["wo"].to(att.dtype)
            x = x + _ffn(x, lp, cfg)
        x = apply_norm(cfg.norm, x, params["final_norm"])
        logits = lm_head_logits(params, cfg, x)[:, 0]
    return logits, (ck_all, cv_all, new_len)
