"""Shared neural building blocks (port of the parts of
`repro.models.layers` that DIN and the LMs need, training included).

Norms and RoPE run in f32 and cast back to the input's dtype, as in the
reference.  Sharding constraints are `ShardCtx.constrain`
(`models.transformer`); `softmax_xent_chunked` takes logits sharded on
the vocabulary (`vocab_shard`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils.sharding import all_reduce, reduce_from


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6,
            offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32; `offset`=1.0 gives the gemma (1+scale) convention."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (offset + scale.float())
    return y.to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: normalize (population variance),
    no scale/bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, scale, **kw) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, scale, **kw)
    if kind == "rmsnorm_gemma":
        return rmsnorm(x, scale, offset=1.0, **kw)
    if kind == "nonparam_ln":
        return nonparam_layernorm(x)
    raise ValueError(kind)


def norm_param(kind: str, d: int, device=None) -> torch.Tensor | None:
    if kind == "nonparam_ln":
        return None
    if kind == "rmsnorm_gemma":
        return torch.zeros((d,), device=device)   # (1 + scale) convention
    return torch.ones((d,), device=device)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(kind: str):
    """`jax.nn.gelu` approximates with tanh by default, so "gelu" does too."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "gelu_tanh": _gelu_tanh,
            "relu": torch.relu}[kind]


def gated_mlp(x: torch.Tensor, w_gate, w_in, w_out,
              activation: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU: act(x @ w_gate) * (x @ w_in) @ w_out."""
    g = act_fn(activation)(x @ w_gate)
    return (g * (x @ w_in)) @ w_out


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(dh: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(dh//2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) int -> rotated x (split halves
    convention, matching llama/gemma reference implementations); angles
    in f32."""
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, x.device)              # (dh/2,)
    ang = positions[..., None].float() * inv                 # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """A (d_in, d_out) weight, N(0, 1/d_in), in the reference's layout
    (applied as x @ w).  Drawn on the generator's device from `generator`
    (torch's draws, not jax.random's), then moved to `device`."""
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    """A (vocab, d) f32 table, N(0, 0.02^2), drawn like `dense_init`."""
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32) * 0.02
    return w.to(device)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent_chunked(logits_fn, x: torch.Tensor, labels: torch.Tensor,
                         n_chunks: int = 8, vocab_shard=None) -> torch.Tensor:
    """Mean cross-entropy, looped over `n_chunks` sequence chunks so the
    live logits tensor is (B, S/n_chunks, V) instead of (B, S, V).

    logits_fn: (B, s, d) -> (B, s, V) (the LM head).  x: (B, S, d) final
    hidden states.  labels: (B, S) int.  Each chunk's f32 logsumexp minus
    its gold logit is summed in chunk order under a non-reentrant
    checkpoint (the reference's `jax.checkpoint(body)`), so no chunk's
    logits outlive it in the backward; the total is divided by B * S.

    vocab_shard=(mesh, axis): logits_fn gives this rank's block of the
    vocabulary (rank i of `axis` holds columns [i V_l, (i + 1) V_l)).
    The log-sum-exp is a max over the axis (held out of the gradient),
    then the sum of exp(logit - max) over it; the gold logit (the
    reference's take_along_axis on the sharded dim) is a masked local
    pick summed over the axis: B x s floats cross, not the chunk's
    (B, s, V) logits.  Every rank of the axis returns the same value.
    """
    b, s, _ = x.shape
    if s % n_chunks:
        raise ValueError(f"sequence {s} does not split into {n_chunks} "
                         f"chunks")
    cs = s // n_chunks

    def body(xi, li):
        logits = logits_fn(xi).float()                    # (B, cs, V)
        if vocab_shard is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        else:
            lse, gold = _sharded_lse_gold(logits, li, *vocab_shard)
        return torch.sum(lse - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(body, x[:, sl], labels[:, sl],
                                   use_reentrant=False)
    return total / (b * s)


def _sharded_lse_gold(logits: torch.Tensor, labels: torch.Tensor, mesh,
                      axis: str):
    """(logsumexp, gold logit) over a vocabulary whose block (..., V_l)
    this rank of `axis` holds."""
    v_local = logits.shape[-1]
    m = all_reduce(logits.detach().amax(-1), mesh, axis, op="max")
    lse = m + torch.log(reduce_from(
        torch.exp(logits - m[..., None]).sum(-1), mesh, axis))
    loc = labels.long() - mesh.get_local_rank(axis) * v_local
    ok = (loc >= 0) & (loc < v_local)
    pick = torch.gather(logits, -1, loc.clamp(0, v_local - 1)[..., None])
    gold = reduce_from(torch.where(ok, pick[..., 0], 0.0), mesh, axis)
    return lse, gold
