"""Decoder-only LM: config, init, training forward and loss, prefill +
decode (port of `repro.models.transformer`, the single-device path).

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

MoE layers (`cfg.moe`) run `models.moe.moe_ffn`, expert-parallel over
"model" under a mesh; training adds its aux loss to the loss, serving
drops it, as the reference does.

Training (`lm_loss` -> `forward_hidden` -> `_layer_scan`) loops over the
layers in Python, each layer's slice of the stacked weights an `unbind`
view of the compute-dtype copy (one stack in the backward), under the
config's remat: "none", "full" (a non-reentrant checkpoint a layer),
"dots" (a checkpoint that keeps the weight products, `aten.mm` /
`aten.addmm`, and recomputes the rest: the reference's
`dots_with_no_batch_dims_saveable`), "2level" (a checkpoint around each
group of L / outer layers, outer the largest divisor of L at most
sqrt(L)).  The loss loops over sequence chunks (`softmax_xent_chunked`).

Sharded training (`ShardCtx`, `lm_param_specs`): `lm_loss`,
`forward_hidden`, `layer_forward` and `lm_head_logits` take `ctx`; with
`ctx.mesh` None (the default) they are the single-device path above,
unchanged.  Under a `DeviceMesh` ("data", "model") every rank runs them
on its blocks: the batch's rows over the batch axes, Megatron tensor
parallelism over "model" (column-parallel wq / wk / wv / w_gate / w_in
and head, row-parallel wo / w_out, each rank with n_heads / tp query and
n_kv_heads / tp kv heads), the vocab-parallel embedding (a masked local
take plus a sum over "model") and a vocab-parallel loss
(`softmax_xent_chunked`'s `vocab_shard`).  Parameters are
`utils.sharding` leaves laid out by `lm_param_specs`: a weight FSDP-
sharded over a batch axis is gathered where it is used, a stacked layer
weight sharded on its layer dim one layer at a time inside the layer
loop (`utils.sharding.layer_views`), as GSPMD gathers inside the
reference's scan; the reference's `constrain` points are where these
collectives leave each activation (q / k / v and the FFN hidden on local
heads, the residual stream whole on every "model" rank, logits on local
vocab).  Gradients reach each leaf's block through the collectives'
backward (`utils.sharding.compute_view`).

Sharded serving: `serve_prefill(ctx=)` and `decode_step(ctx=)` take the
global batch's tokens and positions (the same on every rank) and each
rank's cache block, laid out as `cache_specs(cfg, ctx, kv_mode)` says,
and return the full (B, V) logits on every rank.  "head": each rank
holds its batch rows and its n_kv_heads / tp kv heads and runs
`decode_attention_local` (the kernel on CUDA tensors under "auto"), as
`serve_prefill` lays its cache out.  "seq" (the cache's sequence over
"model", its rows over the batch axes) and "seq_all" (the sequence over
every mesh axis, every rank all B rows): q and the new k / v whole on
every rank (this rank's columns of the projections, gathered over
"model"; n_kv_heads need not divide tp), the new row written by the one
rank whose slice holds it, and `attention.decode_attention_seqsharded`'s
log-sum-exp merge; wo stays row-parallel (each rank its q_dim slice of
the merged heads).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device, to_device
from ..core.distances import f32_matmul
from ..utils import sharding
from ..utils.sharding import P, copy_to, reduce_from
from .attention import (causal_attention, decode_attention_local,
                        decode_attention_seqsharded, shard_lengths)
from .layers import (act_fn, apply_norm, apply_rope, dense_init, embed_init,
                     norm_param, softmax_xent_chunked)
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
    remat: str = "full"              # none | full | dots | 2level
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


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh context handed to model code; None mesh = the single-device
    path.  `mesh` is a `DeviceMesh` whose dims carry the reference's axis
    names; specs are `utils.sharding.P`."""
    mesh: Optional[Any] = None
    model_axis: Optional[str] = "model"

    @property
    def batch_axes(self) -> tuple:
        if self.mesh is None:
            return ()
        names = sharding.axis_names(self.mesh)
        return tuple(a for a in ("pod", "data") if a in names)

    @property
    def tp(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return sharding.axis_size(self.mesh, self.model_axis)

    def batch_spec(self, *rest) -> Optional[P]:
        if self.mesh is None:
            return None
        ba = self.batch_axes
        return P(ba if ba else None, *rest)

    def axis_prod(self, axes) -> int:
        if axes is None:
            return 1
        axes = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in axes:
            n *= sharding.axis_size(self.mesh, a)
        return n

    def sanitize(self, spec: Optional[P], shape) -> Optional[P]:
        """Drop sharding on any dim whose size is not divisible by its mesh
        axes (batch=1 serving cells, tiny decode token counts, ...)."""
        if self.mesh is None or spec is None:
            return spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for d, s in zip(dims, shape):
            out.append(d if d is None or (s >= self.axis_prod(d)
                                          and s % self.axis_prod(d) == 0)
                       else None)
        return P(*out)

    def constrain(self, x, spec: Optional[P]):
        """`x` (a plain tensor: the same full value on every rank; or a
        DTensor) laid out as the sanitized `spec`: a DTensor of this
        rank's block, or the full tensor where the spec replicates it (the
        reference's with_sharding_constraint, for inputs: not
        differentiable; a no-op unsharded).  Inside the model the
        collectives fix each activation's layout (module docstring)."""
        if self.mesh is None or spec is None:
            return x
        return sharding.shard_leaf(self.mesh, self.sanitize(spec, x.shape),
                                   x)

    def view(self, p):
        """Parameter `p`'s block for this rank's compute
        (`utils.sharding.compute_view` over the batch axes)."""
        return sharding.compute_view(p, self.mesh, self.batch_axes)

    def batch_rows(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(this rank's rows of the global batch `x`, the number of ranks
        that hold the same rows: the batch axes that the sanitized batch
        spec drops)."""
        spec = self.sanitize(self.batch_spec(*([None] * (x.dim() - 1))),
                             x.shape)
        return (sharding.local(self.constrain(x, spec)),
                self.axis_prod(self.batch_axes) // self.axis_prod(spec[0]))


def _tp(ctx: Optional[ShardCtx]) -> int:
    return 1 if ctx is None else ctx.tp


def _sharded(ctx: Optional[ShardCtx]) -> bool:
    return ctx is not None and ctx.mesh is not None


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


def lm_param_shapes(cfg: LMConfig) -> dict:
    """The shapes of `init_lm_params`' tree (tuples; None where the tree
    holds None), without drawing it."""
    d, l = cfg.d_model, cfg.n_layers
    norm = None if cfg.norm == "nonparam_ln" else (l, d)
    layers: dict[str, Any] = {
        "attn_norm": norm, "mlp_norm": norm, "wq": (l, d, cfg.q_dim),
        "wk": (l, d, cfg.kv_dim), "wv": (l, d, cfg.kv_dim),
        "wo": (l, cfg.q_dim, d)}
    if cfg.moe:
        m = cfg.moe
        e = m.n_experts_padded
        layers.update(router=(l, d, m.n_experts),
                      we_gate=(l, e, d, m.d_ff_expert),
                      we_in=(l, e, d, m.d_ff_expert),
                      we_out=(l, e, m.d_ff_expert, d))
        if m.n_shared:
            layers.update(ws_gate=(l, d, m.d_ff_shared),
                          ws_in=(l, d, m.d_ff_shared),
                          ws_out=(l, m.d_ff_shared, d))
    else:
        layers.update(w_gate=(l, d, cfg.d_ff), w_in=(l, d, cfg.d_ff),
                      w_out=(l, cfg.d_ff, d))
    out = {"embed": (cfg.vocab, d),
           "final_norm": None if cfg.norm == "nonparam_ln" else (d,),
           "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab)
    return out


def lm_param_specs(cfg: LMConfig, ctx: ShardCtx,
                   fsdp_axis: Optional[str] = None) -> dict:
    """Spec tree (`utils.sharding.P`) matching init_lm_params output (the
    reference's, leaf for leaf; all None without a mesh).

    fsdp_axis (training): additionally shard every weight over that axis on
    its first free divisible dim -- 2D (FSDP x TP) parameter layout; the
    forward gathers each weight where it is used (a stacked layer weight
    one layer at a time) and the backward reduce-scatters its gradient,
    and the AdamW state inherits the fully-sharded layout."""
    shapes = lm_param_shapes(cfg)
    if ctx.mesh is None:
        return sharding.map_specs(lambda *_: None, shapes, shapes)
    mdl = ctx.model_axis
    layers: dict[str, Any] = {
        "attn_norm": None if cfg.norm == "nonparam_ln" else P(None, None),
        "mlp_norm": None if cfg.norm == "nonparam_ln" else P(None, None),
        "wq": P(None, None, mdl),
        "wk": P(None, None, mdl),
        "wv": P(None, None, mdl),
        "wo": P(None, mdl, None),
    }
    if cfg.moe:
        layers["router"] = P(None, None, None)
        layers["we_gate"] = P(None, mdl, None, None)
        layers["we_in"] = P(None, mdl, None, None)
        layers["we_out"] = P(None, mdl, None, None)
        if cfg.moe.n_shared:
            layers["ws_gate"] = P(None, None, mdl)
            layers["ws_in"] = P(None, None, mdl)
            layers["ws_out"] = P(None, mdl, None)
    else:
        layers["w_gate"] = P(None, None, mdl)
        layers["w_in"] = P(None, None, mdl)
        layers["w_out"] = P(None, mdl, None)
    specs = {
        "embed": P(mdl, None),
        "final_norm": None if cfg.norm == "nonparam_ln" else P(None),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, mdl)
    if fsdp_axis is not None:
        ax_size = ctx.axis_prod(fsdp_axis)

        def add_fsdp(spec, shape):
            if spec is None or len(shape) < 2:
                return spec
            dims = list(spec) + [None] * (len(shape) - len(spec))
            for i, d in enumerate(dims):
                if d is None and shape[i] % ax_size == 0 \
                        and shape[i] >= ax_size:
                    dims[i] = fsdp_axis
                    return P(*dims)
            return spec

        specs = sharding.map_specs(add_fsdp, specs, shapes)
    return specs


def compute_cast(tree, dtype: torch.dtype):
    """Cast every floating tensor of a parameter tree to `dtype` (no copy
    where it already is); differentiable, so gradients reach f32 master
    weights through it."""
    if isinstance(tree, dict):
        return {k: compute_cast(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _unstack(layers: dict) -> list[dict]:
    """The stacked (L, ...) layer weights as L per-layer dicts of views
    (`unbind`: its backward is one stack, not L full-size scatters)."""
    n = next(v.shape[0] for v in layers.values() if v is not None)
    cols = {k: [None] * n if v is None else v.unbind(0)
            for k, v in layers.items()}
    return [{k: c[li] for k, c in cols.items()} for li in range(n)]


# ---------------------------------------------------------------------------
# Embedding, one layer, head
# ---------------------------------------------------------------------------
def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg: LMConfig, ctx: Optional[ShardCtx] = None
                 ) -> torch.Tensor:
    """(V, d) x (B, S) -> (B, S, d) in the compute dtype.  Under a mesh
    with tp > 1, `embed` is this rank's vocab block (V / tp, d) and the
    lookup is Megatron's vocab-parallel one: a masked local take summed
    over "model" (the reference's shard_map body)."""
    if _tp(ctx) == 1:
        out = embed[tokens.long()].to(cfg.compute_dtype)
    else:
        v_local = embed.shape[0]
        loc = tokens.long() - ctx.mesh.get_local_rank(ctx.model_axis) * v_local
        ok = (loc >= 0) & (loc < v_local)
        rows = torch.where(ok[..., None], embed[loc.clamp(0, v_local - 1)],
                           0.0)
        out = reduce_from(rows, ctx.mesh, ctx.model_axis).to(
            cfg.compute_dtype)
    if cfg.embed_scale:
        out = out * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                                 device=out.device)
    return out


def _to_model(h, ctx):
    """Megatron's f before a column-parallel product (tp > 1)."""
    return h if _tp(ctx) == 1 else copy_to(h, ctx.mesh, ctx.model_axis)


def _from_model(y, ctx):
    """Megatron's g after a row-parallel product (tp > 1)."""
    return y if _tp(ctx) == 1 else reduce_from(y, ctx.mesh, ctx.model_axis)


def _attn_qkv(x, lp, cfg: LMConfig, positions, ctx=None):
    b, s, _ = x.shape
    tp = _tp(ctx)
    hq, hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
    h = _to_model(apply_norm(cfg.norm, x, lp["attn_norm"]), ctx)
    q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, hq, cfg.d_head)
    k = (h @ lp["wk"].to(h.dtype)).reshape(b, s, hkv, cfg.d_head)
    v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, hkv, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(x, lp, cfg: LMConfig, ctx=None):
    """One layer's FFN: the dense gated MLP, or the MoE block.  Returns
    (out, aux loss f32 scalar; 0 for a dense layer)."""
    h = apply_norm(cfg.norm, x, lp["mlp_norm"])
    if cfg.moe:
        if not _sharded(ctx):
            return moe_ffn(h, lp, cfg.moe, activation=cfg.activation)
        return moe_ffn(h, lp, cfg.moe, mesh=ctx.mesh,
                       batch_axes=ctx.batch_axes,
                       model_axis=ctx.model_axis if ctx.tp > 1 else None,
                       activation=cfg.activation)
    h = _to_model(h, ctx)
    g = h @ lp["w_gate"].to(h.dtype)
    i = h @ lp["w_in"].to(h.dtype)
    out = (act_fn(cfg.activation)(g) * i) @ lp["w_out"].to(h.dtype)
    return _from_model(out, ctx), torch.zeros((), device=x.device)


def layer_forward(x, lp, cfg: LMConfig, positions,
                  ctx: Optional[ShardCtx] = None):
    """Full-sequence layer (train / prefill). Returns (x, aux, (k, v)).
    Under a mesh, `lp` holds this rank's compute blocks of one layer
    (`utils.sharding.layer_views`) and x its rows, whole on every "model"
    rank, as are the returned x; k and v hold its local heads."""
    q, k, v = _attn_qkv(x, lp, cfg, positions, ctx)
    att = causal_attention(q, k, v, q_offset=0, window=cfg.sliding_window,
                           chunk_q=cfg.attn_chunk_q,
                           chunk_kv=cfg.attn_chunk_kv)
    b, s, _, _ = att.shape
    att = att.reshape(b, s, cfg.q_dim // _tp(ctx))
    x = x + _from_model(att @ lp["wo"].to(att.dtype), ctx)
    ffn_out, aux = _ffn(x, lp, cfg, ctx)
    return x + ffn_out, aux, (k, v)


def _head_weight(params, cfg: LMConfig, ctx):
    """The head's (d, V) weight, or this rank's (d, V / tp) block."""
    if cfg.tie_embeddings:
        w = params["embed"] if not _sharded(ctx) else ctx.view(params["embed"])
        return w.T
    return params["lm_head"] if not _sharded(ctx) else ctx.view(
        params["lm_head"])


def _head(w, x, ctx):
    return _to_model(x, ctx) @ w.to(x.dtype)


def lm_head_logits(params, cfg: LMConfig, x, ctx: Optional[ShardCtx] = None):
    """Logits (..., V); under a mesh this rank's vocab block (..., V / tp)
    of its rows."""
    return _head(_head_weight(params, cfg, ctx), x, ctx)


# ---------------------------------------------------------------------------
# Forward / loss (training)
# ---------------------------------------------------------------------------
def _dots_saveable(ctx, op, *args, **kwargs):
    """Keep products without batch dims (the weight products: `x @ w`
    runs as `mm` / `addmm`); recompute the rest, the attention's and the
    experts' `bmm`s included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, mode: str):
    """fn under the remat `mode`: "none" as it is, "dots" a selective
    checkpoint (`_dots_saveable`), any other a full checkpoint."""
    if mode == "none":
        return fn
    if mode == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_saveable)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _layer_scan(layers: list[dict], carry, cfg: LMConfig, step_fn):
    """carry through step_fn(carry, lp) over the per-layer weights, under
    the configured remat.  "2level": a checkpoint around each group of
    L / outer consecutive layers (outer the largest divisor of L at most
    sqrt(L)), nothing saved inside a group: the saved activations drop
    from L layers' to outer group inputs plus one group's layers."""
    if cfg.remat == "2level":
        l = len(layers)
        outer = max(f for f in range(1, int(l ** 0.5) + 1) if l % f == 0)
        inner = l // outer

        def group(c, lps):
            for lp in lps:
                c = step_fn(c, lp)
            return c

        group = _remat_wrap(group, "full")
        for g in range(outer):
            carry = group(carry, layers[g * inner:(g + 1) * inner])
        return carry
    body = _remat_wrap(step_fn, cfg.remat)
    for lp in layers:
        carry = body(carry, lp)
    return carry


def _check_tp(cfg: LMConfig, ctx: ShardCtx) -> None:
    """Tensor parallelism here keeps whole heads on a rank."""
    tp = ctx.tp
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("vocab", cfg.vocab), ("d_ff", cfg.d_ff or tp)):
        sharding.check_divisible(n, tp, what)


def forward_hidden(params, cfg: LMConfig, tokens,
                   ctx: Optional[ShardCtx] = None):
    """tokens (B, S) -> final hidden (B, S, d) + summed MoE aux loss.
    Under a mesh, tokens are the global batch (the same on every rank)
    and the hidden states this rank's rows (`ShardCtx.batch_rows`)."""
    dev = params["embed"].device
    tokens = to_device(tokens, dev)
    sharded = _sharded(ctx)
    if sharded:
        _check_tp(cfg, ctx)
        tokens, _ = ctx.batch_rows(tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=dev)[None].expand(b, s)

    def step(carry, lp):
        x, aux = carry
        x, a, _ = layer_forward(x, lp() if callable(lp) else lp, cfg,
                                positions, ctx)
        return x, aux + a

    layers = compute_cast(params["layers"], cfg.compute_dtype)
    layers = (sharding.layer_views(layers, ctx.mesh, ctx.batch_axes)
              if sharded else _unstack(layers))
    embed, final_norm = params["embed"], params["final_norm"]
    if sharded:
        embed, final_norm = ctx.view(embed), ctx.view(final_norm)
    with f32_matmul():
        x = embed_lookup(embed, tokens, cfg, ctx)
        x, aux = _layer_scan(layers, (x, torch.zeros((), device=dev)), cfg,
                             step)
        x = apply_norm(cfg.norm, x, final_norm)
    return x, aux


def lm_loss(params, cfg: LMConfig, tokens, labels,
            ctx: Optional[ShardCtx] = None):
    """Mean next-token cross entropy (+ MoE aux). tokens/labels (B, S).
    Returns (ce + aux, {"ce": ce, "aux": aux}).  Under a mesh the mean
    is over the global batch, the same value on every rank: each rank's
    share of the sum is added over the batch axes (divided by the ranks
    that hold the same rows, where the batch does not split)."""
    x, aux = forward_hidden(params, cfg, tokens, ctx)
    labels = to_device(labels, x.device)
    if not _sharded(ctx):
        with f32_matmul():
            ce = softmax_xent_chunked(
                lambda xc: lm_head_logits(params, cfg, xc), x, labels,
                n_chunks=min(cfg.loss_chunks, x.shape[1]))
        return ce + aux, {"ce": ce, "aux": aux}
    n_tok = labels.numel()
    labels, copies = ctx.batch_rows(labels)
    w = _head_weight(params, cfg, ctx)
    shard = ((ctx.mesh, ctx.model_axis) if ctx.tp > 1 else None)
    with f32_matmul():
        ce = softmax_xent_chunked(
            lambda xc: _head(w, xc, ctx), x, labels,
            n_chunks=min(cfg.loss_chunks, x.shape[1]), vocab_shard=shard)
    # the local mean over this rank's rows, as the global mean's share
    ce = ce * (labels.numel() / (n_tok * copies))
    ce = reduce_from(ce, ctx.mesh, ctx.batch_axes)
    return ce + aux, {"ce": ce, "aux": aux}


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


def cache_specs(cfg: LMConfig, ctx: Optional[ShardCtx], mode: str):
    """Specs of (cache_k, cache_v, lengths) under `ctx`'s mesh (None each
    without one).  mode: "head" -- kv heads over model (n_kv_heads % tp
    == 0); "seq" -- the cache's sequence over model; "seq_all" -- the
    sequence over every mesh axis (batch 1 cells), lengths replicated."""
    if not _sharded(ctx):
        return None, None, None
    ba = ctx.batch_axes
    mdl = ctx.model_axis
    if mode == "head":
        spec = P(None, ba, None, mdl, None)
    elif mode == "seq":
        spec = P(None, ba, mdl, None, None)
    elif mode == "seq_all":
        spec = P(None, None, tuple(ba) + (mdl,), None, None)
    else:
        raise ValueError(mode)
    len_spec = P(ba) if mode != "seq_all" else P(None)
    return spec, spec, len_spec


def _serve_weights(params, cfg: LMConfig, ctx):
    """(embedding, final norm, per-layer weights) for serving: the
    compute-dtype copies, under a mesh this rank's compute blocks (the
    layers as `utils.sharding.layer_views` callables)."""
    layers = compute_cast(params["layers"], cfg.compute_dtype)
    if not _sharded(ctx):
        return params["embed"], params["final_norm"], _unstack(layers)
    return (ctx.view(params["embed"]), ctx.view(params["final_norm"]),
            sharding.layer_views(layers, ctx.mesh, ctx.batch_axes))


def _whole_logits(logits, ctx, split: bool):
    """(B, V) logits on every rank from this rank's (rows, vocab block):
    gathered over "model", then over the batch axes where the rows are
    split (innermost axis first)."""
    if not _sharded(ctx):
        return logits
    logits = sharding.all_gather(logits, ctx.mesh, ctx.model_axis,
                                 logits.dim() - 1)
    if split:
        for axis in reversed(ctx.batch_axes):
            logits = sharding.all_gather(logits, ctx.mesh, axis, 0)
    return logits


def serve_prefill(params, cfg: LMConfig, tokens,
                  ctx: Optional[ShardCtx] = None):
    """Prefill: (B, S) -> (last-token logits (B, V), (ck, cv), lengths),
    with caches (L, B, S_c, Hkv, Dh) in the compute dtype.  Under a sliding
    window the cache keeps the trailing window in ring order (slot =
    position % S_c), so that `decode_step`'s ring writes land consistently
    after wraparound.  Under a mesh, tokens are the global batch (the
    same on every rank); the logits come back whole on every rank and
    the caches and lengths as this rank's "head" block (its batch rows,
    its kv heads)."""
    dev = params["embed"].device
    tokens = to_device(tokens, dev)
    split = False
    if _sharded(ctx):
        _check_tp(cfg, ctx)
        tokens, copies = ctx.batch_rows(tokens)
        split = copies == 1 and ctx.axis_prod(ctx.batch_axes) > 1
    b, s = tokens.shape
    sc = cache_len_for(cfg, s)
    embed, final_norm, layers = _serve_weights(params, cfg, ctx)
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    ck = torch.empty((cfg.n_layers, b, sc, cfg.n_kv_heads // _tp(ctx),
                      cfg.d_head), dtype=cfg.compute_dtype, device=dev)
    cv = torch.empty_like(ck)
    with f32_matmul():
        x = embed_lookup(embed, tokens, cfg, ctx)
        for li, lp in enumerate(layers):
            x, _, (k, v) = layer_forward(x, lp() if callable(lp) else lp,
                                         cfg, positions, ctx)
            if sc < s:
                k, v = k[:, s - sc:], v[:, s - sc:]
                off = (s - sc) % sc
                if off:
                    k = torch.roll(k, off, dims=1)
                    v = torch.roll(v, off, dims=1)
            ck[li], cv[li] = k, v
        x = apply_norm(cfg.norm, x, final_norm)
        logits = lm_head_logits(params, cfg, x[:, -1:], ctx)[:, 0]
    lengths = torch.full((b,), sc, dtype=torch.int32, device=dev)
    return _whole_logits(logits, ctx, split), (ck, cv), lengths


def _write_cache_local(ck, cv, k_new, v_new, write_pos):
    """Write row write_pos[b] of each batch row b, in place: an index
    write of distinct rows (deterministic).  ck (B, S, Hkv, Dh); k_new
    (B, 1, Hkv, Dh); write_pos (B,)."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    ck[rows, write_pos] = k_new[:, 0].to(ck.dtype)
    cv[rows, write_pos] = v_new[:, 0].to(cv.dtype)


def _qkv_whole(x, lp, cfg: LMConfig, positions, ctx):
    """q (B, 1, H, Dh), k and v (B, 1, Hkv, Dh) whole on every rank: this
    rank's columns of the three projections, gathered over "model" in one
    collective, then RoPE on whole heads."""
    b, s, _ = x.shape
    h = _to_model(apply_norm(cfg.norm, x, lp["attn_norm"]), ctx)
    parts = [h @ lp[w].to(h.dtype) for w in ("wq", "wk", "wv")]
    widths = [p.shape[-1] for p in parts]
    y = torch.cat(parts, -1)[None]
    if ctx.tp > 1:
        y = sharding.all_gather(y, ctx.mesh, ctx.model_axis, 0)
    # (tp, B, S, q + 2 kv local) -> each projection's tp blocks in order
    q, k, v = (t.movedim(0, -2).reshape(b, s, -1)
               for t in y.split(widths, -1))
    q = apply_rope(q.reshape(b, s, cfg.n_heads, cfg.d_head), positions,
                   cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, cfg.n_kv_heads, cfg.d_head), positions,
                   cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)


def _decode_seqsharded(q1, k_new, v_new, ck, cv, write_pos, new_len,
                       ctx: ShardCtx, seq_axes: tuple):
    """This rank's slice (B, S_l, Hkv, Dh) of a sequence-sharded cache:
    the new row written in place where the slice holds write_pos (the
    others write their current row back), then the distributed
    flash-decode merge over `seq_axes`.  Returns (B, H, Dh)."""
    s_l = ck.shape[1]
    idx, _ = sharding.coordinate(ctx.mesh, seq_axes)
    start = idx * s_l
    loc = (write_pos - start).clamp(0, s_l - 1)
    mine = ((write_pos >= start) & (write_pos < start + s_l))[:, None, None]
    rows = torch.arange(ck.shape[0], device=ck.device)
    for c, new in ((ck, k_new), (cv, v_new)):
        c[rows, loc] = torch.where(mine, new[:, 0].to(c.dtype), c[rows, loc])
    local_len = shard_lengths(new_len, idx, s_l)
    return decode_attention_seqsharded(q1, ck, cv, local_len, ctx.mesh,
                                       seq_axes)


def decode_step(params, cfg: LMConfig, tokens, positions, caches,
                kv_mode: str = "local", backend: str = "auto",
                ctx: Optional[ShardCtx] = None):
    """One decode step.

    tokens (B, 1) int; positions (B,) absolute positions of the new token;
    caches = (ck, cv, lengths) with ck/cv (L, B, Sc, Hkv, Dh), contiguous.
    Without a mesh every kv_mode is the single-device path ("head" on
    one card is it with tp = 1); backend goes to `flash_decode` ("auto":
    the kernel on CUDA tensors).  Under `ctx`'s mesh, tokens and
    positions are the global batch and the caches this rank's block as
    `cache_specs(cfg, ctx, kv_mode)` lays them out (kv_mode "head",
    "seq" or "seq_all"; module docstring); backend goes to "head"'s
    `flash_decode`.  Returns (logits (B, V), caches): ck and cv are
    written in place (row position % Sc of every layer, Sc the whole
    cache's length), lengths are new (this rank's rows).
    """
    if kv_mode not in ("local", "head", "seq", "seq_all"):
        raise ValueError(kv_mode)
    ck_all, cv_all, _ = caches
    dev = ck_all.device
    tokens = to_device(tokens, dev)
    positions = to_device(positions, dev)
    sharded = _sharded(ctx)
    if not sharded:
        ctx, kv_mode = None, "local"
    elif kv_mode == "local":
        raise ValueError("under a mesh the cache is sharded: kv_mode "
                         "'head', 'seq' or 'seq_all'")
    seq_axes, split, sc = (), False, ck_all.shape[2]
    if kv_mode == "head":
        _check_tp(cfg, ctx)
    elif kv_mode in ("seq", "seq_all"):
        for what, n in (("vocab", cfg.vocab), ("q_dim", cfg.q_dim),
                        ("kv_dim", cfg.kv_dim), ("d_ff", cfg.d_ff or ctx.tp)):
            sharding.check_divisible(n, ctx.tp, what)
        seq_axes = ((*ctx.batch_axes, ctx.model_axis)
                    if kv_mode == "seq_all" else (ctx.model_axis,))
        sc *= ctx.axis_prod(seq_axes)
    if sharded and kv_mode != "seq_all":
        tokens, copies = ctx.batch_rows(tokens)
        positions, _ = ctx.batch_rows(positions)
        split = copies == 1 and ctx.axis_prod(ctx.batch_axes) > 1
    b = tokens.shape[0]
    embed, final_norm, layers = _serve_weights(params, cfg, ctx)
    write_pos = positions % sc                  # ring buffer under SWA
    new_len = torch.clamp(positions + 1, max=sc).to(torch.int32)
    with f32_matmul():
        x = embed_lookup(embed, tokens, cfg, ctx)
        for li, lp in enumerate(layers):
            lp = lp() if callable(lp) else lp
            if seq_axes:
                q, k, v = _qkv_whole(x, lp, cfg, positions[:, None], ctx)
                att = _decode_seqsharded(q[:, 0], k, v, ck_all[li],
                                         cv_all[li], write_pos, new_len,
                                         ctx, seq_axes)
                # wo is row-parallel: this rank's q_dim slice of the heads
                w = cfg.q_dim // ctx.tp
                att = att.to(x.dtype).reshape(b, 1, cfg.q_dim).narrow(
                    2, ctx.mesh.get_local_rank(ctx.model_axis) * w, w)
            else:
                q, k, v = _attn_qkv(x, lp, cfg, positions[:, None], ctx)
                _write_cache_local(ck_all[li], cv_all[li], k, v, write_pos)
                att = decode_attention_local(q[:, 0], ck_all[li], cv_all[li],
                                             new_len, backend=backend)
                att = att.to(x.dtype).reshape(b, 1, cfg.q_dim // _tp(ctx))
            x = x + _from_model(att @ lp["wo"].to(att.dtype), ctx)
            x = x + _ffn(x, lp, cfg, ctx)[0]
        x = apply_norm(cfg.norm, x, final_norm)
        logits = lm_head_logits(params, cfg, x, ctx)[:, 0]
    return _whole_logits(logits, ctx, split), (ck_all, cv_all, new_len)
