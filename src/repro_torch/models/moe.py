"""Mixture-of-Experts FFN (port of `repro.models.moe`).

Each token's router picks its top-k experts; the (token, expert) slots are
sorted by expert id, gathered into a fixed-capacity (E_pad, cap_e, d)
buffer, run through every expert's gated FFN in one batched product, and
combined back weighted by their gates.  Slots past an expert's capacity
drop (contribute zero), as in the reference.  Expert counts are padded to
`pad_multiple` with dead experts whose router logits are -1e30, so they
are never routed to (qwen2-moe's 60 -> 64).

The expert products are plain `torch.bmm`s (the reference leaves them to
XLA, outside any Pallas kernel).  The combine sums each token's k slot
outputs in slot order, with no float atomics, so that two runs on the
card give the same bits.

Expert parallelism over a mesh (`moe_ffn(mesh=..., model_axis=...)`):
each "model" rank holds E_pad / mp experts and takes its 1/mp slice of
the tokens, which arrive whole on every model rank (`_moe_local`; the
whole, replicated token set where mp does not divide them, as in decode).
In `_moe_group_local` its (token, expert) slots, sorted by expert, fill
fixed-capacity send buffers (mp, cap, d), one block a destination rank,
padded with expert id -1; a tiled all_to_all (`utils.sharding`) carries
them to the experts' ranks, which sort what they received by local
expert, run their experts on (E_l, cap_e, d), and send the rows back by
the inverse all_to_all; the slices' outputs merge with a sum over
"model".  The reference's arithmetic is kept: its `cap` and `cap_e` with
mp, its -1 ids, its combine order (each token's slots added in ascending
expert id).  Gradients: the tokens and gates enter through `copy_to`
(their gradient summed over "model", as each rank saw only its slice);
the router and its aux loss run whole on every model rank, the aux
loss's means over the global batch (`route`).  `drop_log` counts the
slots the mesh path drops, while it is on.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..core.distances import f32_matmul
from ..utils.sharding import (all_to_all, axis_names, axis_size, copy_to,
                              reduce_from)
from .layers import act_fn, gated_mlp


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int               # routed experts (logical)
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts (fused into one gated FFN)
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    expert_capacity_factor: float = 1.5
    aux_loss_weight: float = 0.01
    groups: int = 1              # token chunks of the reference's mesh path
    pad_multiple: int = 16       # pad n_experts up to a multiple of this

    @property
    def n_experts_padded(self) -> int:
        m = self.pad_multiple
        return -(-self.n_experts // m) * m

    @property
    def d_ff_shared_total(self) -> int:
        return self.d_ff_shared if self.d_ff_shared else 0


def _round8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
          mesh=None, batch_axes=()):
    """x (T, d) -> (gates (T, k) f32, eids (T, k) int32, aux_loss scalar).

    Top-k by a stable descending sort: of equal probabilities the lower
    expert id comes first, as `jax.lax.top_k` orders them.  On a mesh, x
    is this rank's rows and the aux loss's expert fractions and mean
    probabilities are those of the global batch (summed over
    `batch_axes`), as the reference routes the whole batch."""
    with f32_matmul():
        logits = x_flat.float() @ router_w.float()
    e_pad = cfg.n_experts_padded
    if e_pad > cfg.n_experts:  # dead experts: never routable
        neg = torch.full((logits.shape[0], e_pad - cfg.n_experts), -1e30,
                         dtype=torch.float32, device=logits.device)
        logits = torch.cat([logits, neg], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = top[:, :cfg.top_k], order[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance loss (Switch-style): E * sum_e f_e * p_e
    onehot = torch.nn.functional.one_hot(eids[:, 0], e_pad).float()
    if mesh is None or not batch_axes:
        f = onehot.mean(0)
        p = probs.mean(0)
    else:
        # the means over the global batch: each rank's sums and row count
        # added over the batch axes (rows that a batch axis does not split
        # scale both alike); backward, each rank its own rows' share
        tot = reduce_from(torch.cat([
            onehot.sum(0), probs.sum(0),
            torch.full((1,), float(probs.shape[0]), device=probs.device)]),
            mesh, batch_axes)
        f, p = tot[:e_pad] / tot[-1], tot[e_pad:2 * e_pad] / tot[-1]
    aux = cfg.n_experts * torch.sum(f * p) * cfg.aux_loss_weight
    return gates, eids.int(), aux


# ---------------------------------------------------------------------------
# Experts
# ---------------------------------------------------------------------------
def _expert_ffn(xg: torch.Tensor, wg, wi, wo, activation: str) -> torch.Tensor:
    """(E, Ce, d) x (E, d, f) -> (E, Ce, d) gated FFN."""
    g = act_fn(activation)(torch.bmm(xg, wg))
    return torch.bmm(g * torch.bmm(xg, wi), wo)


def _moe_local_nosharding(xt, gates, eids, wg, wi, wo, *, cfg: MoEConfig,
                          activation: str):
    """Sort the T*k slots by expert, gather each expert's first cap_e slots
    into (E_pad, cap_e, d), run the experts, and combine: a slot beyond its
    expert's capacity contributes nothing."""
    t, d = xt.shape
    k = cfg.top_k
    e_pad = cfg.n_experts_padded
    n_slot = t * k
    cap_e = _round8(int(cfg.expert_capacity_factor * n_slot / e_pad))
    dev = xt.device
    flat_e = eids.reshape(-1).long()
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(n_slot, device=dev) // k
    perm = torch.argsort(flat_e, stable=True)
    s_e = flat_e[perm]
    s_t = flat_t[perm]
    experts = torch.arange(e_pad, device=dev)
    estart = torch.searchsorted(s_e, experts)
    eend = torch.searchsorted(s_e, experts, right=True)
    eidx = estart[:, None] + torch.arange(cap_e, device=dev)[None, :]
    evalid = eidx < eend[:, None]                      # (E_pad, cap_e)
    rows = torch.where(evalid, s_t[eidx.clamp(0, n_slot - 1)], 0)
    xg = torch.where(evalid[..., None], xt[rows], 0)
    with f32_matmul():
        yg = _expert_ffn(xg.to(wg.dtype), wg, wi, wo, activation)
    # slot j of the sorted order sits at (expert s_e[j], row j - estart)
    pos = torch.arange(n_slot, device=dev) - estart[s_e]
    ok = pos < cap_e
    flat_idx = (s_e * cap_e + pos).clamp(0, e_pad * cap_e - 1)
    slot_y = torch.where(ok[:, None], yg.reshape(-1, d)[flat_idx], 0)
    slot_y = slot_y * flat_g[perm][:, None].to(slot_y.dtype)
    # back to token-major slot order (distinct rows), then each token's k
    # slots summed in order: no atomics, the same bits on every run
    out = torch.empty_like(slot_y)
    out[perm] = slot_y
    return out.reshape(t, k, d).sum(1)


# ---------------------------------------------------------------------------
# Expert parallelism over the model axis
# ---------------------------------------------------------------------------
class DropLog:
    """Slots the mesh path drops in this process, counted while `on`
    (device tensors; `snapshot` syncs): `send`, slots past their
    destination rank's capacity `cap`; `expert`, rows received past a
    local expert's capacity `cap_e`; `slots`, the slots routed.  Forward
    passes only: a checkpoint's recompute, which runs inside the
    backward, is not counted again."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self) -> None:
        self._parts: list = []

    def add(self, slots: int, send, expert) -> None:
        if self.on and torch._C._current_graph_task_id() == -1:
            self._parts.append((slots, send, expert))

    def snapshot(self) -> dict:
        return {"slots": sum(p[0] for p in self._parts),
                "send": sum(int(p[1]) for p in self._parts),
                "expert": sum(int(p[2]) for p in self._parts)}


drop_log = DropLog()


class _GradScale(torch.autograd.Function):
    """Identity forward, gradient times `c` backward."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _moe_group_local(xt, gates, eids, wg, wi, wo, *, cfg: MoEConfig, mesh,
                     model_axis: str, activation: str):
    """One token group on this rank.  xt (Tg, d); gates / eids (Tg, k);
    wg / wi / wo this rank's E_pad / mp experts.  Sort the slots by
    expert (destination ranks contiguous), fill (mp, cap, d) send buffers,
    all_to_all, gather the received rows by local expert into
    (E_l, cap_e, d), run the experts, send the rows back, combine."""
    tg, d = xt.shape
    k = cfg.top_k
    mp = axis_size(mesh, model_axis)
    e_pad = cfg.n_experts_padded
    e_l = e_pad // mp
    n_slot = tg * k
    cap = _round8(int(cfg.capacity_factor * n_slot / mp))
    # expected rows a local expert = (mp ranks x n_slot) / e_pad
    cap_e = _round8(int(cfg.expert_capacity_factor * mp * n_slot / e_pad))
    dev = xt.device
    flat_e = eids.reshape(-1).long()
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(n_slot, device=dev) // k

    # sort the slots by expert id: destination ranks become contiguous
    perm = torch.argsort(flat_e, stable=True)
    s_e = flat_e[perm]
    s_t = flat_t[perm]
    rank_of = s_e // e_l
    ranks = torch.arange(mp, device=dev)
    seg_start = torch.searchsorted(rank_of, ranks)
    seg_end = torch.searchsorted(rank_of, ranks, right=True)

    # fixed-capacity send buffers, local expert id -1 on padding
    idx = seg_start[:, None] + torch.arange(cap, device=dev)[None, :]
    valid = idx < seg_end[:, None]                     # (mp, cap)
    idx_c = idx.clamp(0, n_slot - 1)
    send_tok = torch.where(valid, s_t[idx_c], 0)
    send_eid = torch.where(valid, s_e[idx_c] % e_l, -1).int()
    send_x = torch.where(valid[..., None], xt[send_tok], 0)

    # the expert-parallel exchange
    rx = all_to_all(send_x, mesh, model_axis).reshape(mp * cap, d)
    re = all_to_all(send_eid, mesh, model_axis).reshape(mp * cap).long()

    # local per-expert gather (padding sorts last) and the experts
    sort_key = torch.where(re < 0, e_l, re)
    perm2 = torch.argsort(sort_key, stable=True)
    r_e = sort_key[perm2]
    experts = torch.arange(e_l, device=dev)
    estart = torch.searchsorted(r_e, experts)
    eend = torch.searchsorted(r_e, experts, right=True)
    eidx = estart[:, None] + torch.arange(cap_e, device=dev)[None, :]
    evalid = eidx < eend[:, None]                      # (e_l, cap_e)
    rows = torch.where(evalid, perm2[eidx.clamp(0, mp * cap - 1)], 0)
    xg = torch.where(evalid[..., None], rx[rows], 0)
    with f32_matmul():
        yg = _expert_ffn(xg.to(wg.dtype), wg, wi, wo, activation)

    # the inverse path: expert rows back to received-row order (distinct
    # rows; padding adds zeros to row 0), back to their senders
    y_rx = torch.zeros((mp * cap, d), dtype=yg.dtype, device=dev).index_add(
        0, rows.reshape(-1),
        torch.where(evalid[..., None], yg, 0).reshape(-1, d))
    y_send = all_to_all(y_rx.reshape(mp, cap, d), mesh, model_axis)
    # slot j's row sits at (rank_of[j], j - seg_start[rank_of[j]])
    pos = torch.arange(n_slot, device=dev) - seg_start[rank_of]
    ok = pos < cap                                     # dropped: zero
    row_flat = (rank_of * cap + pos).clamp(0, mp * cap - 1)
    slot_y = torch.where(ok[:, None], y_send.reshape(mp * cap, d)[row_flat],
                         0)
    slot_y = slot_y * flat_g[perm][:, None].to(slot_y.dtype)
    drop_log.add(n_slot, n_slot - ok.sum(), (re >= 0).sum() - evalid.sum())
    # combine: each token's k slots added in the reference's order (its
    # scatter-add runs over the slots sorted by expert: ascending id)
    ys = torch.empty_like(slot_y)
    ys[perm] = slot_y
    order = torch.argsort(eids.long(), dim=1)
    ys = torch.gather(ys.reshape(tg, k, d), 1,
                      order[..., None].expand(tg, k, d))
    out = ys[:, 0]
    for j in range(1, k):
        out = out + ys[:, j]
    return out


def _moe_local(xt, gates, eids, wg, wi, wo, *, cfg: MoEConfig, mesh,
               model_axis: str, activation: str):
    """All of this rank's tokens (whole on every model rank), in `groups`
    chunks.  Each model rank takes its own 1/mp slice and the slices'
    outputs merge with one sum over "model"; where mp does not divide the
    tokens (decode) every rank runs them all (duplicated but correct: the
    output's gradient is scaled by 1/mp, so the mp copies add up to one).
    The group count is the largest divisor of the local token count at
    most `cfg.groups`; each group runs under a non-reentrant checkpoint
    when gradients are on."""
    mp = axis_size(mesh, model_axis)
    t_full, d = xt.shape
    sliced = t_full % mp == 0 and t_full >= mp
    if sliced:
        sl = t_full // mp
        me = mesh.get_local_rank(model_axis)
        xt, gates, eids = (a[me * sl:(me + 1) * sl] for a in (xt, gates, eids))
    t_l = xt.shape[0]
    g = max(gg for gg in range(1, min(cfg.groups, t_l) + 1) if t_l % gg == 0)
    fn = functools.partial(_moe_group_local, cfg=cfg, mesh=mesh,
                           model_axis=model_axis, activation=activation)
    if g == 1:
        out = fn(xt, gates, eids, wg, wi, wo)
    else:
        n = t_l // g
        remat = torch.is_grad_enabled()
        outs = []
        for i in range(g):
            args = (xt[i * n:(i + 1) * n], gates[i * n:(i + 1) * n],
                    eids[i * n:(i + 1) * n], wg, wi, wo)
            outs.append(checkpoint(fn, *args, use_reentrant=False) if remat
                        else fn(*args))
        out = torch.cat(outs)
    if not sliced:
        return _GradScale.apply(out, 1.0 / mp)
    full = torch.cat([out.new_zeros((me * sl, d)), out,
                      out.new_zeros((t_full - (me + 1) * sl, d))])
    return reduce_from(full, mesh, model_axis)


# ---------------------------------------------------------------------------
# Public layer
# ---------------------------------------------------------------------------
def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig, *, mesh=None,
            batch_axes=(), model_axis=None, activation: str = "silu"):
    """MoE FFN block.  x (B, S, d): on a mesh, this rank's rows (the
    caller splits the batch over `batch_axes`; kept for the reference's
    signature), whole on every `model_axis` rank.

    params: router (d, E), we_gate/we_in (E_pad, d, fe), we_out
    (E_pad, fe, d) [+ ws_gate/ws_in/ws_out for the fused shared expert];
    on a mesh, this rank's blocks: its E_pad / mp experts and the shared
    expert's column (ws_gate, ws_in) and row (ws_out) blocks.  Without a
    mesh, or without a model axis in it, the single-device path.
    Returns (out (B, S, d) in x's dtype, aux_loss).
    """
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, eids, aux = (route(xt, params["router"], cfg) if mesh is None
                        else route(xt, params["router"], cfg, mesh,
                                   batch_axes or ()))
    if mesh is None or model_axis is None \
            or model_axis not in axis_names(mesh):
        out = _moe_local_nosharding(xt, gates, eids, params["we_gate"],
                                    params["we_in"], params["we_out"],
                                    cfg=cfg, activation=activation)
        if cfg.n_shared:
            with f32_matmul():
                out = out + gated_mlp(xt, params["ws_gate"], params["ws_in"],
                                      params["ws_out"], activation)
        return out.reshape(b, s, d).to(x.dtype), aux
    # each rank uses only its slice of the tokens and gates (and its
    # columns of the shared expert): their gradients sum over "model"
    xs = copy_to(xt, mesh, model_axis)
    out = _moe_local(xs, copy_to(gates.to(x.dtype), mesh, model_axis), eids,
                     params["we_gate"], params["we_in"], params["we_out"],
                     cfg=cfg, mesh=mesh, model_axis=model_axis,
                     activation=activation)
    if cfg.n_shared:
        with f32_matmul():
            out = out + reduce_from(
                gated_mlp(xs, params["ws_gate"], params["ws_in"],
                          params["ws_out"], activation), mesh, model_axis)
    return out.reshape(b, s, d).to(x.dtype), aux
