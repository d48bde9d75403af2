"""Mixture-of-Experts FFN (port of `repro.models.moe`, the single-device
path).

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

Expert parallelism over a mesh (`_moe_group_local`, `_moe_local` and
their all_to_all exchange) waits for mesh B (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.distances import f32_matmul
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
def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """x (T, d) -> (gates (T, k) f32, eids (T, k) int32, aux_loss scalar).

    Top-k by a stable descending sort: of equal probabilities the lower
    expert id comes first, as `jax.lax.top_k` orders them."""
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
    f = onehot.mean(0)
    p = probs.mean(0)
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
# Public layer
# ---------------------------------------------------------------------------
def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig, *, mesh=None,
            activation: str = "silu"):
    """MoE FFN block on one device.  x (B, S, d).

    params: router (d, E), we_gate/we_in (E_pad, d, fe), we_out
    (E_pad, fe, d) [+ ws_gate/ws_in/ws_out for the fused shared expert].
    Returns (out (B, S, d) in x's dtype, aux_loss).
    """
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn over a mesh (expert parallelism with an all_to_all "
            "exchange) waits for mesh B (ROADMAP Queue 1 item 2, the second "
            "part of 7.3); pass mesh=None")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, eids, aux = route(xt, params["router"], cfg)
    out = _moe_local_nosharding(xt, gates, eids, params["we_gate"],
                                params["we_in"], params["we_out"], cfg=cfg,
                                activation=activation)
    if cfg.n_shared:
        with f32_matmul():
            out = out + gated_mlp(xt, params["ws_gate"], params["ws_in"],
                                  params["ws_out"], activation)
    return out.reshape(b, s, d).to(x.dtype), aux
