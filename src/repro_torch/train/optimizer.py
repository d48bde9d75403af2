"""AdamW + global-norm clipping + LR schedules over parameter trees
(port of `repro.train.optimizer`).

The update is the reference's arithmetic in the reference's order: clip
by the global norm, bias corrections from `count` in f32,
`step = mh / (sqrt(vh) + eps) + wd * p`, `p - lr * step`, leaf by leaf
(not `torch.optim.AdamW`, which orders and rounds differently).  The
learning rate, `count` and every metric stay device tensors, so a step
never waits on the host.

Sharded leaves (`utils.sharding` DTensors): every rank updates its own
blocks, the clip uses the global norm (each block's sum of squares summed
over the axes that shard it: the same on every rank).  ZeRO-1
(`opt_state_specs`): the moments shard their leading dim over the data
axis when divisible and free; a parameter replicated over that axis is
then updated on the moments' block and all-gathered back (the
reduce-scatter / sharded update / all-gather schedule GSPMD lowers the
reference's update into).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..utils.sharding import (P, all_gather, axis_names, axis_size, local,
                              map_specs, sharded_dims)
from ..utils.tree import global_norm, leaves, tree_map, unflatten

__all__ = ["AdamWConfig", "lr_at", "adamw_init", "global_norm",
           "adamw_update", "opt_state_specs"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"      # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (a tensor or int), an f32 tensor on
    the step's device: linear warmup, then cosine decay to
    min_lr_frac * lr at total_steps (or constant)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> dict:
    """m and v zeros like the parameters, count 0 (int32) on the first
    leaf's device."""
    dev = leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params,
                 inplace: bool = False):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).

    inplace=True writes the new parameters, moments and count into the
    given tensors (the trainer's `donate`) and returns those trees;
    otherwise the inputs are left as they were."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9),
                            max=1.0)
    lr = lr_at(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        if isinstance(p, DTensor) or isinstance(m, DTensor):
            return _upd_blocks(p, g, m, v, upd)
        if scale is not None:
            g = g * scale
        g = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * step).to(p.dtype)
        if inplace:
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
            return p, m, v
        return p_new, m_new, v_new

    def _upd_blocks(p, g, m, v, upd_local):
        """The update on this rank's blocks: on the moments' block of p
        and g where ZeRO-1 shards the moments further (then p's new block
        is all-gathered back)."""
        extra = [ad for ad in sharded_dims(m) if ad not in sharded_dims(p)]
        pl, gl = local(p), local(g)
        mesh = m.device_mesh if isinstance(m, DTensor) else p.device_mesh
        for axis, d in extra:
            c = pl.shape[d] // axis_size(mesh, axis)
            i = mesh.get_local_rank(axis)
            pl, gl = pl.narrow(d, i * c, c), gl.narrow(d, i * c, c)
        p_new, m_new, v_new = upd_local(pl, gl, local(m), local(v))
        for axis, d in reversed(extra):
            p_new = all_gather(p_new, mesh, axis, d)
        if inplace:
            if extra:
                local(p).copy_(p_new)
            return p, m, v
        return _like(p, p_new), _like(m, m_new), _like(v, v_new)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["v"]))]
    if inplace:
        state["count"].copy_(count)
        count = state["count"]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gn, "lr": lr}


def _like(x, new_local):
    """`new_local` laid out as the DTensor `x` (a plain `x`: itself)."""
    if not isinstance(x, DTensor):
        return new_local
    return DTensor.from_local(new_local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def opt_state_specs(param_specs, zero1: bool = False, params_shapes=None,
                    mesh=None, data_axis: str = "data"):
    """Specs for the optimizer state tree.  zero1=True additionally shards
    each moment's first dim over `data_axis` when divisible and free
    (`params_shapes`: the parameters, or their shapes)."""
    def moment_spec(spec, shape):
        if not zero1 or mesh is None or data_axis not in axis_names(mesh):
            return spec
        dp = axis_size(mesh, data_axis)
        dims = list(spec) if spec is not None else [None] * len(shape)
        while len(dims) < len(shape):
            dims.append(None)
        if dims and dims[0] is None and shape[0] % dp == 0:
            dims[0] = data_axis
            return P(*dims)
        return spec

    if params_shapes is None:
        m_specs = param_specs
    else:
        m_specs = map_specs(moment_spec, param_specs, params_shapes)
    return {"m": m_specs, "v": m_specs,
            "count": P() if mesh is not None else None}
