"""Trainer: the train step with gradient accumulation over a remat-aware
loss (port of `repro.train.trainer`, one device).

`make_train_step(loss_fn, opt_cfg, accum, donate)` builds a function
(state, batch) -> (state, metrics), where state is {"step", "params",
"opt", ["ef"]} and `loss_fn(params, batch) -> (loss, aux dict)`.

Gradients come from `torch.autograd.grad` over the parameter tree's
leaves (detached views of them, so the caller's tensors need no
`requires_grad`), the forward and backward under `f32_matmul`: float32
products stay IEEE in the backward too, whatever TF32 setting the caller
has.  Gradient accumulation: the batch is reshaped to (accum, micro,
...) and the micro-batches' gradients are summed in f32, then divided by
accum, as the reference's scan does.  `donate=True` updates the state's
tensors in place (JAX's donated buffers: one copy of the state);
`donate=False` returns new tensors and leaves the input state as it was.

Fault tolerance contract (train/ft.py): state is a tree of tensors -> any
step boundary is a consistent snapshot; data order is a function of step
(data/pipeline.py) -> restart replays identically.

Sharded training: with parameters laid out by `ShardCtx` specs
(`utils.sharding` DTensor leaves) and a loss that takes the mesh,
`make_train_step` runs as it is on every rank: the gradients come back
as blocks laid out as the parameters, and `adamw_update` updates each
rank's blocks.  `make_manual_dp_step` is explicit data parallelism with
a compressed gradient all-reduce (`train.compression.compressed_psum`).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.distances import f32_matmul
from ..utils.sharding import P, all_reduce, axis_size, local, shard_leaf
from ..utils.tree import leaves, tree_map, unflatten
from .compression import compressed_psum, ef_init
from .optimizer import AdamWConfig, adamw_init, adamw_update


def init_train_state(params, opt_cfg: AdamWConfig, ef: bool = False) -> dict:
    """{"step": 0 (int32), "params", "opt": AdamW state [, "ef"]} on the
    parameters' device."""
    dev = leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "params": params, "opt": adamw_init(params)}
    if ef:
        state["ef"] = ef_init(params)
    return state


def loss_and_grads(loss_fn: Callable, params, batch):
    """(loss, aux, grads) of loss_fn(params, batch) -> (loss, aux dict):
    grads a tree like params (zeros for a leaf the loss does not reach),
    the forward and backward under `f32_matmul`; nothing is updated."""
    ps = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad(), f32_matmul():
        loss, aux = loss_fn(unflatten(params, ps), batch)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            unflatten(params, gs))


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    accum: int = 1, donate: bool = True):
    """loss_fn(params, batch) -> (loss, aux dict).  Returns the step
    function (state, batch) -> (state, metrics {"loss", aux's keys
    (averaged over the micro-batches), "grad_norm", "lr"}), every metric
    a device tensor."""

    def step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, aux, g = loss_and_grads(loss_fn, params, batch)
        else:
            def micro(i):
                def cut(x):
                    n = x.shape[0] // accum
                    return x.reshape((accum, n) + tuple(x.shape[1:]))[i]
                return tree_map(cut, batch)

            g = loss = aux = None
            for i in range(accum):
                l_i, a_i, g_i = loss_and_grads(loss_fn, params, micro(i))
                if g is None:          # 0 + g: the reference's f32 sum
                    g = tree_map(lambda x: x.float(), g_i)
                    loss, aux = l_i, a_i
                else:
                    for a, b in zip(leaves(g), leaves(g_i)):
                        a.add_(b.float())
                    loss = loss + l_i
                    aux = {k: aux[k] + a_i[k] for k in aux}
                del g_i
            for x in leaves(g):
                x.div_(accum)
            loss = loss / accum
            aux = {k: v / accum for k, v in aux.items()}
        new_params, new_opt, om = adamw_update(opt_cfg, g, state["opt"],
                                               params, inplace=donate)
        del g
        if donate:
            state["step"].add_(1)
            new_state = state
        else:
            new_state = dict(state, step=state["step"] + 1,
                             params=new_params, opt=new_opt)
        return new_state, {"loss": loss, **aux, **om}

    return step


def make_manual_dp_step(loss_fn: Callable, opt_cfg: AdamWConfig, mesh,
                        dp_axes: tuple = ("data",),
                        compression: str = "int8_ef"):
    """Explicit data parallelism with a compressed gradient all-reduce
    (the cross-pod outer loop of the reference, DESIGN.md §4).

    The model is replicated: every rank holds the whole state (plain
    tensors), takes its rows of the global batch over `dp_axes`, computes
    its gradients, exchanges them with `compressed_psum` (state["ef"]
    holds int8_ef's error feedback) and applies the same AdamW update.
    Returns the step function (state, batch) -> (state, {"loss" (the
    mean over the replicas), "grad_norm", "lr"}); every rank of the mesh
    calls it."""
    axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
    n = 1
    for ax in axes:
        n *= axis_size(mesh, ax)

    def rows(x):
        return local(shard_leaf(mesh, P(axes), torch.as_tensor(x)))

    def step(state, batch):
        params = state["params"]
        loss, _aux, g = loss_and_grads(loss_fn, params, tree_map(rows, batch))
        g, new_ef = compressed_psum(g, axes, method=compression,
                                    err=state.get("ef"), mesh=mesh)
        loss = all_reduce(loss, mesh, axes) / n
        new_params, new_opt, om = adamw_update(opt_cfg, g, state["opt"],
                                               params)
        new_state = dict(state, step=state["step"] + 1, params=new_params,
                         opt=new_opt)
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, **om}

    return step
