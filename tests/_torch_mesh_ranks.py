"""Rank functions of `tests/test_torch_sharded.py`: each runs on every rank
of a gloo mesh of CPU processes (`repro_torch.launch.mesh.run_ranks`) and
returns plain numbers and numpy arrays; the test module holds them against
the JAX package in its own process.  This module imports no jax (the ranks
import it), and is not a test file."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import device_mesh
from repro_torch.models.recsys import din
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.models.transformer import (LMConfig, ShardCtx, lm_loss,
                                            lm_param_specs, params_from_jax)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, opt_state_specs
from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                       make_manual_dp_step, make_train_step)
from repro_torch.utils import sharding
from repro_torch.utils.sharding import (P, all_gather, full_tensor, local, ns,
                                        shard_tree)
from repro_torch.utils.tree import flatten_with_path


def _full(tree) -> dict:
    """{path: full numpy array} of a tree of (sharded) tensors."""
    return {k: full_tensor(v).detach().numpy().copy()
            for k, v in flatten_with_path(tree)}


def _layout(tree) -> dict:
    """{path: (local block shape, placements as text)}."""
    return {k: (tuple(local(v).shape),
                str(getattr(v, "placements", "plain")))
            for k, v in flatten_with_path(tree)}


def _lm_state(mesh, case):
    """(cfg, ctx, sharded train state) of an LM case."""
    cfg = LMConfig(**case["cfg"])
    ctx = ShardCtx(mesh=mesh)
    params = params_from_jax(case["params"], cfg, device="cpu")
    specs = lm_param_specs(cfg, ctx, fsdp_axis=case.get("fsdp"))
    opt = AdamWConfig(**case["opt"])
    state = init_train_state(shard_tree(params, specs, mesh), opt)
    if case.get("zero1"):
        state["opt"] = shard_tree(state["opt"], opt_state_specs(
            specs, zero1=True, params_shapes=params, mesh=mesh), mesh)
    return cfg, ctx, opt, specs, state


def _lm_loss_fn(cfg, ctx):
    def loss_fn(p, b):
        return lm_loss(p, cfg, b["tokens"], b["labels"], ctx)
    return loss_fn


def _batch(b) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def lm_case(mesh, case) -> dict:
    """Loss and gradients at the case's parameters, then `steps` train
    steps (`make_train_step`, in place on the sharded state); with
    case["ckpt"], the state is then saved by `AsyncCheckpointer` and the
    next batch's loss evaluated."""
    cfg, ctx, opt, _, state = _lm_state(mesh, case)
    loss_fn = _lm_loss_fn(cfg, ctx)
    b0 = _batch(case["batches"][0])
    loss, _, g = loss_and_grads(loss_fn, state["params"], b0)
    out = {"loss": float(loss), "grads": _full(g),
           "layout": _layout(state)}
    step = make_train_step(loss_fn, opt)
    losses = []
    for b in case["batches"][:case["steps"]]:
        state, m = step(state, _batch(b))
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["params"] = _full(state["params"])
    if case.get("ckpt"):
        saver = ckpt.AsyncCheckpointer(case["ckpt"], keep=1)
        saver.save(case["steps"], state)
        saver.wait()
        out["saved"] = _full(state)
        with torch.no_grad():
            nxt = loss_fn(state["params"], _batch(case["batches"][-1]))[0]
        out["next_loss"] = float(nxt)
    return out


def restore_case(mesh, case) -> dict:
    """Restore the case's checkpoint onto this mesh with `restore_sharded`
    (through `ft.resume_or_init`), laid out by the case's specs for this
    mesh; the restored leaves (full) and the next batch's loss."""
    from repro_torch.train.ft import FTConfig, resume_or_init

    cfg, ctx, opt, specs, _ = _lm_state(mesh, case)
    params = params_from_jax(case["params"], cfg, device="cpu")

    def to_ns(tree):
        return sharding.map_specs(lambda s, _: ns(mesh, s), tree, tree)

    ospecs = opt_state_specs(specs, zero1=bool(case.get("zero1")),
                             params_shapes=params, mesh=mesh)
    shardings = {"step": None, "params": to_ns(specs), "opt": to_ns(ospecs)}
    state = resume_or_init(lambda: init_train_state(params, opt),
                           FTConfig(ckpt_dir=case["ckpt"]),
                           shardings=shardings)
    with torch.no_grad():
        nxt = _lm_loss_fn(cfg, ctx)(state["params"],
                                    _batch(case["batches"][-1]))[0]
    return {"restored": _full(state), "next_loss": float(nxt),
            "layout": _layout(state)}


def lookup_case(mesh, case) -> dict:
    """The row-sharded lookup's rows, gathered over the data axis."""
    table = torch.as_tensor(case["table"])
    ids = torch.as_tensor(case["ids"])
    t = shard_tree(table, P("model", None), mesh)
    rows = sharded_lookup(t, ids, mesh, "model", ("data",))
    return {"sharded": all_gather(rows, mesh, "data", 0).numpy(),
            "plain": sharded_lookup(table, ids).numpy()}


def din_case(mesh, case) -> dict:
    """DIN's sharded loss and gradients (tables row-sharded over model,
    batch over data)."""
    cfg = din.DINConfig(**case["cfg"])
    model = din.params_from_jax(case["params"], cfg, device="cpu")
    tree = shard_tree(model.param_tree(), din.param_specs(cfg, mesh), mesh)
    batch = _batch(case["batch"])
    loss, _, g = loss_and_grads(
        lambda p, b: (din.loss_fn(p, cfg, b, mesh, "model", ("data",)), {}),
        tree, batch)
    sharded = din.DIN(cfg, tree["item_emb"], tree["cate_emb"],
                      model.attn_w, model.attn_b, model.mlp_w, model.mlp_b)
    short = sharded.shortlist(batch, case["n_candidates"], "ref", mesh,
                              "model", ("data",))
    return {"loss": float(loss), "grads": _full(g), "layout": _layout(tree),
            "shortlist": all_gather(short, mesh, "data", 0).numpy(),
            "shortlist_one": model.shortlist(batch, case["n_candidates"],
                                             "ref").numpy()}


def dp_case(mesh, case) -> dict:
    """`make_manual_dp_step` on a (world,) data mesh of the same ranks,
    ten steps, and one `compressed_psum` of rank-dependent gradients per
    method."""
    from repro_torch.train.compression import compressed_psum, ef_init

    dmesh = device_mesh((sharding.mesh_size(mesh),), ("data",), "cpu")
    cfg = LMConfig(**case["cfg"])
    opt = AdamWConfig(**case["opt"])
    params = params_from_jax(case["params"], cfg, device="cpu")
    ctx_n = ShardCtx(mesh=None)
    step = make_manual_dp_step(_lm_loss_fn(cfg, ctx_n), opt, dmesh,
                               compression="int8_ef")
    state = init_train_state(params, opt, ef=True)
    losses = []
    for b in case["batches"]:
        state, m = step(state, _batch(b))
        losses.append(float(m["loss"]))
    me = dmesh.get_local_rank("data")
    grads = {"w": torch.as_tensor(case["grads"][me]),
             "b": torch.as_tensor(case["grads"][me] [0])}
    psums = {}
    for method in ("none", "bf16", "int8_ef"):
        err = ef_init(grads) if method == "int8_ef" else None
        got, new_err = compressed_psum(grads, ("data",), method, err,
                                       mesh=dmesh)
        psums[method] = {k: v.numpy() for k, v in got.items()}
        if new_err is not None:
            psums["err"] = {k: v.numpy() for k, v in new_err.items()}
    return {"losses": losses, "psum": psums}


def mesh4(mesh, cases: dict) -> dict:
    """Every case of the 4-rank run, on this (2, 2) mesh."""
    out = {"coordinate": tuple(mesh.get_coordinate())}
    for name in ("tp", "fsdp", "zero1"):
        out[name] = lm_case(mesh, cases[name])
    out["lookup"] = lookup_case(mesh, cases["lookup"])
    out["din"] = din_case(mesh, cases["din"])
    out["dp"] = dp_case(mesh, cases["dp"])
    out["comm"] = sharding.comm_log.snapshot()
    return out


def fail_on_rank_1(mesh):
    """Rank 1 raises; the others wait in a collective."""
    if mesh.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    sharding.barrier(mesh)
    return np.zeros(1)

