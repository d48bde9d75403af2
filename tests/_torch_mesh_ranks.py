"""Rank functions of `tests/test_torch_sharded.py`: each runs on every rank
of a gloo mesh of CPU processes (`repro_torch.launch.mesh.run_ranks`) and
returns plain numbers and numpy arrays; the test module holds them against
the JAX package in its own process.  This module imports no jax (the ranks
import it), and is not a test file."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import cells
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import moe
from repro_torch.models.gnn import dimenet, graphcast, mace, nequip
from repro_torch.models.gnn.common import tree_from_numpy
from repro_torch.models.gnn.ring_gather import ring_gather, ring_scatter_add
from repro_torch.models.recsys import din
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.models.transformer import (LMConfig, ShardCtx, cache_specs,
                                            decode_step, lm_loss,
                                            lm_param_specs, params_from_jax,
                                            serve_prefill)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         opt_state_specs)
from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                       make_manual_dp_step, make_train_step)
from repro_torch.utils import sharding
from repro_torch.utils.sharding import (P, all_gather, coordinate,
                                        full_tensor, local, local_block, ns,
                                        placements, shard_tree)
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


def lm_config(cfg: dict) -> LMConfig:
    """An LMConfig from a case's dict (its "moe" entry a dict too)."""
    if cfg.get("moe") is not None:
        cfg = dict(cfg, moe=moe.MoEConfig(**cfg["moe"]))
    return LMConfig(**cfg)


def _every_rank(x: torch.Tensor, mesh) -> np.ndarray:
    """(world, ...) of each rank's `x` (the same shape on every rank), in
    rank order (every rank calls)."""
    x = x.detach()[None]
    for axis in reversed(sharding.axis_names(mesh)):
        x = all_gather(x, mesh, axis, 0)
    return x.numpy().copy()


def _from_blocks(block: torch.Tensor, mesh, spec, shape) -> np.ndarray:
    """The full array whose `spec` blocks the ranks hold (every rank
    calls)."""
    stride = torch.empty(shape).stride()
    dt = DTensor.from_local(block, mesh, placements(mesh, spec),
                            run_check=False, shape=torch.Size(shape),
                            stride=stride)
    return full_tensor(dt).numpy().copy()


def _lm_state(mesh, case):
    """(cfg, ctx, sharded train state) of an LM case."""
    cfg = lm_config(case["cfg"])
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


def _serve_state(mesh, case):
    cfg = lm_config(case["cfg"])
    ctx = ShardCtx(mesh=mesh)
    params = params_from_jax(case["params"], cfg, device="cpu")
    return cfg, ctx, shard_tree(params, lm_param_specs(cfg, ctx), mesh)


def decode_case(mesh, case) -> dict:
    """Sharded decode steps: for each (mode, mesh shape, cache, positions)
    of case["runs"], the full cache cut into this rank's block by
    `cache_specs`, one `decode_step(ctx=)`; each rank's logits, the new
    cache and lengths reassembled whole.  Then the sharded prefill on this
    mesh: its logits on each rank and its "head" cache whole."""
    out = {"runs": []}
    meshes = {tuple(mesh.shape): mesh}
    for run in case["runs"]:
        shape = tuple(run["mesh"])
        if shape not in meshes:
            meshes[shape] = device_mesh(shape, ("data", "model"), "cpu")
        m = meshes[shape]
        cfg, ctx, params = _serve_state(m, case)
        ck, cv, ln = (torch.as_tensor(case["caches"][run["cache"]][i])
                      for i in range(3))
        specs = cache_specs(cfg, ctx, run["mode"])
        blocks = [local_block(m, sp, x).clone()
                  for sp, x in zip(specs, (ck, cv, ln))]
        with torch.no_grad():
            logits, (nk, nv, nl) = decode_step(
                params, cfg, torch.as_tensor(case["tokens"][:, :1]),
                torch.as_tensor(run["positions"]), tuple(blocks),
                kv_mode=run["mode"], ctx=ctx)
        out["runs"].append({
            "logits": _every_rank(logits, mesh),
            "ck": _from_blocks(nk, m, specs[0], ck.shape),
            "cv": _from_blocks(nv, m, specs[1], cv.shape),
            "lengths": _from_blocks(nl, m, specs[2], ln.shape),
            "block": tuple(nk.shape)})
    cfg, ctx, params = _serve_state(mesh, case)
    with torch.no_grad():
        logits, (ck, cv), ln = serve_prefill(
            params, cfg, torch.as_tensor(case["tokens"]), ctx=ctx)
    spec = cache_specs(cfg, ctx, "head")
    b, s = case["tokens"].shape
    full = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    out["prefill"] = {"logits": _every_rank(logits, mesh),
                      "ck": _from_blocks(ck, mesh, spec[0], full),
                      "cv": _from_blocks(cv, mesh, spec[1], full),
                      "lengths": _from_blocks(ln, mesh, spec[2], (b,))}
    return out


# an MoE layer's leaves over "model": experts split, the shared expert
# column- then row-parallel, the router whole
MOE_SPECS = {"router": None, "we_gate": P("model"), "we_in": P("model"),
             "we_out": P("model"), "ws_gate": P(None, "model"),
             "ws_in": P(None, "model"), "ws_out": P("model")}


def moe_drop_case(mesh, case) -> dict:
    """`moe_ffn(mesh=...)` on this rank's rows at the case's capacities:
    each rank's output and its dropped slots, for each `groups`."""
    cfg0 = moe.MoEConfig(**case["moe"])
    x = torch.as_tensor(case["x"])
    ctx = ShardCtx(mesh=mesh)
    rows, _ = ctx.batch_rows(x)
    p = {k: local_block(mesh, MOE_SPECS[k], torch.as_tensor(v))
         for k, v in case["params"].items()}
    out = {}
    for groups in case["groups"]:
        cfg = dataclasses.replace(cfg0, groups=groups)
        moe.drop_log.reset()
        moe.drop_log.on = True
        with torch.no_grad():
            y, aux = moe.moe_ffn(rows, p, cfg, mesh=mesh,
                                 batch_axes=("data",), model_axis="model")
        moe.drop_log.on = False
        d = moe.drop_log.snapshot()
        out[groups] = {"out": _every_rank(y, mesh),
                       "aux": _every_rank(aux, mesh),
                       "drops": _every_rank(torch.tensor(
                           [d["slots"], d["send"], d["expert"]]), mesh)}
    return out


def moe_grad_case(mesh, case) -> dict:
    """Gradients through `moe_ffn(mesh=...)` where "model" does not divide
    a rank's tokens (every model rank runs them all): each rank's loss
    sum(out * g) + aux on its rows; each leaf's gradient summed over
    "data" (the data-parallel sum) and reassembled whole."""
    cfg = moe.MoEConfig(**case["moe"])
    ctx = ShardCtx(mesh=mesh)
    rows, _ = ctx.batch_rows(torch.as_tensor(case["x"]))
    g, _ = ctx.batch_rows(torch.as_tensor(case["g"]))
    rows = rows.clone().requires_grad_()
    p = {k: local_block(mesh, MOE_SPECS[k], torch.as_tensor(v)).clone()
         .requires_grad_() for k, v in case["params"].items()}
    out, aux = moe.moe_ffn(rows, p, cfg, mesh=mesh, batch_axes=("data",),
                           model_axis="model")
    ((out * g).sum() + aux).backward()
    grads = {k: _from_blocks(sharding.all_reduce(v.grad, mesh, "data"), mesh,
                             MOE_SPECS[k], case["params"][k].shape)
             for k, v in p.items()}
    grads["x"] = _from_blocks(rows.grad, mesh, P("data"), case["x"].shape)
    return {"grads": grads, "x_by_rank": _every_rank(rows.grad, mesh)}


RING_AXES = ("data", "model")
GNN_MODULES = {"nequip": nequip, "mace": mace, "dimenet": dimenet,
               "graphcast": graphcast}


def ring_case(mesh, case) -> dict:
    """The ring ops over both axes of this mesh (a ring of 4) at the
    reference test's inputs: the gather's output and the gradient of
    sum(out^2) at the table, the scatter's output and the gradient at the
    values, each as the whole array (every rank's block), and the
    collective-permutes this rank ran."""
    me, p = coordinate(mesh, RING_AXES)
    spec = P(RING_AXES, None)

    def block(a):
        n = a.shape[0] // p
        return torch.from_numpy(a[me * n:(me + 1) * n].copy())

    sharding.comm_log.reset()
    tab = block(case["table"]).requires_grad_(True)
    out = ring_gather(tab, block(case["idx"]), mesh, RING_AXES)
    (out ** 2).sum().backward()
    vals = block(case["vals"]).requires_grad_(True)
    s = ring_scatter_add(vals, block(case["idx"]), mesh, RING_AXES,
                         case["table"].shape[0] // p)
    (s ** 2).sum().backward()
    permutes = sharding.comm_log.calls["collective-permute"]
    whole = {k: _from_blocks(v.detach(), mesh, spec, case[src].shape)
             for k, v, src in (("out", out, "out"), ("g_table", tab.grad,
                                                     "table"),
                               ("s", s, "table"), ("g_vals", vals.grad,
                                                   "vals"))}
    return dict(whole, permutes=permutes)


def _gnn_batch(mesh, batch: dict) -> dict:
    """A whole batch (numpy) laid out by the GNN cells' specs."""
    bt = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return shard_tree(bt, cells._gnn_batch_specs(bt, mesh), mesh)


def gnn_case(mesh, case) -> dict:
    """The GNN cells' rank program at reduced configs: each run's loss and
    summed gradients (whole, every rank the same) with the ring hooks,
    the plain ones or the cells' gated ones, and the permutes it ran;
    then one train step of a nequip cell (`cells._build_gnn`, reduced
    config, a small molecule shape) from the case's state."""
    out = {}
    for name, arch, kind in case["runs"]:
        mod = GNN_MODULES[arch]
        cfg = case["cfgs"][arch]
        params = tree_from_numpy(case["params"][arch], "cpu")
        hooks = {"ring": cells.ring_hooks, "plain": cells.plain_hooks}[kind](
            mesh) if kind != "gated" else cells.gated_hooks(arch, mesh)
        loss_fn = cells.gnn_rank_loss(arch, mod, cfg, mesh, hooks)
        sharding.comm_log.reset()
        loss, _, g = loss_and_grads(loss_fn, params,
                                    _gnn_batch(mesh, case["batches"][arch]))
        g = cells.sum_grads(g, mesh)
        out[name] = {"loss": float(loss),
                     "grads": {k: v.numpy().copy()
                               for k, v in flatten_with_path(g)},
                     "comm": sharding.comm_log.snapshot()}
    stub = type("Arch", (), {"ARCH_ID": "nequip", "model_config":
                             staticmethod(lambda: case["cfgs"]["nequip"])})
    cell = cells._build_gnn(stub, ShapeSpec(**case["cell_shape"]), mesh, {})
    params = tree_from_numpy(case["params"]["nequip"], "cpu")
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": adamw_init(params)}
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in case["cell_batch"].items()}
    new, metrics = cell.fn(*cell.rank_args(mesh, (state, batch)))
    out["cell"] = {"loss": float(metrics["loss"]),
                   "params": {k: v.numpy().copy()
                              for k, v in flatten_with_path(new["params"])},
                   "step": int(new["step"])}
    return out


def mesh4(mesh, cases: dict) -> dict:
    """Every case of the 4-rank run, on this (2, 2) mesh."""
    out = {"coordinate": tuple(mesh.get_coordinate())}
    for name in ("tp", "fsdp", "zero1", "moe"):
        out[name] = lm_case(mesh, cases[name])
    out["lookup"] = lookup_case(mesh, cases["lookup"])
    out["din"] = din_case(mesh, cases["din"])
    out["dp"] = dp_case(mesh, cases["dp"])
    out["decode"] = decode_case(mesh, cases["decode"])
    out["moe_drop"] = moe_drop_case(mesh, cases["moe_drop"])
    out["moe_grad"] = moe_grad_case(mesh, cases["moe_grad"])
    out["comm"] = sharding.comm_log.snapshot()
    out["ring"] = ring_case(mesh, cases["ring"])
    out["gnn"] = gnn_case(mesh, cases["gnn"])
    return out


def fail_on_rank_1(mesh):
    """Rank 1 raises; the others wait in a collective."""
    if mesh.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    sharding.barrier(mesh)
    return np.zeros(1)

