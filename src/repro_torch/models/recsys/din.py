"""DIN: Deep Interest Network [arXiv:1706.06978] (port of
`repro.models.recsys.din`, the serving path).

Assigned config: embed_dim=18, behavior seq_len=100, attention MLP 80-40,
final MLP 200-80, target attention interaction.

Per-behavior feature = [item_emb || cate_emb] (2*18=36).  Target attention
scores each history behavior against the candidate with
MLP([e_h, e_t, e_h - e_t, e_h * e_t]) (80-40-1, unnormalized weights as in
the paper), producing the user-interest vector; final MLP
(interest || target || mean-pooled history) -> 200 -> 80 -> 1.

Serving shapes: serve_p99 / serve_bulk run `DIN.forward_scores`;
retrieval_cand runs `DIN.retrieval_step`, a cascade of (a) an exact L2
shortlist of the history's mean item embedding against the candidate
rows, through the fused `l2_topk` kernel, then (b) a full DIN re-rank of
the shortlist.

`DIN` holds the tables and the two MLPs with the reference's layouts
(weights (d_in, d_out), applied as x @ w + b), so a JAX parameter tree
crosses over as it is (`params_from_jax`).  Every product runs in IEEE f32
(`core.distances.f32_matmul`).  The history is mean-pooled by a masked sum
over the sequence axis, not by `embedding_bag`'s scatter-add, so that two
runs on the card give the same bits.

Training: `DIN.param_tree()` is the reference's `init_params` tree (the
module's own tensors), and `loss_fn(params, cfg, batch)` is the
reference's stable BCE on f32 logits, computed from such a tree through
the module's forward (`torch.func.functional_call` on a skeleton with
meta tensors), so gradients reach the tree's leaves.  The tables' and
MLPs' `requires_grad` is the constructor's `trainable` (off: serving).

Over a `DeviceMesh` (`param_specs`): the tables are row-sharded over
`model_axis`, the MLPs replicated; `forward_scores` and `loss_fn` take
`mesh` / `model_axis` / `batch_axes` as the reference's do: each rank
scores its rows of the batch (split over `batch_axes`) with
`embedding.sharded_lookup` on its block of the tables, and the loss is
the global batch's mean on every rank.  `shortlist` takes them for its
history lookup; its candidates span the whole (gathered) table.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..._device import resolve_device, to_device
from ...core.distances import f32_matmul
from ...kernels.l2_topk import l2_topk
from ...utils import sharding
from ...utils.sharding import P
from ...utils.tree import tree_map
from ..layers import dense_init
from .embedding import sharded_lookup


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    n_items: int = 1_000_000
    n_cates: int = 1024
    rerank_k: int = 1024     # cascade width for retrieval_cand

    @property
    def d_feat(self) -> int:
        return 2 * self.embed_dim  # item || cate

    def layer_sizes(self) -> tuple[tuple, tuple]:
        """Widths of the attention MLP and of the final MLP, input first."""
        d = self.d_feat
        return ((4 * d,) + tuple(self.attn_mlp) + (1,),
                (3 * d,) + tuple(self.mlp) + (1,))


BATCH_KEYS = ("hist_items", "hist_cates", "hist_len", "target_item",
              "target_cate")




def _mlp(ws, bs, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def _masked_mean(e: torch.Tensor, hist_len: torch.Tensor) -> torch.Tensor:
    """e (B, S, d): the mean of the first hist_len rows of each batch row,
    divided by max(hist_len, 1)."""
    mask = (torch.arange(e.shape[1], device=e.device)[None, :]
            < hist_len[:, None])
    pooled = torch.where(mask[..., None], e, 0.0).sum(1)
    return pooled / hist_len.clamp_min(1)[:, None].to(pooled.dtype)


def param_specs(cfg: DINConfig, mesh, model_axis="model") -> dict:
    """Spec tree of `DIN.param_tree` (the reference's): the tables
    P(model_axis, None), the MLPs replicated; all None without a mesh."""
    n_attn, n_mlp = len(cfg.attn_mlp) + 1, len(cfg.mlp) + 1
    if mesh is None:
        rep = tab = None
    else:
        rep, tab = P(), P(model_axis, None)
    return {"item_emb": tab, "cate_emb": tab,
            "attn": {"w": [rep] * n_attn, "b": [rep] * n_attn},
            "mlp": {"w": [rep] * n_mlp, "b": [rep] * n_mlp}}


def _rows(bt: dict, mesh, batch_axes) -> dict:
    """This rank's rows of each array of a global batch over `batch_axes`
    (all of them without a mesh or batch axes)."""
    if mesh is None or not batch_axes:
        return bt
    return {k: sharding.local(sharding.shard_leaf(mesh, P(tuple(batch_axes)),
                                                  v)) for k, v in bt.items()}


def _bag_mean(table: torch.Tensor, ids: torch.Tensor,
              valid: torch.Tensor, mesh=None,
              model_axis=None) -> torch.Tensor:
    """The reference's `embedding_bag(..., mode="mean")` over contiguous
    bags: row b pools table[ids[b, s]] where valid[b, s] and ids >= 0,
    divided by max(count, 1); a masked sum, in a fixed order."""
    ok = valid & (ids >= 0)
    rows = torch.where(ok[..., None],
                       sharded_lookup(table, ids, mesh, model_axis), 0.0)
    return rows.sum(1) / ok.sum(1).clamp_min(1)[:, None].to(rows.dtype)


class DIN(nn.Module):
    """DIN's tables and MLPs, and its serving functions."""

    def __init__(self, cfg: DINConfig, item_emb: torch.Tensor,
                 cate_emb: torch.Tensor, attn_w, attn_b, mlp_w, mlp_b,
                 trainable: bool = False):
        super().__init__()
        want = {"item_emb": (cfg.n_items, cfg.embed_dim),
                "cate_emb": (cfg.n_cates, cfg.embed_dim)}
        for name, t in (("item_emb", item_emb), ("cate_emb", cate_emb)):
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {want[name]} for {cfg}")
        attn_sizes, mlp_sizes = cfg.layer_sizes()
        for name, ws, sizes in (("attn", attn_w, attn_sizes),
                                ("mlp", mlp_w, mlp_sizes)):
            got = [tuple(w.shape) for w in ws]
            if got != list(zip(sizes[:-1], sizes[1:])):
                raise ValueError(f"{name} weights have shapes {got}, "
                                 f"expected widths {sizes}")
        def param(t):
            return nn.Parameter(t, requires_grad=trainable)

        self.cfg = cfg
        self.item_emb = param(item_emb)
        self.cate_emb = param(cate_emb)
        self.attn_w = nn.ParameterList(param(w) for w in attn_w)
        self.attn_b = nn.ParameterList(param(b) for b in attn_b)
        self.mlp_w = nn.ParameterList(param(w) for w in mlp_w)
        self.mlp_b = nn.ParameterList(param(b) for b in mlp_b)

    @property
    def device(self) -> torch.device:
        return self.item_emb.device

    def param_tree(self) -> dict:
        """The reference's `init_params` layout, holding this module's own
        tensors: item_emb, cate_emb, attn.{w,b}[i], mlp.{w,b}[i]."""
        return {"item_emb": self.item_emb, "cate_emb": self.cate_emb,
                "attn": {"w": list(self.attn_w), "b": list(self.attn_b)},
                "mlp": {"w": list(self.mlp_w), "b": list(self.mlp_b)}}

    def _batch(self, batch: dict) -> dict:
        """The batch's arrays (numpy or tensors) on the model's device."""
        return {k: to_device(batch[k], self.device) for k in BATCH_KEYS
                if k in batch}

    def _behavior_embed(self, items, cates, mesh=None,
                        model_axis=None) -> torch.Tensor:
        return torch.cat(
            [sharded_lookup(self.item_emb, items, mesh, model_axis),
             sharded_lookup(self.cate_emb, cates, mesh, model_axis)], -1)

    def target_attention(self, e_hist: torch.Tensor, e_tgt: torch.Tensor,
                         hist_len: torch.Tensor) -> torch.Tensor:
        """e_hist (B, S, d), e_tgt (B, d) -> interest (B, d).

        Unnormalized attention weights (paper); positions at or past
        hist_len are masked to 0."""
        b, s, d = e_hist.shape
        et = e_tgt[:, None, :].expand(b, s, d)
        feats = torch.cat([e_hist, et, e_hist - et, e_hist * et], -1)
        with f32_matmul():
            w = _mlp(self.attn_w, self.attn_b, feats)[..., 0]      # (B, S)
            mask = (torch.arange(s, device=e_hist.device)[None, :]
                    < hist_len[:, None])
            w = torch.where(mask, w, 0.0)
            return torch.einsum("bs,bsd->bd", w, e_hist)

    def forward_scores(self, batch: dict, mesh=None, model_axis="model",
                       batch_axes=()) -> torch.Tensor:
        """CTR logits (B,).  batch: hist_items / hist_cates (B, S),
        hist_len (B,), target_item / target_cate (B,), as numpy arrays or
        tensors.  With a mesh: the module holds this rank's blocks of the
        tables (rows over `model_axis`), and the logits are this rank's
        rows of the batch over `batch_axes`."""
        bt = _rows(self._batch(batch), mesh, batch_axes)
        if mesh is None:
            model_axis = None
        hist_len = bt["hist_len"]
        e_hist = self._behavior_embed(bt["hist_items"], bt["hist_cates"],
                                      mesh, model_axis)
        e_tgt = self._behavior_embed(bt["target_item"], bt["target_cate"],
                                     mesh, model_axis)
        interest = self.target_attention(e_hist, e_tgt, hist_len)
        valid = (torch.arange(e_hist.shape[1], device=self.device)[None, :]
                 < hist_len[:, None])
        pooled = torch.cat(
            [_bag_mean(self.item_emb, bt["hist_items"], valid, mesh,
                       model_axis),
             _bag_mean(self.cate_emb, bt["hist_cates"], valid, mesh,
                       model_axis)], -1)
        x = torch.cat([interest, e_tgt, pooled], -1)
        with f32_matmul():
            return _mlp(self.mlp_w, self.mlp_b, x)[..., 0]

    forward = forward_scores

    def user_interest_vector(self, batch: dict) -> torch.Tensor:
        """Query-side vector for ANN retrieval: the mean behavior embedding
        over the history (target-independent), (B, 2 * embed_dim)."""
        bt = self._batch(batch)
        e_hist = self._behavior_embed(bt["hist_items"], bt["hist_cates"])
        return _masked_mean(e_hist, bt["hist_len"])

    def shortlist(self, batch: dict, n_candidates: int,
                  backend: str = "auto", mesh=None, model_axis="model",
                  batch_axes=()) -> torch.Tensor:
        """Stage (a) of `retrieval_step`: the min(rerank_k, n_candidates)
        first rows of the item table nearest (squared L2) to the history's
        mean item embedding, (B, kk) int64 item ids, nearest first.

        With a mesh (the tables DTensors laid out by `param_specs`): the
        history's lookup is `sharded_lookup` on this rank's rows of the
        batch over `batch_axes`, as the reference's `retrieval_step` takes
        it, and the candidates span the whole table, gathered on every
        rank; the result is this rank's rows."""
        bt = _rows(self._batch(batch), mesh, batch_axes)
        q = _masked_mean(sharded_lookup(
            self.item_emb, bt["hist_items"], mesh,
            model_axis if mesh is not None else None), bt["hist_len"])
        table = sharding.full_tensor(self.item_emb)
        cand = (table if n_candidates == table.shape[0]
                else table[:n_candidates])
        kk = min(self.cfg.rerank_k, n_candidates)
        _, short = l2_topk(q, cand, kk, backend=backend)
        return short.long().clamp(0, n_candidates - 1)

    def rerank(self, batch: dict, items: torch.Tensor, k: int, mesh=None,
               model_axis="model"):
        """Stage (b) of `retrieval_step`: score each row's (B, kk) candidate
        items with the full DIN, one forward over B * kk rows, and keep
        the k best.  Returns (scores (B, k) descending, item ids (B, k));
        equal scores keep the lower candidate position first, as
        `jax.lax.top_k` does.  With a mesh: `batch` and `items` are this
        rank's rows, the tables' lookups `sharded_lookup` over
        `model_axis`."""
        bt = self._batch(batch)
        b, kk = items.shape
        if k > kk:
            raise ValueError(f"k = {k} exceeds the {kk} shortlisted items")

        def per_candidate(a):
            return a[:, None].expand(b, kk, *a.shape[1:]).reshape(
                b * kk, *a.shape[1:])

        flat = items.reshape(-1)
        sub = {"hist_items": per_candidate(bt["hist_items"]),
               "hist_cates": per_candidate(bt["hist_cates"]),
               "hist_len": per_candidate(bt["hist_len"]),
               "target_item": flat,
               "target_cate": (flat % self.cfg.n_cates).to(torch.int32)}
        scores = self.forward_scores(sub, mesh, model_axis).reshape(b, kk)
        top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
        return top_s[:, :k], torch.gather(items, 1, top_i[:, :k])

    def retrieval_step(self, batch: dict, n_candidates: int, k: int = 100,
                       backend: str = "auto"):
        """Score 1..B queries against the first `n_candidates` rows of the
        item table: L2 shortlist in embedding space (the `l2_topk` kernel
        under "auto" / "cuda" on the card, its plain version under "ref"),
        then a full DIN re-rank of the top rerank_k.  Returns
        (scores (B, k) descending, item ids (B, k) int64)."""
        return self.rerank(batch, self.shortlist(batch, n_candidates,
                                                 backend), k)


def init_params(cfg: DINConfig, generator: torch.Generator,
                device=None, trainable: bool = False) -> DIN:
    """A DIN with the reference's initialisation: tables N(0, 0.05^2),
    weights N(0, 1/d_in), zero biases.  Drawn from `generator` (torch's
    numbers, not jax.random's) on its device, in the reference's order,
    then moved to `device` (None means the CUDA device); `trainable` sets
    the tensors' requires_grad."""
    dev = resolve_device(device)
    attn_sizes, mlp_sizes = cfg.layer_sizes()

    def table(rows):
        return (torch.randn((rows, cfg.embed_dim), generator=generator,
                            device=generator.device) * 0.05).to(dev)

    def dense(sizes):
        return ([dense_init(generator, a, c, dev)
                 for a, c in zip(sizes[:-1], sizes[1:])],
                [torch.zeros(c, device=dev) for c in sizes[1:]])

    item_emb = table(cfg.n_items)
    cate_emb = table(cfg.n_cates)
    return DIN(cfg, item_emb, cate_emb, *dense(attn_sizes), *dense(mlp_sizes),
               trainable=trainable)


def params_from_jax(tree: dict, cfg: DINConfig, device=None) -> DIN:
    """The port's DIN from the reference's `init_params` tree (numpy
    arrays, or anything `numpy.asarray` reads), as float32 on `device`
    (None means the CUDA device); no transposes."""
    dev = resolve_device(device)

    def t(a):
        return to_device(a, dev, torch.float32)

    return DIN(cfg, t(tree["item_emb"]), t(tree["cate_emb"]),
               [t(w) for w in tree["attn"]["w"]],
               [t(b) for b in tree["attn"]["b"]],
               [t(w) for w in tree["mlp"]["w"]],
               [t(b) for b in tree["mlp"]["b"]])


def _skeleton(cfg: DINConfig) -> DIN:
    """A DIN of `cfg`'s shapes on the meta device: the module whose
    forward `loss_fn` runs on a parameter tree."""
    def t(*shape):
        return torch.empty(shape, device="meta")

    attn_sizes, mlp_sizes = cfg.layer_sizes()

    def dense(sizes):
        pairs = list(zip(sizes[:-1], sizes[1:]))
        return [t(a, c) for a, c in pairs], [t(c) for _, c in pairs]

    return DIN(cfg, t(cfg.n_items, cfg.embed_dim),
               t(cfg.n_cates, cfg.embed_dim), *dense(attn_sizes),
               *dense(mlp_sizes))


def _module_names(params: dict) -> dict:
    """A `param_tree` layout as the module's parameter names."""
    out = {"item_emb": params["item_emb"], "cate_emb": params["cate_emb"]}
    for part in ("attn", "mlp"):
        for kind in ("w", "b"):
            for i, x in enumerate(params[part][kind]):
                out[f"{part}_{kind}.{i}"] = x
    return out


def _module(params: dict, cfg: DINConfig) -> DIN:
    """A DIN holding a parameter tree's own tensors (not trainable)."""
    return DIN(cfg, params["item_emb"], params["cate_emb"],
               params["attn"]["w"], params["attn"]["b"], params["mlp"]["w"],
               params["mlp"]["b"])


def forward_scores(params: dict, cfg: DINConfig, batch: dict, mesh=None,
                   model_axis="model", batch_axes=()) -> torch.Tensor:
    """CTR logits (B,) from a parameter tree in the reference's layout
    (the reference's module-level `forward_scores`), differentiable in
    its leaves.  With a mesh: the leaves laid out by `param_specs`, the
    batch global, the logits this rank's rows over `batch_axes`; each
    leaf goes through `utils.sharding.compute_view`, so its gradient is
    summed over the ranks that saw other rows."""
    kw = {}
    if mesh is not None:
        params = tree_map(
            lambda p: sharding.compute_view(p, mesh, tuple(batch_axes)),
            params)
        kw = dict(mesh=mesh, model_axis=model_axis, batch_axes=batch_axes)
    return torch.func.functional_call(_skeleton(cfg), _module_names(params),
                                      (batch,), kw)


def retrieval_step(params: dict, cfg: DINConfig, batch: dict,
                   n_candidates: int, k: int = 100, mesh=None,
                   model_axis="model", batch_axes=(), backend: str = "auto"):
    """`DIN.retrieval_step` from a parameter tree (the reference's
    module-level form).  With a mesh (the tables laid out by
    `param_specs`): the shortlist on this rank's rows over `batch_axes`
    (`DIN.shortlist`), re-ranked with the tables' lookups over
    `model_axis`; this rank's rows of (scores, ids)."""
    model = _module(params, cfg)
    if mesh is None:
        return model.retrieval_step(batch, n_candidates, k, backend)
    short = model.shortlist(batch, n_candidates, backend, mesh, model_axis,
                            batch_axes)
    rows = _rows(model._batch(batch), mesh, batch_axes)
    return model.rerank(rows, short, k, mesh, model_axis)


def loss_fn(params: dict, cfg: DINConfig, batch: dict, mesh=None,
            model_axis="model", batch_axes=()) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits against batch["label"]
    (the reference's stable form on f32 logits: max(z, 0) - z y +
    log1p(exp(-|z|))), from a parameter tree in the reference's layout
    (`DIN.param_tree`, or the reference's own tree as tensors) through
    the module's forward; differentiable in the tree's leaves.

    With a mesh: the tree's leaves are laid out by `param_specs`, the
    batch is global, and every rank returns the global mean: its rows'
    sum over the batch, added over `batch_axes`.  Gradients reach each
    leaf's block (summed over `batch_axes`, whose ranks saw other
    rows)."""
    logits = forward_scores(params, cfg, batch, mesh, model_axis,
                            batch_axes).float()
    y = _rows({"y": to_device(batch["label"], logits.device)}, mesh,
              batch_axes)["y"].float()
    bce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * y
           + torch.log1p(torch.exp(-logits.abs())))
    if mesh is None or not batch_axes:
        return torch.mean(bce)
    return sharding.reduce_from(torch.sum(bce) / len(batch["label"]), mesh,
                                tuple(batch_axes))
