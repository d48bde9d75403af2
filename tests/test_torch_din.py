"""The port's DIN serving path against the JAX reference (CPU).

The reference's parameters cross over with `params_from_jax`, so both
compute the same function; the products and pooled sums run in other
orders (XLA's on one side, PyTorch's on the other), so float outputs agree
within rtol = 1e-5 / atol = 1e-6.  `din_batch` is drawn with numpy on both
sides and is bitwise equal.  The retrieval cascade is compared on an
integer-valued item table with power-of-two history lengths: there every
shortlist distance is exact, so the shortlists are equal id for id, ties
included, and the re-rank's scores agree within rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din_cfg as jax_din_cfg
from repro.configs.base import RECSYS_SHAPES as JAX_RECSYS_SHAPES
from repro.data.synthetic import din_batch as jax_din_batch
from repro.kernels.l2_topk import l2_topk as jax_l2_topk
from repro.models.recsys import din as jdin
from repro.models.recsys.embedding import embedding_bag as jax_embedding_bag
from repro.models.recsys.embedding import sharded_lookup as jax_lookup
from repro_torch.configs import din_cfg
from repro_torch.configs.base import RECSYS_SHAPES, pad_to_multiple
from repro_torch.data.synthetic import din_batch
from repro_torch.models.recsys.din import (BATCH_KEYS, DIN, DINConfig,
                                           init_params, params_from_jax)
from repro_torch.models.recsys.embedding import embedding_bag, sharded_lookup

JCFG = jdin.DINConfig(n_items=3000, n_cates=32, seq_len=16, embed_dim=8,
                      attn_mlp=(16, 8), mlp=(32, 16), rerank_k=32)
CFG = DINConfig(**dataclasses.asdict(JCFG))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax_params():
    return jdin.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), CFG,
                           device="cpu")


def _batch(step=0, b=16):
    arrays = din_batch(step, b, CFG.seq_len, CFG.n_items, CFG.n_cates)
    return dict(zip(BATCH_KEYS, arrays[:5]))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("step,b,seq_len,n_items,n_cates,seed", [
    (0, 32, 16, 3000, 32, 0), (3, 7, 100, 1_048_576, 1024, 5),
    (1, 1, 1, 10, 3, 2)])
def test_din_batch_is_bitwise_equal(step, b, seq_len, n_items, n_cates, seed):
    got = din_batch(step, b, seq_len, n_items, n_cates, seed=seed)
    want = jax_din_batch(step, b, seq_len, n_items, n_cates, seed=seed)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ("sum", "mean"))
def test_embedding_bag_matches_reference(seed, mode):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(-1, 50, 40).astype(np.int32)
    segs = rng.integers(0, 8, 40).astype(np.int32)
    w = rng.random(40).astype(np.float32) if seed % 2 else None
    got = embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                        torch.as_tensor(segs), 8, mode=mode,
                        weights=None if w is None else torch.as_tensor(w))
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(segs), 8, mode=mode,
                             weights=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sharded_lookup_clips_as_reference():
    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    ids = np.array([[-4, 0, 9], [10, 3, 55]], np.int32)
    got = sharded_lookup(torch.as_tensor(table), torch.as_tensor(ids))
    want = jax_lookup(jnp.asarray(table), jnp.asarray(ids), None, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_target_attention_matches_reference(model, jax_params):
    rng = np.random.default_rng(0)
    e_hist = rng.normal(size=(3, CFG.seq_len, CFG.d_feat)).astype(np.float32)
    e_tgt = rng.normal(size=(3, CFG.d_feat)).astype(np.float32)
    hist_len = np.array([CFG.seq_len, 4, 1], np.int32)
    got = model.target_attention(torch.as_tensor(e_hist),
                                 torch.as_tensor(e_tgt),
                                 torch.as_tensor(hist_len))
    want = jdin.target_attention(jax_params, jnp.asarray(e_hist),
                                 jnp.asarray(e_tgt), jnp.asarray(hist_len))
    _close(got, want)
    # positions past hist_len do not count
    e_hist[1, 10:] = 99.0
    again = model.target_attention(torch.as_tensor(e_hist),
                                   torch.as_tensor(e_tgt),
                                   torch.as_tensor(hist_len))
    assert torch.equal(again[1], got[1])


@pytest.mark.parametrize("step,b", [(0, 16), (1, 33), (2, 1)])
def test_forward_scores_matches_reference(model, jax_params, step, b):
    batch = _batch(step, b)
    got = model.forward_scores(batch)
    assert got.shape == (b,) and got.dtype == torch.float32
    want = jdin.forward_scores(jax_params, JCFG,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    _close(got, want)
    assert torch.equal(model(batch), got)          # forward is deterministic


def test_user_interest_vector_matches_reference(model, jax_params):
    batch = _batch(4, 9)
    got = model.user_interest_vector(batch)
    want = jdin.user_interest_vector(
        jax_params, JCFG, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (9, CFG.d_feat)
    _close(got, want)


def test_retrieval_step_matches_reference(jax_params):
    """Integer item rows and power-of-two history lengths: the query mean
    and every shortlist distance are exact on both sides."""
    rng = np.random.default_rng(3)
    tree = jax.tree.map(np.asarray, jax_params)
    tree["item_emb"] = rng.integers(-3, 4, tree["item_emb"].shape).astype(
        np.float32)
    model = params_from_jax(tree, CFG, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    batch = _batch(5, 8)
    batch["hist_len"] = rng.choice([1, 2, 4, 8, 16], 8).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    n_cand, k = 1024, 7

    short = model.shortlist(batch, n_cand)
    assert short.shape == (8, CFG.rerank_k) and short.dtype == torch.int64
    e = jnp.asarray(tree["item_emb"])[jbatch["hist_items"]]
    hmask = jnp.arange(CFG.seq_len)[None, :] < jbatch["hist_len"][:, None]
    q = (jnp.sum(jnp.where(hmask[..., None], e, 0.0), 1)
         / jnp.maximum(jbatch["hist_len"], 1)[:, None].astype(e.dtype))
    _, want_short = jax_l2_topk(q, jnp.asarray(tree["item_emb"][:n_cand]),
                                CFG.rerank_k, backend="ref")
    np.testing.assert_array_equal(short.numpy(), np.asarray(want_short))

    s, ids = model.retrieval_step(batch, n_cand, k=k)
    ws, wids = jdin.retrieval_step(jparams, JCFG, jbatch, n_cand, k=k)
    assert s.shape == ids.shape == (8, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=ATOL)
    assert (np.diff(s.numpy(), axis=1) <= 0).all()
    assert ((ids >= 0) & (ids < n_cand)).all()
    # the scores are the forward scores of (user, returned item)
    rows = {key: np.repeat(v, k, axis=0) for key, v in batch.items()}
    rows["target_item"] = ids.numpy().reshape(-1).astype(np.int32)
    rows["target_cate"] = rows["target_item"] % CFG.n_cates
    torch.testing.assert_close(model.forward_scores(rows).reshape(8, k), s,
                               rtol=0, atol=0)


def test_rerank_breaks_ties_by_candidate_position(jax_params):
    """Equal scores keep the lower shortlist position first, as
    `jax.lax.top_k` does: items 3 and 3 + n_cates share an embedding row
    and a category, so they score the same for every user."""
    tree = jax.tree.map(np.asarray, jax_params)
    twin = 3 + CFG.n_cates
    tree["item_emb"] = tree["item_emb"].copy()
    tree["item_emb"][twin] = tree["item_emb"][3]
    model = params_from_jax(tree, CFG, device="cpu")
    batch = _batch(6, 2)
    items = torch.tensor([[twin, 3, twin, 3], [3, twin, 3, twin]])
    s, ids = model.rerank(batch, items, 4)
    assert (s == s[:, :1]).all()
    assert torch.equal(ids, items)
    with pytest.raises(ValueError, match="exceeds"):
        model.rerank(batch, items, 5)


def test_init_params_shapes_and_scale():
    cfg = din_cfg.model_config(reduced=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = init_params(cfg, gen, device="cpu")
    assert model.item_emb.shape == (cfg.n_items, cfg.embed_dim)
    assert model.cate_emb.shape == (cfg.n_cates, cfg.embed_dim)
    assert abs(float(model.item_emb.std()) - 0.05) < 0.003
    attn, mlp = cfg.layer_sizes()
    for ws, bs, sizes in ((model.attn_w, model.attn_b, attn),
                          (model.mlp_w, model.mlp_b, mlp)):
        assert [tuple(w.shape) for w in ws] == list(zip(sizes[:-1], sizes[1:]))
        for w, b, d_in in zip(ws, bs, sizes):
            assert abs(float(w.std()) * d_in ** 0.5 - 1) < 0.35
            assert not b.any()
    assert not any(p.requires_grad for p in model.parameters())
    scores = model.forward_scores(dict(zip(BATCH_KEYS, din_batch(
        0, 5, cfg.seq_len, cfg.n_items, cfg.n_cates)[:5])))
    assert scores.shape == (5,) and torch.isfinite(scores).all()
    again = torch.Generator()
    again.manual_seed(0)
    assert torch.equal(init_params(cfg, again, device="cpu").item_emb,
                       model.item_emb)


def test_din_checks_table_and_weight_shapes(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    with pytest.raises(ValueError, match="item_emb"):
        params_from_jax(tree, dataclasses.replace(CFG, n_items=10),
                        device="cpu")
    with pytest.raises(ValueError, match="attn weights"):
        params_from_jax(tree, dataclasses.replace(CFG, attn_mlp=(16, 9)),
                        device="cpu")
    assert isinstance(params_from_jax(tree, CFG, device="cpu"), DIN)


def test_configs_match_reference():
    for reduced in (False, True):
        assert (dataclasses.asdict(din_cfg.model_config(reduced))
                == dataclasses.asdict(jax_din_cfg.model_config(reduced)))
    assert RECSYS_SHAPES == {k: type(RECSYS_SHAPES[k])(
        **dataclasses.asdict(v)) for k, v in JAX_RECSYS_SHAPES.items()}
    assert pad_to_multiple(1000, 128) == 1024
