"""Deterministic synthetic data: the vector corpora, the LM token streams,
the graphs and the DIN event streams of `repro.data.synthetic`.

Everything is drawn with numpy exactly as the reference draws it, so for
a given seed the arrays are bit-identical to `repro`'s; the exact ground
truth of a vector corpus is computed with the port's `exact_knn` on
`device`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.distances import exact_knn


@dataclasses.dataclass
class VectorDataset:
    name: str
    base: np.ndarray      # (n, d) float32
    queries: np.ndarray   # (nq, d) float32
    gt: np.ndarray        # (nq, k_gt) int64 exact nearest neighbors


def clustered_vectors(n: int, d: int, n_clusters: int = 64,
                      spread: float = 4.0, seed: int = 0) -> np.ndarray:
    """Clustered Gaussian corpus -- the standard ANN difficulty regime."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * spread
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign]
            + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)


def make_vector_dataset(name: str, n: int, d: int, nq: int, k_gt: int = 100,
                        n_clusters: int = 64, seed: int = 0,
                        device=None) -> VectorDataset:
    """Corpus + held-out queries from the same mixture + exact ground
    truth (computed on `device`; None means the CUDA device)."""
    dev = resolve_device(device)
    base = clustered_vectors(n + nq, d, n_clusters=n_clusters, seed=seed)
    x, q = base[:n], base[n:]
    _, gt = exact_knn(torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev),
                      min(k_gt, n))
    return VectorDataset(name=name, base=x, queries=q,
                         gt=gt.cpu().numpy().astype(np.int64))


# Paper-analogue regimes: the dimension mirrors the real dataset.
PAPER_REGIMES = {
    "sift-like": dict(d=128, n_clusters=64),    # SIFT1M
    "gist-like": dict(d=960, n_clusters=32),    # GIST: 4 KB block ~ 1 vector
    "deep-like": dict(d=256, n_clusters=64),    # DEEP1M
    "glove-like": dict(d=100, n_clusters=64),   # GLOVE
    "msong-like": dict(d=420, n_clusters=32),   # MSONG
    "crawl-like": dict(d=300, n_clusters=48),   # CRAWL
}


def paper_dataset(regime: str, n: int = 8000, nq: int = 50, seed: int = 0,
                  device=None) -> VectorDataset:
    cfg = PAPER_REGIMES[regime]
    return make_vector_dataset(regime, n, cfg["d"], nq,
                               n_clusters=cfg["n_clusters"], seed=seed,
                               device=device)


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------
def lm_batch(step: int, batch: int, seq_len: int, vocab: int, seed: int = 0):
    """Deterministic (tokens, labels) for one step, int32 numpy arrays:
    Zipf-ish unigram stream."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Zipf-like marginal over the vocab (heavy head, long tail)
    u = rng.random((batch, seq_len + 1))
    toks = np.minimum((vocab * (u ** 3)), vocab - 1).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GraphBatch:
    node_feat: np.ndarray   # (n_nodes, d_feat) float32
    edge_src: np.ndarray    # (n_edges,) int32
    edge_dst: np.ndarray    # (n_edges,) int32
    edge_feat: np.ndarray   # (n_edges, d_edge) float32
    labels: np.ndarray      # (n_nodes,) int32 or (n_nodes, d_out) float32
    pos: np.ndarray | None = None   # (n_nodes, 3) for geometric GNNs


def random_graph(n_nodes: int, n_edges: int, d_feat: int, d_edge: int = 8,
                 n_classes: int = 16, seed: int = 0,
                 geometric: bool = False) -> GraphBatch:
    """Degree-skewed random graph; geometric=True adds 3D positions and
    builds edges by proximity (radius-graph style, molecule regime).
    numpy arrays, drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    if geometric:
        pos = (rng.normal(size=(n_nodes, 3)).astype(np.float32)
               * (n_nodes ** (1 / 3)))
        # kNN edges in 3D
        k = max(1, min(n_nodes - 1, n_edges // n_nodes))
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nbr = np.argsort(d2, axis=1)[:, :k]
        src = np.repeat(np.arange(n_nodes), k).astype(np.int32)
        dst = nbr.reshape(-1).astype(np.int32)
        src, dst = src[:n_edges], dst[:n_edges]
        if len(src) < n_edges:  # pad by repeating
            reps = -(-n_edges // len(src))
            src = np.tile(src, reps)[:n_edges]
            dst = np.tile(dst, reps)[:n_edges]
    else:
        pos = None
        # preferential-attachment-ish skew
        w = 1.0 / (1.0 + np.arange(n_nodes))
        w /= w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
        dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    node_feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    edge_feat = rng.normal(size=(n_edges, d_edge)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return GraphBatch(node_feat=node_feat, edge_src=src, edge_dst=dst,
                      edge_feat=edge_feat, labels=labels, pos=pos)


def molecules_batch(batch: int, n_nodes: int, n_edges: int, seed: int = 0):
    """Batched small molecules as one disjoint-union graph: (GraphBatch,
    graph ids (batch * n_nodes,) int32)."""
    gs = [random_graph(n_nodes, n_edges, d_feat=16, seed=seed * 1000 + i,
                       geometric=True) for i in range(batch)]
    off = np.arange(batch) * n_nodes
    return GraphBatch(
        node_feat=np.concatenate([g.node_feat for g in gs]),
        edge_src=np.concatenate([g.edge_src + o for g, o in zip(gs, off)]
                                ).astype(np.int32),
        edge_dst=np.concatenate([g.edge_dst + o for g, o in zip(gs, off)]
                                ).astype(np.int32),
        edge_feat=np.concatenate([g.edge_feat for g in gs]),
        labels=np.concatenate([g.labels for g in gs]),
        pos=np.concatenate([g.pos for g in gs]),
    ), np.repeat(np.arange(batch), n_nodes).astype(np.int32)


# ---------------------------------------------------------------------------
# RecSys event streams (DIN)
# ---------------------------------------------------------------------------
def din_batch(step: int, batch: int, seq_len: int, n_items: int, n_cates: int,
              seed: int = 0):
    """(hist_items, hist_cates, hist_len, target_item, target_cate, label)
    as numpy arrays, a pure function of (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    u = rng.random((batch, seq_len))
    hist_items = np.minimum(n_items * (u ** 2), n_items - 1).astype(np.int32)
    hist_cates = (hist_items % n_cates).astype(np.int32)
    hist_len = rng.integers(1, seq_len + 1, batch).astype(np.int32)
    target_item = np.minimum(n_items * (rng.random(batch) ** 2),
                             n_items - 1).astype(np.int32)
    target_cate = (target_item % n_cates).astype(np.int32)
    # label correlates with whether target's category appears in history
    mask = np.arange(seq_len)[None, :] < hist_len[:, None]
    seen = ((hist_cates == target_cate[:, None]) & mask).any(1)
    noise = rng.random(batch) < 0.15
    label = (seen ^ noise).astype(np.float32)
    return hist_items, hist_cates, hist_len, target_item, target_cate, label
