"""Deterministic synthetic vector corpora: the vector part of
`repro.data.synthetic`.

Base vectors and queries are drawn with numpy exactly as the reference
draws them, so for a given seed they are bit-identical to `repro`'s; the
exact ground truth is computed with the port's `exact_knn` on `device`.
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
