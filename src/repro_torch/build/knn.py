"""Clustered approximate kNN graph for the batched build backend (port of
`repro.build.knn`).

The host NSG pipeline starts from an exact kNN graph -- an O(n^2 d)
all-pairs top-k that dwarfs every other stage as n grows.  The batched
backend replaces it with IVF/EFANNA-style candidate generation: k-means
the corpus into ~sqrt(n) clusters (Lloyd iterations on the device), then
compute each point's exact top-k among the members of its cluster's
`n_probe` nearest clusters only -- one product per cluster, O(n * n_probe
* n/c * d) total.

The result has the contract of `core.distances.knn_graph` (int32 (n, k),
-1 padded, self excluded) and rows that are exact within the probed
candidate set.  NSG consumes kNN rows only as supplemental candidates next
to the frontier pool, so an occasional missed true neighbour is recovered
by the beam.

The random draws are numpy's, as in the reference.  The products run in
IEEE f32 (`f32_matmul`) in the reference's expanded form, and every top-k
is a stable sort, lower index first on ties, as `jax.lax.top_k`.  The
reference pads each cluster's operands to powers of two (and the base
with 1e17 sentinel rows) to bound its jit recompilations; PyTorch runs
each shape eagerly, so the port takes the unpadded shapes, which select
the same neighbours.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, to_device, to_numpy
from ..core.distances import f32_matmul, knn_graph, pairwise_sq_l2


def _sq_dists(q: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(|q|^2 + |b|^2) - 2 q.b, in the reference's order, unclamped."""
    with f32_matmul():
        qb = q @ base.T
    return ((q * q).sum(1, keepdim=True) + (base * base).sum(1)[None, :]
            - 2.0 * qb)


def _topk_chunk(q: torch.Tensor, base: torch.Tensor, k: int):
    """The k nearest base rows of each query row: (dists, idx) ascending,
    lower index first on ties."""
    d, idx = torch.sort(_sq_dists(q, base), dim=1, stable=True)
    return d[:, :k], idx[:, :k]


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return torch.argmin(_sq_dists(x, centers), 1)          # first minimum


def _kmeans(x: np.ndarray, c: int, iters: int, seed: int,
            xt: torch.Tensor) -> np.ndarray:
    """Lloyd's algorithm; returns (n,) int cluster assignment.  `xt` is x
    on the device, where the assignments are computed; the centre updates
    are the reference's float64 numpy sums."""
    n = len(x)
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(n, size=c, replace=False)].astype(np.float32)
    assign = None
    for _ in range(iters):
        assign = to_numpy(_assign(xt, to_device(centers, xt.device)))
        sums = np.zeros((c, x.shape[1]), np.float64)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=c)
        live = counts > 0
        centers[live] = (sums[live] / counts[live, None]).astype(np.float32)
    return assign


def clustered_knn_graph(
    x: np.ndarray,
    k: int,
    n_clusters: int | None = None,
    n_probe: int = 8,
    iters: int = 4,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Approximate kNN graph via per-cluster probed exact top-k, on
    `device` (None: the CUDA device).  Returns numpy int32 (n, k)."""
    n, d = x.shape
    dev = resolve_device(device)
    xt = to_device(x, dev, torch.float32)
    c = n_clusters or max(8, int(np.sqrt(n)))
    c = min(c, n)
    if n <= 2048 or c < n_probe:     # small corpora: exact is already cheap
        return to_numpy(knn_graph(xt, k))
    assign = _kmeans(x, c, iters, seed, xt)
    centers = np.zeros((c, d), np.float64)
    np.add.at(centers, assign, x)
    counts = np.bincount(assign, minlength=c)
    centers[counts > 0] /= counts[counts > 0, None]
    # n_probe nearest clusters per cluster (by center distance, incl. self)
    cd = to_numpy(pairwise_sq_l2(to_device(centers, dev, torch.float32),
                                 to_device(centers, dev, torch.float32)))
    probes = np.argsort(cd, axis=1, kind="stable")[:, :n_probe]

    members = [np.nonzero(assign == ci)[0] for ci in range(c)]
    adj = -np.ones((n, k), np.int32)
    for ci in range(c):
        q_ids = members[ci]
        if not len(q_ids):
            continue
        cand = np.concatenate([members[pj] for pj in probes[ci]])
        kk = min(k + 1, len(cand))
        _, idx = _topk_chunk(xt[torch.as_tensor(q_ids, device=dev)],
                             xt[torch.as_tensor(cand, device=dev)], kk)
        ids = cand[to_numpy(idx)]
        for row_i, p in enumerate(q_ids.tolist()):
            row = ids[row_i]
            row = row[row != p][:k]
            adj[p, : len(row)] = row
    return adj
