"""Edge-occlusion rules: RNG, MRNG, and the paper's BMRNG rules (§2.2,
§3.1) (port of `repro.core.rng_rules`).

These are the *reference* (exact, O(n^2..n^3)) implementations used as
oracles by tests and by the exact BMRNG builder on small point sets. The
scalable path is core/bamg.py.

All geometry uses squared L2 (monotone with L2; lune membership
unchanged).  The distance matrix is `core.distances.pairwise_sq_l2` on
`device` (None: the CUDA device), copied to the host once; the edge loops
are numpy, line for line the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, to_device, to_numpy
from .distances import pairwise_sq_l2


def sq_dist_matrix(x, device=None) -> np.ndarray:
    """(n, d) points -> the (n, n) squared-L2 matrix as a numpy array,
    computed on `device` (None: the CUDA device)."""
    xt = to_device(x, resolve_device(device), torch.float32)
    return to_numpy(pairwise_sq_l2(xt, xt))


def in_lune(d: np.ndarray, u: int, q: int, v: int) -> bool:
    """v in lune_{u,q}  <=>  d(u,v) < d(u,q) and d(q,v) < d(u,q)."""
    duq = d[u, q]
    return bool(d[u, v] < duq and d[q, v] < duq)


def rng_edges(x: np.ndarray, device=None) -> np.ndarray:
    """Classic RNG (undirected, as symmetric bool adjacency). O(n^3)."""
    d = sq_dist_matrix(x, device)
    n = len(x)
    adj = np.zeros((n, n), bool)
    for u in range(n):
        for q in range(u + 1, n):
            duq = d[u, q]
            occ = np.any((d[u] < duq) & (d[q] < duq))
            if not occ:
                adj[u, q] = adj[q, u] = True
    return adj


def mrng_edges(x: np.ndarray, d: np.ndarray | None = None,
               device=None) -> np.ndarray:
    """MRNG [Fu et al. 2019] as directed bool adjacency. O(n^2 log n) style.

    For each node u, consider other nodes in ascending distance; keep edge
    (u,q) unless some *already kept* neighbor v of u lies in lune_{u,q}
    (i.e. d(u,v) < d(u,q) -- guaranteed by the ordering -- and
    d(v,q) < d(u,q)). This is the standard constructive MRNG definition and
    yields a monotonic graph (Theorem 3 of [15]).  `d` is a precomputed
    distance matrix; without it the matrix is computed on `device`.
    """
    if d is None:
        d = sq_dist_matrix(x, device)
    n = len(x)
    adj = np.zeros((n, n), bool)
    order = np.argsort(d, axis=1)
    for u in range(n):
        kept: list[int] = []
        for q in order[u]:
            q = int(q)
            if q == u:
                continue
            duq = d[u, q]
            occluded = False
            for v in kept:
                if d[u, v] < duq and d[v, q] < duq:
                    occluded = True
                    break
            if not occluded:
                adj[u, q] = True
                kept.append(q)
    return adj


def is_monotonic_path(d: np.ndarray, path: list[int], q: int) -> bool:
    """Distances to q strictly decrease along `path` (which ends at q)."""
    for a, b in zip(path, path[1:]):
        if not d[b, q] < d[a, q]:
            return False
    return True


def has_monotonic_path(adj: np.ndarray, d: np.ndarray, u: int, q: int) -> bool:
    """Greedy existence check: from u, repeatedly move to any out-neighbor
    strictly closer to q. In a monotonic graph this always reaches q.

    We use best-first over strictly-closer neighbors (not just greedy best)
    so the check is exact for the *existence* of a monotone path.
    """
    n = adj.shape[0]
    if u == q:
        return True
    # BFS over the DAG of strictly-decreasing-distance moves.
    seen = np.zeros(n, bool)
    stack = [u]
    seen[u] = True
    while stack:
        v = stack.pop()
        if adj[v, q] and d[q, q] < d[v, q]:
            return True
        for w in np.nonzero(adj[v])[0]:
            w = int(w)
            if not seen[w] and d[w, q] < d[v, q]:
                seen[w] = True
                stack.append(w)
    return False
