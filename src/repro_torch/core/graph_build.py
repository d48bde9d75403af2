"""Scalable proximity-graph builders: Vamana (DiskANN) and NSG (port of
`repro.core.graph_build`).

Host-side (numpy) construction, with the bulk distance work (the kNN
graph, the medoid, the nearest reached node of `connect_to_entry`) done by
the port's `core.distances` on `device` (None means the CUDA device).
Graphs are padded int32 adjacency (n, R), -1 padded.  These are the inputs
to the block-aware stage (core/bamg.py) and the baselines for benchmarks.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from .._device import resolve_device, to_device, to_numpy
from .distances import knn_graph, medoid, pairwise_sq_l2


def _on(x, device) -> torch.Tensor:
    return to_device(x, resolve_device(device), torch.float32)


def _dists_to(x: np.ndarray, ids: np.ndarray, q: np.ndarray) -> np.ndarray:
    v = x[ids] - q[None, :]
    return np.einsum("nd,nd->n", v, v)


def greedy_search(
    x: np.ndarray,
    adj: np.ndarray,
    entry: int,
    q: np.ndarray,
    ef: int,
    max_steps: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Beam search on a padded graph. Returns (visited_ids, visited_dists)
    in visit order -- the candidate pool used by Vamana/NSG construction.
    """
    dq = float(_dists_to(x, np.array([entry]), q)[0])
    # heap of (dist, id) candidates; visited dict id->dist
    cand: list[tuple[float, int]] = [(dq, entry)]
    visited: dict[int, float] = {}
    results: list[tuple[float, int]] = []  # max-heap via negation
    seen = {entry}
    steps = 0
    while cand:
        d, v = heapq.heappop(cand)
        if len(results) >= ef and d > -results[0][0]:
            break
        visited[v] = d
        heapq.heappush(results, (-d, v))
        if len(results) > ef:
            heapq.heappop(results)
        steps += 1
        if max_steps is not None and steps >= max_steps:
            break
        nbrs = adj[v]
        nbrs = nbrs[nbrs >= 0]
        new = [u for u in nbrs.tolist() if u not in seen]
        if not new:
            continue
        seen.update(new)
        nd = _dists_to(x, np.asarray(new), q)
        bound = -results[0][0] if len(results) >= ef else np.inf
        for u, du in zip(new, nd.tolist()):
            if du < bound or len(results) < ef:
                heapq.heappush(cand, (du, u))
    ids = np.fromiter(visited.keys(), np.int64, len(visited))
    ds = np.fromiter(visited.values(), np.float64, len(visited))
    o = np.argsort(ds, kind="stable")
    return ids[o], ds[o]


def robust_prune(
    x: np.ndarray,
    p: int,
    cand_ids: np.ndarray,
    cand_d: np.ndarray,
    r: int,
    alpha: float = 1.0,
) -> np.ndarray:
    """Vamana RobustPrune / NSG MRNG-style edge selection (alpha=1 -> MRNG).

    Keep v (ascending distance from p) unless an already kept u satisfies
    alpha * d(u, v) <= d(p, v).
    """
    o = np.argsort(cand_d, kind="stable")
    cand_ids = cand_ids[o]
    cand_d = cand_d[o]
    kept: list[int] = []
    kept_vecs: list[np.ndarray] = []
    for v, dv in zip(cand_ids.tolist(), cand_d.tolist()):
        if v == p:
            continue
        ok = True
        xv = x[v]
        for xu in kept_vecs:
            duv = float(np.dot(xu - xv, xu - xv))
            if alpha * duv <= dv:
                ok = False
                break
        if ok:
            kept.append(v)
            kept_vecs.append(xv)
            if len(kept) >= r:
                break
    return np.asarray(kept, np.int32)


def _pad_adj(neighbors: list[np.ndarray], r: int) -> np.ndarray:
    n = len(neighbors)
    adj = -np.ones((n, r), np.int32)
    for i, row in enumerate(neighbors):
        row = row[:r]
        adj[i, : len(row)] = row
    return adj


def build_vamana(
    x: np.ndarray,
    r: int = 32,
    l_build: int = 64,
    alpha: float = 1.2,
    seed: int = 0,
    passes: int = 2,
    device=None,
) -> tuple[np.ndarray, int]:
    """DiskANN's Vamana graph. Returns (padded adjacency (n,R), medoid)."""
    n = len(x)
    rng = np.random.default_rng(seed)
    # random regular-ish init
    neighbors = [rng.choice(n, size=min(r, n - 1), replace=False) for _ in range(n)]
    neighbors = [row[row != i][: r] for i, row in enumerate(neighbors)]
    adj = _pad_adj([np.asarray(v, np.int32) for v in neighbors], r)
    med = medoid(_on(x, device))
    alphas = [1.0] * (passes - 1) + [alpha]
    for a in alphas:
        order = rng.permutation(n)
        for p in order.tolist():
            vis_ids, vis_d = greedy_search(x, adj, med, x[p], ef=l_build)
            # candidate set: visited U current neighbors
            cur = adj[p]
            cur = cur[cur >= 0]
            cand = np.unique(np.concatenate([vis_ids.astype(np.int64), cur.astype(np.int64)]))
            cand = cand[cand != p]
            cd = _dists_to(x, cand, x[p])
            kept = robust_prune(x, p, cand, cd, r, alpha=a)
            adj[p] = -1
            adj[p, : len(kept)] = kept
            # add reverse edges with pruning on overflow
            dp = _dists_to(x, kept, x[p])
            for v, dvp in zip(kept.tolist(), dp.tolist()):
                row = adj[v]
                if p in row[row >= 0]:
                    continue
                slot = np.nonzero(row < 0)[0]
                if len(slot):
                    adj[v, slot[0]] = p
                else:
                    cc = np.concatenate([row[row >= 0].astype(np.int64), [p]])
                    cd2 = _dists_to(x, cc, x[v])
                    kept2 = robust_prune(x, v, cc, cd2, r, alpha=a)
                    adj[v] = -1
                    adj[v, : len(kept2)] = kept2
    return adj, med


def build_nsg(
    x: np.ndarray,
    r: int = 32,
    l_build: int = 64,
    knn_k: int = 32,
    seed: int = 0,
    device=None,
) -> tuple[np.ndarray, int]:
    """NSG [Fu et al. 2019]: approximate MRNG from a kNN graph.

    1) exact kNN graph; 2) for each node, search from the medoid ("navigating
    node") over the kNN graph to collect candidates; 3) MRNG-style prune
    (alpha=1); 4) DFS-tree pass to guarantee connectivity from the medoid.
    """
    n = len(x)
    xt = _on(x, device)
    knn = to_numpy(knn_graph(xt, knn_k))
    med = medoid(xt)
    neighbors: list[np.ndarray] = []
    for p in range(n):
        vis_ids, vis_d = greedy_search(x, knn, med, x[p], ef=l_build)
        cand = np.unique(np.concatenate([vis_ids.astype(np.int64), knn[p].astype(np.int64)]))
        cand = cand[(cand != p) & (cand >= 0)]   # drop -1 kNN padding
        cd = _dists_to(x, cand, x[p])
        kept = robust_prune(x, p, cand, cd, r, alpha=1.0)
        neighbors.append(kept)
    adj = _pad_adj(neighbors, r)
    connect_to_entry(x, adj, med, device=xt.device)
    return adj, med


def connect_to_entry(x: np.ndarray, adj: np.ndarray, entry: int,
                     device=None) -> None:
    """In-place NSG "tree spanning" step: BFS from `entry`; attach every
    unreachable node to its nearest reachable neighbor (force-linking into
    the last slot when the row is full -- connectivity beats pruning)."""
    n, r = adj.shape
    reached = np.zeros(n, bool)
    stack = [entry]
    reached[entry] = True
    while stack:
        v = stack.pop()
        for u in adj[v]:
            if u >= 0 and not reached[u]:
                reached[u] = True
                stack.append(int(u))
    missing = np.nonzero(~reached)[0]
    if len(missing):
        ridx = np.nonzero(reached)[0]
        xt = _on(x, device)
        dev = xt.device
        d = pairwise_sq_l2(xt[torch.as_tensor(missing, device=dev)],
                           xt[torch.as_tensor(ridx, device=dev)])
        near = ridx[to_numpy(torch.argmin(d, 1))]
        for m, v in zip(missing.tolist(), near.tolist()):
            row = adj[v]
            slot = np.nonzero(row < 0)[0]
            if len(slot):
                adj[v, slot[0]] = m
            else:
                adj[v, r - 1] = m
            reached[m] = True


def degree_stats(adj: np.ndarray, blocks: np.ndarray | None = None) -> dict:
    """Average out-degree; if blocks given, split intra / cross (Table 2)."""
    valid = adj >= 0
    total = valid.sum(1).mean()
    out = {"total": float(total)}
    if blocks is not None:
        n, r = adj.shape
        src = np.repeat(np.arange(n), r)[valid.ravel()]
        dst = adj.ravel()[valid.ravel()]
        same = blocks[src] == blocks[dst]
        out["intra"] = float(same.sum() / n)
        out["cross"] = float((~same).sum() / n)
    return out
