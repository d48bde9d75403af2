"""Exact BMRNG construction (§3) -- the O(n^2 log n) reference oracle (port
of `repro.core.bmrng`; the distance matrix on `device`, the rules numpy on
the host, line for line the reference's).

Used on small point sets to (a) validate Theorem 1 (existence of monotonic
I/O paths) by property tests and (b) serve as the gold standard that the
scalable BAMG (core/bamg.py) approximates.

Rule 1: within each block, the induced subgraph is an MRNG.
Rule 2: a cross-block edge (u,q) is occluded iff some kept neighbor v of u
  - Case 1 (same block as u): lies in lune_{u,q};
  - Case 2 (other block): admits a monotone (toward q) intra-block path in
    v's block ending at a node inside lune_{u,q} (l >= 1, so v itself counts).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .rng_rules import mrng_edges, sq_dist_matrix


@dataclasses.dataclass
class BMRNG:
    adj: np.ndarray          # (n, n) bool, directed
    blocks: np.ndarray       # (n,) int32 block assignment L(v)
    dist: np.ndarray         # (n, n) cached squared distances


def _lune_reachable_in_block(
    adj: np.ndarray, d: np.ndarray, blocks: np.ndarray, v: int, u: int, q: int
) -> bool:
    """Case 2 test (exact): is there a monotone-toward-q path inside block
    B_{L(v)} starting at v whose endpoint lies in lune_{u,q}?

    We BFS over intra-block edges restricted to strictly-decreasing distance
    to q; if any visited node (including v) is in the lune, return True.
    """
    duq = d[u, q]
    blk = blocks[v]
    if d[u, v] < duq and d[v, q] < duq:
        return True  # path of length l=1: [v]
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    seen[v] = True
    stack = [v]
    while stack:
        a = stack.pop()
        for b in np.nonzero(adj[a])[0]:
            b = int(b)
            if seen[b] or blocks[b] != blk:
                continue
            if d[b, q] >= d[a, q]:  # must be strictly monotone toward q
                continue
            if d[u, b] < duq and d[b, q] < duq:
                return True
            seen[b] = True
            stack.append(b)
    return False


def build_bmrng(x: np.ndarray, blocks: np.ndarray, device=None) -> BMRNG:
    """Exact BMRNG per §3.1/§3.2. x: (n,d) float32, blocks: (n,) int.
    The squared distances are computed on `device` (None: the CUDA
    device) and kept as the numpy `BMRNG.dist`."""
    n = len(x)
    d = sq_dist_matrix(x, device)
    blocks = np.asarray(blocks, np.int32)
    adj = np.zeros((n, n), bool)

    # --- Rule 1: per-block induced MRNG -----------------------------------
    for b in np.unique(blocks):
        members = np.nonzero(blocks == b)[0]
        if len(members) <= 1:
            continue
        sub = mrng_edges(x[members], d[np.ix_(members, members)])
        for i, gi in enumerate(members):
            for j, gj in enumerate(members):
                if sub[i, j]:
                    adj[gi, gj] = True

    # --- Rule 2: cross-block edges, candidates in ascending distance ------
    order = np.argsort(d, axis=1)
    for u in range(n):
        for q in order[u]:
            q = int(q)
            if q == u or blocks[q] == blocks[u]:
                continue
            duq = d[u, q]
            occluded = False
            for v in np.nonzero(adj[u])[0]:
                v = int(v)
                if blocks[v] == blocks[u]:
                    # Case 1: v in lune_{u,q}
                    if d[u, v] < duq and d[v, q] < duq:
                        occluded = True
                        break
                else:
                    # Case 2: monotone intra-block path in B_{L(v)} ending in lune
                    if _lune_reachable_in_block(adj, d, blocks, v, u, q):
                        occluded = True
                        break
            if not occluded:
                adj[u, q] = True
    return BMRNG(adj=adj, blocks=blocks, dist=d)


# --- Definition 3 checkers --------------------------------------------------
def monotonic_io_path(
    adj: np.ndarray, d: np.ndarray, blocks: np.ndarray, u: int, q: int
) -> list[int] | None:
    """Find a monotonic I/O path u -> q per Definition 3, or None.

    Definition 3 constrains (a) consecutive nodes inside one block segment
    to strictly decrease distance to q and (b) the *end* nodes of
    consecutive block segments to strictly decrease -- the edge that enters
    a new block MAY increase distance (the paper's Theorem-1 proof relies
    on this: the occluding path starts at an arbitrary neighbor v and only
    its endpoint y must be in the lune).

    Search state: (current node, distance bound of the previous segment's
    end node).  Intra-block moves need delta(b,q) < delta(a,q); crossing
    blocks is allowed only when delta(a,q) < bound (a closes its segment),
    resetting the intra-segment constraint at the entry node.
    """
    if u == q:
        return [u]
    n = adj.shape[0]
    dq = d[:, q]
    # state: (node, bound_id) where bound_id indexes the node whose distance
    # bounds this segment's required end (n == +inf for the first segment)
    bounds = np.concatenate([dq, [np.inf]])
    seen = set()
    start = (u, n)
    parent: dict = {start: None}
    stack = [start]
    seen.add(start)
    goal = None
    while stack:
        state = stack.pop()
        a, bid = state
        if a == q:
            goal = state
            break
        for b in np.nonzero(adj[a])[0]:
            b = int(b)
            if blocks[b] == blocks[a]:
                if dq[b] >= dq[a]:
                    continue  # intra-segment steps strictly decrease
                nxt = (b, bid)
            else:
                if dq[a] >= bounds[bid]:
                    continue  # a cannot close the current segment
                nxt = (b, a)
            if nxt not in seen:
                seen.add(nxt)
                parent[nxt] = state
                stack.append(nxt)
    if goal is None:
        return None
    path = []
    s = goal
    while s is not None:
        path.append(s[0])
        s = parent[s]
    return path[::-1]


def io_length(path: list[int], blocks: np.ndarray) -> int:
    """Number of blocks along the path (counting revisits as new I/Os)."""
    ios = 1
    for a, b in zip(path, path[1:]):
        if blocks[a] != blocks[b]:
            ios += 1
    return ios
