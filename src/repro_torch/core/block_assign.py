"""Block assignment (Definition 2): BNF block shuffling [Starling], plus
uniform / random baselines (port of `repro.core.block_assign`: numpy on
the host, the same heap order, so the same blocks).

BNF greedily packs blocks of capacity c: seed an empty block with an
unassigned node, then repeatedly pull in the unassigned node with the most
edges into the current block (its block-neighbor frequency), tie-broken by
graph order. Near-linear via a lazy max-heap keyed on frequency counts.
"""
from __future__ import annotations

import heapq

import numpy as np


def uniform_blocks(n: int, c: int) -> np.ndarray:
    """Nodes 0..n-1 in graph order, c per block."""
    return (np.arange(n) // c).astype(np.int32)


def random_blocks(n: int, c: int, seed: int = 0) -> np.ndarray:
    perm = np.random.default_rng(seed).permutation(n)
    out = np.empty(n, np.int32)
    out[perm] = (np.arange(n) // c).astype(np.int32)
    return out


def undirected_neighbor_lists(adj: np.ndarray) -> list[list[int]]:
    """Deduplicated undirected view of a padded adjacency (n, R).

    A symmetric edge (u->v and v->u both present) contributes each endpoint
    to the other's list exactly once -- naive per-directed-edge insertion
    would add it twice and inflate block-neighbor frequencies.
    """
    n = adj.shape[0]
    valid = adj >= 0
    src = np.repeat(np.arange(n, dtype=np.int64), adj.shape[1])[valid.ravel()]
    dst = adj.ravel()[valid.ravel()].astype(np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi                       # drop self loops
    edges = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)
    und: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges.tolist():
        und[a].append(b)
        und[b].append(a)
    return und


def bnf_blocks(adj: np.ndarray, c: int, seed: int = 0) -> np.ndarray:
    """Starling-style BNF block shuffling on a padded adjacency (n, R)."""
    n = adj.shape[0]
    und = undirected_neighbor_lists(adj)
    blocks = -np.ones(n, np.int32)
    freq = np.zeros(n, np.int64)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    oi = 0
    bid = 0
    while True:
        # seed next block with the first unassigned node in random order
        while oi < n and blocks[order[oi]] >= 0:
            oi += 1
        if oi >= n:
            break
        seed_node = int(order[oi])
        members = [seed_node]
        blocks[seed_node] = bid
        heap: list[tuple[int, int]] = []  # (-freq, node), lazy
        def bump(node: int) -> None:
            for w in und[node]:
                if blocks[w] < 0:
                    freq[w] += 1
                    heapq.heappush(heap, (-int(freq[w]), w))
        bump(seed_node)
        while len(members) < c and heap:
            nf, w = heapq.heappop(heap)
            if blocks[w] >= 0 or -nf != freq[w]:
                continue  # stale entry
            blocks[w] = bid
            members.append(w)
            freq[w] = 0
            bump(w)
        # block underfull with no connected candidates: fill from order
        while len(members) < c:
            while oi < n and blocks[order[oi]] >= 0:
                oi += 1
            if oi >= n:
                break
            w = int(order[oi])
            blocks[w] = bid
            members.append(w)
            freq[w] = 0
            bump(w)
        bid += 1
    return blocks


def block_members(blocks: np.ndarray, c: int) -> np.ndarray:
    """(m, c) int32 member table padded with -1, rows = block ids."""
    m = int(blocks.max()) + 1
    out = -np.ones((m, c), np.int32)
    fill = np.zeros(m, np.int64)
    for v, b in enumerate(blocks.tolist()):
        out[b, fill[b]] = v
        fill[b] += 1
    return out


def intra_edge_fraction(adj: np.ndarray, blocks: np.ndarray) -> float:
    valid = adj >= 0
    n, r = adj.shape
    src = np.repeat(np.arange(n), r)[valid.ravel()]
    dst = adj.ravel()[valid.ravel()]
    if len(src) == 0:
        return 0.0
    return float((blocks[src] == blocks[dst]).mean())
