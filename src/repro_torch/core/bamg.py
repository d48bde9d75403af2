"""BAMG construction (Algorithm 2): linear-time block-aware refinement of a
monotonic base graph (NSG), per §4.1 (port of `repro.core.bamg`; the scan
is numpy on the host, line for line the reference's).

Steps (paper-faithful):
  1. Build NSG G from X.
  2. Block assignment via BNF block shuffling on G.
  3. Keep ALL intra-block edges of G (mitigates suboptimal assignment).
  4. Treat cross-block edges as candidates; prune with relaxed Rule 2 Case 2:
       prune (u, q) iff for some kept cross-block neighbor v, a monotone
       (toward q) intra-block path of <= alpha hops from v inside B_L(v)
       ends at z with  delta(z, q) * beta < delta(v, q).
  5. Sibling heuristic: if candidate q shares a block with kept neighbor v,
     add intra-block edges (v, q) and (q, v) (Alg. 2 lines 18-20).

`occlusion_ref` selects the pruning reference distance. The paper is
internally inconsistent: Alg. 2 line 16 compares the path endpoint against
delta(v, q) ("alg2"), while the formal Prune() rule in §4.1 -- and the
BMRNG Rule 2 lune condition delta(z,q) < delta(u,q) it relaxes -- compare
against delta(u, q) ("rule").  "alg2" over-prunes badly (measured: total
degree ~5 vs the paper's ~24 on a SIFT-like corpus, destroying recall), so
the faithful default is "rule"; "alg2" is kept for the ablation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .block_assign import bnf_blocks, block_members
from .graph_build import build_nsg


@dataclasses.dataclass
class BAMGGraph:
    adj: np.ndarray          # (n, R') padded int32 adjacency
    blocks: np.ndarray       # (n,) int32 block assignment
    members: np.ndarray      # (m, c) padded block member table
    entry: int               # medoid of the base NSG
    capacity: int            # block capacity c
    alpha: int
    beta: float


def _sqd(x: np.ndarray, a: int, b_vec: np.ndarray) -> float:
    v = x[a] - b_vec
    return float(np.dot(v, v))


def _block_search_toward(
    x: np.ndarray,
    adj_lists: list[np.ndarray],
    blocks: np.ndarray,
    v: int,
    q_vec: np.ndarray,
    alpha: int,
) -> float:
    """Greedy monotone search toward q inside block B_L(v), <= alpha hops.

    Returns the best (smallest) squared distance to q reached -- the
    `delta(C[0], q)` of Algorithm 2 line 15/16. Exactly the paper's
    search_within_block restricted to intra-block neighbors with strictly
    decreasing distance.
    """
    blk = blocks[v]
    cur = v
    dv = q_vec - x[v]
    best = float(np.dot(dv, dv))
    for _ in range(alpha):
        nbrs = adj_lists[cur]
        improved = False
        for w in nbrs.tolist():
            if blocks[w] != blk:
                continue
            dw = q_vec - x[w]
            dwq = float(np.dot(dw, dw))
            if dwq < best:
                best = dwq
                cur = w
                improved = True
        if not improved:
            break
    return best


def build_bamg_from(
    x: np.ndarray,
    nsg_adj: np.ndarray,
    entry: int,
    blocks: np.ndarray,
    capacity: int,
    alpha: int = 3,
    beta: float = 1.0,
    occlusion_ref: str = "rule",
    sibling_edges: bool = True,
    max_degree: int | None = None,
    probe=None,
) -> BAMGGraph:
    """Algorithm 2 given a prebuilt base graph + block assignment.

    `probe(u, v, q, q_vec, dvq) -> float` supplies the intra-block
    monotone-search minimum `delta(C[0], q)` for the occlusion test; the
    default runs the host `_block_search_toward`.  The batched backend
    (`repro.build.bamg_refine`) passes a lookup into device-precomputed
    walks, so both backends share this scan verbatim and cannot diverge.
    """
    n = len(x)
    r = nsg_adj.shape[1]
    adj_lists = [row[row >= 0].astype(np.int64) for row in nsg_adj]
    if probe is None:
        def probe(u, v, q, q_vec, dvq):
            return _block_search_toward(x, adj_lists, blocks, v, q_vec,
                                        alpha)
    new_lists: list[list[int]] = [[] for _ in range(n)]

    # Pass 1: intra-block edges are kept verbatim (Alg. 2 lines 7-8).
    for u in range(n):
        for v in adj_lists[u].tolist():
            if blocks[v] == blocks[u]:
                new_lists[u].append(v)

    # Pass 2: cross-block candidates, ascending distance, Rule 2 Case 2.
    for u in range(n):
        xu = x[u]
        cout = [v for v in adj_lists[u].tolist() if blocks[v] != blocks[u]]
        if not cout:
            continue
        dq = np.array([_sqd(x, u, x[v]) for v in cout])
        order = np.argsort(dq, kind="stable")
        r_out: list[int] = []
        r_out_d: list[float] = []
        for oi in order.tolist():
            q = cout[oi]
            duq = float(dq[oi])
            q_vec = x[q]
            occlude = False
            folded = False
            for v, dvq_u in zip(r_out, r_out_d):
                dvv = q_vec - x[v]
                dvq = float(np.dot(dvv, dvv))  # delta(v, q)
                best = probe(u, v, q, q_vec, dvq)
                ref = dvq if occlusion_ref == "alg2" else duq
                if best * beta < ref:
                    occlude = True
                    break
                if sibling_edges and blocks[v] == blocks[q]:
                    # Alg. 2 lines 18-20: fold q in as intra-block sibling of v
                    if q not in new_lists[v]:
                        new_lists[v].append(q)
                    if v not in new_lists[q]:
                        new_lists[q].append(v)
                    folded = True
                    break
            if occlude or folded:
                continue
            r_out.append(q)
            r_out_d.append(duq)
        new_lists[u].extend(r_out)

    rmax = max((len(l) for l in new_lists), default=1)
    if max_degree is not None:
        rmax = min(rmax, max_degree)
    adj = -np.ones((n, max(rmax, 1)), np.int32)
    for u, l in enumerate(new_lists):
        # intra edges first (they are free at search time), then cross
        intra = [v for v in l if blocks[v] == blocks[u]]
        cross = [v for v in l if blocks[v] != blocks[u]]
        row = (intra + cross)[: adj.shape[1]]
        adj[u, : len(row)] = row
    members = block_members(blocks, capacity)
    return BAMGGraph(
        adj=adj, blocks=np.asarray(blocks, np.int32), members=members,
        entry=entry, capacity=capacity, alpha=alpha, beta=beta,
    )


def build_bamg(
    x: np.ndarray,
    capacity: int,
    alpha: int = 3,
    beta: float = 1.0,
    r: int = 32,
    l_build: int = 64,
    knn_k: int = 32,
    seed: int = 0,
    occlusion_ref: str = "rule",
    sibling_edges: bool = True,
    device=None,
) -> BAMGGraph:
    """build_BAMG(X, alpha, beta) -- Algorithm 2 end to end, over the host
    NSG (its distance products on `device`, None meaning the CUDA device)."""
    nsg_adj, entry = build_nsg(x, r=r, l_build=l_build, knn_k=knn_k, seed=seed,
                               device=device)
    blocks = bnf_blocks(nsg_adj, capacity, seed=seed)
    return build_bamg_from(
        x, nsg_adj, entry, blocks, capacity, alpha=alpha, beta=beta,
        occlusion_ref=occlusion_ref, sibling_edges=sibling_edges,
    )
