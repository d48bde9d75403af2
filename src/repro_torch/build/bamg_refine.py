"""Batched BAMG refinement (Algorithm 2) -- block-aware cross-edge pruning
with all intra-block monotone probes evaluated on the device (port of
`repro.build.bamg_refine`).

The host reference (`core.bamg.build_bamg_from`) spends almost all its
time in `_block_search_toward`: for every ordered pair (v, q) of
cross-block candidates of a node it walks <= alpha monotone intra-block
hops from v toward q, one Python loop per hop per neighbour.  Here the
probes are flattened into (v, q) pair arrays and evaluated hop by hop on
the device (padded gathers, argmin steps); the occlusion / sibling-fold
scan then runs `build_bamg_from` itself with a probe that looks up the
precomputed walks, so the refined adjacency follows the reference's scan
by construction.

Work reduction vs the naive all-pairs sweep:

- only *ordered* pairs are probed (v strictly closer to u than q in the
  host's stable scan order -- the only pairs its occlusion loop can
  check);
- walks gather from a prefiltered intra-block adjacency (built once, max
  intra-degree wide) instead of masking the full graph row per hop;
- pairs whose walk stopped improving are compacted away between hops, so
  hop h only pays for walks still alive.

Parity notes:
- the walk reproduces the host's running-minimum semantics exactly: a hop
  moves to the first argmin neighbour iff it strictly improves, and stops
  otherwise;
- the probe returns the walk minimum only for walks that improved
  (+inf otherwise) and the host takes `min(dvq, walk)`, so the
  no-improvement case compares the *host-computed* delta(v, q) against
  the occlusion reference;
- delta(u, q) ordering and the occlusion reference reuse the host's
  `_sqd` values verbatim.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, to_device, to_numpy
from ..core.bamg import BAMGGraph, _sqd, build_bamg_from


def _probe_hop(x, intra_adj, cur, best, q_ids):
    """One monotone intra-block hop for a flat chunk of walks.

    x (N, D) f32; intra_adj (N, R') int32 intra-block neighbours, -1 pad;
    cur (P,) walk positions; best (P,) f32 running minima; q_ids (P,)
    walk targets.  Returns (cur', best', improved (P,) bool) -- the
    host's running-minimum hop: move to the first argmin neighbour iff it
    strictly improves, else stop.
    """
    qv = x[q_ids]                                           # (P, D)
    nbrs = intra_adj[cur]                                   # (P, R')
    diff = x[nbrs.clamp_min(0).long()] - qv[:, None, :]
    dw = (diff * diff).sum(-1)                              # (P, R')
    dw = torch.where(nbrs >= 0, dw, torch.inf)
    amn = torch.argmin(dw, 1)                               # first argmin
    mn = torch.gather(dw, 1, amn[:, None])[:, 0]
    improved = mn < best
    step = torch.gather(nbrs, 1, amn[:, None])[:, 0].long()
    return (torch.where(improved, step, cur), torch.where(improved, mn, best),
            improved)


def intra_adjacency(adj: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """(n, R') adjacency restricted to same-block neighbours, -1 pad, row
    order preserved (the walk's argmin tie-break needs host order)."""
    n, r = adj.shape
    valid = adj >= 0
    same = np.zeros_like(valid)
    same[valid] = blocks[adj[valid]] == np.repeat(blocks, valid.sum(1))
    width = max(1, int(same.sum(1).max()))
    out = -np.ones((n, width), np.int32)
    for u in range(n):
        row = adj[u][same[u]]
        out[u, : len(row)] = row
    return out


class _ProbeEngine:
    """Flat (v, q) pair probes on the device, chunked and compacted
    between hops."""

    def __init__(self, x, intra_adj, alpha: int, pair_chunk: int, device):
        self.x = to_device(x, device, torch.float32)
        self.adj = to_device(intra_adj, device, torch.int32)
        self.alpha = alpha
        self.chunk = pair_chunk

    def _hop(self, cur, best, q_ids):
        """Chunked single hop over flat pair tensors."""
        outs = [_probe_hop(self.x, self.adj, cur[s:s + self.chunk],
                           best[s:s + self.chunk], q_ids[s:s + self.chunk])
                for s in range(0, len(cur), self.chunk)]
        return tuple(torch.cat(o) for o in zip(*outs))

    def __call__(self, v_ids: np.ndarray, q_ids: np.ndarray,
                 d0: np.ndarray) -> np.ndarray:
        """Walk minima for pairs (v, q); d0 = delta(v, q) seeds the running
        minimum.  Returns +inf where no hop improved (the host then falls
        back to its own delta(v, q))."""
        m = len(v_ids)
        dev = self.x.device
        walk = torch.full((m,), torch.inf, device=dev)
        cur = torch.as_tensor(np.asarray(v_ids, np.int64), device=dev)
        best = torch.as_tensor(np.asarray(d0, np.float32), device=dev)
        q_all = torch.as_tensor(np.asarray(q_ids, np.int64), device=dev)
        alive = torch.arange(m, device=dev)
        for _ in range(self.alpha):
            if not len(alive):
                break
            nc, nb, ni = self._hop(cur, best, q_all[alive])
            walk[alive[ni]] = nb[ni]
            alive = alive[ni]
            cur, best = nc[ni], nb[ni]
        return to_numpy(walk)


def walk_probe(x: np.ndarray, nsg_adj: np.ndarray, blocks: np.ndarray,
               alpha: int = 3, pair_chunk: int = 4096, device=None):
    """The `probe` of `build_bamg_from` for a base graph and its blocks:
    the walk minima of every ordered pair, computed at once on `device`
    (None: the CUDA device), then looked up per (u, v, q)."""
    n = len(x)
    blocks = np.asarray(blocks)
    adj_lists = [row[row >= 0].astype(np.int64) for row in nsg_adj]
    cross = [[v for v in adj_lists[u].tolist() if blocks[v] != blocks[u]]
             for u in range(n)]

    # every *ordered* pair (v strictly before q in the host's stable
    # ascending-delta(u, .) scan order -- the only pairs its occlusion
    # loop can check), flattened across all nodes
    pv, pq, pd, owner = [], [], [], []
    for u in range(n):
        cu = cross[u]
        if not cu:
            continue
        dq = np.array([_sqd(x, u, x[v]) for v in cu])
        srt = np.argsort(dq, kind="stable").tolist()
        for i, oi in enumerate(srt):
            for oj in srt[i + 1 :]:
                v, q = cu[oi], cu[oj]
                if v == q:
                    continue
                dvv = x[q] - x[v]
                pv.append(v)
                pq.append(q)
                pd.append(float(np.dot(dvv, dvv)))
                owner.append(u)

    engine = _ProbeEngine(x, intra_adjacency(nsg_adj, blocks), alpha,
                          pair_chunk, resolve_device(device))
    walk = engine(np.asarray(pv, np.int64), np.asarray(pq, np.int64),
                  np.asarray(pd, np.float32))
    tables: dict[int, dict[tuple[int, int], float]] = {}
    for v, q, u, w in zip(pv, pq, owner, walk.tolist()):
        tables.setdefault(u, {})[(v, q)] = w

    def probe(u, v, q, q_vec, dvq):
        # +inf when no hop improved: the comparison then uses the host's
        # own delta(v, q), keeping exact-equality semantics (beta=1/alg2)
        return min(dvq, tables.get(u, {}).get((v, q), np.inf))

    return probe


def refine_bamg_batched(
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
    pair_chunk: int = 4096,
    device=None,
) -> BAMGGraph:
    """Algorithm 2 with batched probes on `device` (None: the CUDA
    device): the scan IS `build_bamg_from`, handed a probe that looks up
    device-computed walk minima instead of walking in Python.
    """
    probe = walk_probe(x, nsg_adj, blocks, alpha, pair_chunk, device)
    return build_bamg_from(x, nsg_adj, entry, blocks, capacity,
                           alpha=alpha, beta=beta,
                           occlusion_ref=occlusion_ref,
                           sibling_edges=sibling_edges,
                           max_degree=max_degree, probe=probe)
