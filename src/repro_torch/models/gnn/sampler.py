"""Host-side fanout neighbor sampler (GraphSAGE-style) for minibatch_lg
(port of `repro.models.gnn.sampler`: numpy, line for line the
reference's, so a sample is bitwise the reference's).

Given a CSR adjacency, sample `fanouts` (e.g. [15, 10]) neighbors per layer
for a seed batch, returning a *fixed-shape padded* subgraph ready for the
fixed-shape train step:

  nodes:  (max_nodes,) global ids, -1 pad
  edges:  (max_edges,) src/dst in *local* subgraph indices, -1 pad
  seeds:  local indices of the batch nodes (first `batch` entries)

Deterministic per (seed, step).  Memory per sample is
O(batch * prod(fanouts)) -- the full graph never enters device memory.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def csr_from_edges(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> CSRGraph:
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst_s.astype(np.int64))


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                    rng: np.random.Generator):
    """Layered fanout sampling.  Returns (nodes, edge_src, edge_dst) with
    edges in local indices, exact (unpadded) sizes."""
    node_ids: list[int] = list(dict.fromkeys(seeds.tolist()))
    local = {v: i for i, v in enumerate(node_ids)}
    e_src: list[int] = []
    e_dst: list[int] = []
    frontier = list(node_ids)
    for f in fanouts:
        nxt: list[int] = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            sel = rng.choice(deg, size=take, replace=False) if deg > f \
                else np.arange(deg)
            for u in g.indices[lo:hi][sel].tolist():
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                    nxt.append(u)
                # message flows neighbor -> seed direction
                e_src.append(local[u])
                e_dst.append(local[v])
        frontier = nxt
    return (np.asarray(node_ids, np.int64),
            np.asarray(e_src, np.int32), np.asarray(e_dst, np.int32))


def padded_sample(g: CSRGraph, feats: np.ndarray, labels: np.ndarray,
                  batch_nodes: int, fanouts: list[int], step: int,
                  max_nodes: int, max_edges: int, seed: int = 0):
    """Deterministic fixed-shape minibatch for global step `step`."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    seeds = rng.choice(g.n_nodes, size=batch_nodes, replace=False)
    nodes, es, ed = sample_subgraph(g, seeds, fanouts, rng)
    nodes, es, ed = nodes[:max_nodes], es[:max_edges], ed[:max_edges]
    keep = (es < len(nodes)) & (ed < len(nodes))
    es, ed = es[keep], ed[keep]
    nf = np.zeros((max_nodes, feats.shape[1]), np.float32)
    nf[: len(nodes)] = feats[nodes]
    lab = np.zeros((max_nodes,), np.int32)
    lab[: len(nodes)] = labels[nodes]
    pe = -np.ones((max_edges,), np.int32)
    pad_src = pe.copy(); pad_src[: len(es)] = es
    pad_dst = pe.copy(); pad_dst[: len(ed)] = ed
    seed_mask = np.zeros((max_nodes,), bool)
    seed_mask[: batch_nodes] = True
    return {"node_feat": nf, "edge_src": pad_src, "edge_dst": pad_dst,
            "labels": lab, "seed_mask": seed_mask}


def expected_sizes(batch_nodes: int, fanouts: list[int]) -> tuple[int, int]:
    """(max_nodes, max_edges) bounds for padding."""
    nodes = batch_nodes
    edges = 0
    frontier = batch_nodes
    for f in fanouts:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return nodes, edges
