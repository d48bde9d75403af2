"""Background consolidation: fold the delta overlay into a fresh BAMG build
(port of `repro.index.delta.consolidate`).

Deletes make this more than a rebuild-with-appends: dropping a node
severs every monotonic path that ran through it.  Following FreshDiskANN,
each live node that lost a neighbor repairs its row with
neighbor-of-neighbor RobustPrune -- candidates are its surviving
neighbors plus the surviving neighbors of its dead neighbors, pruned by
the standard occlusion rule -- so two-hop connectivity through a deleted
point collapses into a direct edge when no surviving edge dominates it.

Block assignment is then *re-run from scratch* on the repaired merged
graph (BNF + block-aware Alg-2 refine): per the page-alignment argument
in PAPERS.md, a block layout co-locates the topology it was computed on,
and the merged topology is new -- splicing edges into the old layout
would quietly degrade the very block-hit rates BAMG exists to exploit.

The output id space is compacted (live ids -> `0..m-1`, base-then-delta
ascending); `old2new` maps overlay ids to the new rows (-1 = deleted),
which `FreshService` uses to keep external ids stable across the swap.

Where the card comes in: the edge repair and the id compaction are the
host's, line for line the reference's; then the medoid, the reconnect's
distances, the Alg-2 refine's probes (`GraphBuilder(..., device)`) and
the new index's PQ and nav graph (`BAMGIndex.from_graph(..., device)`)
run on `device` (None: the CUDA device), as the port's builders do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..._device import resolve_device, to_device
from ...build import BuildConfig, GraphBuilder
from ...build.prune import robust_prune_inc
from ...core.block_assign import bnf_blocks
from ...core.distances import medoid
from ...core.engine import BAMGIndex, BAMGParams
from ...core.graph_build import connect_to_entry
from ...core.storage import max_capacity_for

from .layer import DeltaLayer


def _pad_rows(rows: list[np.ndarray], r: int) -> np.ndarray:
    out = np.full((len(rows), r), -1, np.int32)
    for i, row in enumerate(rows):
        m = min(len(row), r)
        out[i, :m] = row[:m]
    return out


def consolidate(base_index, delta: DeltaLayer,
                params: Optional[BAMGParams] = None, device=None,
                ) -> tuple[BAMGIndex, np.ndarray]:
    """Fold `delta` into a fresh BAMG index built on `device` (None: the
    CUDA device).

    Returns `(index, old2new)`: the consolidated `BAMGIndex` over the
    live corpus, and an `(n_total,)` int64 map from overlay ids to new
    rows (-1 for tombstoned ids).  The caller publishes the index
    through `DeploymentManager` and swaps via `BlueGreenEngine.refresh`.
    """
    index, old2new, _ = consolidate_timed(base_index, delta, params, device)
    return index, old2new


def consolidate_timed(base_index, delta: DeltaLayer,
                      params: Optional[BAMGParams] = None, device=None,
                      ) -> tuple[BAMGIndex, np.ndarray, dict[str, float]]:
    """`consolidate`, plus each stage's wall seconds ("repair", "compact",
    "connect", "bnf", "refine", "index"); every stage ends on the host,
    so the times include the device's work."""
    dev = resolve_device(device)
    stages: dict[str, float] = {}
    t = time.perf_counter()

    def lap(stage: str) -> None:
        nonlocal t
        now = time.perf_counter()
        stages[stage] = now - t
        t = now

    p = dataclasses.replace(params if params is not None
                            else base_index.params)
    n_total = delta.n_total
    dead = delta.tombstones
    live = np.asarray([v for v in range(n_total) if v not in dead], np.int64)
    if len(live) < 3:
        raise ValueError(f"consolidate: {len(live)} live points; a graph "
                         f"index needs >= 3")
    x_all = delta.vectors(np.arange(n_total))
    prune_alpha = delta.params.prune_alpha

    # --- 1. materialize the overlay + repair edges around deleted nodes
    rows: dict[int, np.ndarray] = {}
    for u in live.tolist():
        nn = delta.neighbors(u)
        dead_nbrs = [v for v in nn.tolist() if v in dead]
        if not dead_nbrs:
            rows[u] = nn
            continue
        cand = {v for v in nn.tolist() if v not in dead}
        for v in dead_nbrs:           # neighbor-of-neighbor candidates
            cand.update(w for w in delta.neighbors(v).tolist()
                        if w not in dead and w != u)
        cand_ids = np.asarray(sorted(cand), np.int64)
        rows[u] = robust_prune_inc(x_all[u], cand_ids, x_all[cand_ids],
                                   r=p.r, alpha=prune_alpha)
    lap("repair")

    # --- 2. compact the id space (base-then-delta ascending)
    old2new = np.full(n_total, -1, np.int64)
    old2new[live] = np.arange(len(live))
    x_new = np.ascontiguousarray(x_all[live])
    new_rows = []
    for u in live.tolist():
        m = old2new[rows[u]]
        new_rows.append(m[m >= 0])
    width = max(p.r, max((len(r_) for r_ in new_rows), default=1), 1)
    adj = _pad_rows(new_rows, width)
    lap("compact")

    # --- 3. reconnect + re-run block assignment and Alg-2 refine
    entry = medoid(to_device(x_new, dev, torch.float32))
    connect_to_entry(x_new, adj, entry, device=dev)
    lap("connect")
    capacity = p.capacity or max_capacity_for(p.r)
    blocks = bnf_blocks(adj, capacity, seed=p.seed)
    lap("bnf")
    builder = GraphBuilder(BuildConfig(backend=p.build_backend,
                                       batch_size=p.build_batch,
                                       knn_mode=p.build_knn), device=dev)
    graph = builder.refine_bamg(x_new, adj, entry, blocks, capacity,
                                alpha=p.alpha, beta=p.beta,
                                sibling_edges=p.sibling_edges,
                                max_degree=p.r)
    lap("refine")
    index = BAMGIndex.from_graph(x_new, graph, p, device=dev)
    lap("index")
    return index, old2new, stages
