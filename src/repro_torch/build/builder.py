"""`GraphBuilder`: the construction facade (port of
`repro.build.builder`).

Selects between two backends for the three expensive build stages:

- ``backend="batched"`` (the default): whole node batches run the
  candidate beam (`build.frontier`), the RobustPrune scan (`build.prune`)
  and the Algorithm-2 intra-block probes (`build.bamg_refine`) as tensor
  programs on the builder's device (None: the CUDA device).  Under
  ``frontier_backend="fused"`` (the default) the beam is the exact-L2 hop
  kernel;
- ``backend="host"``, only when asked for: the per-node numpy/heapq
  builders in `core.graph_build` / `core.bamg` -- the reference oracle,
  with only the products on the device.

Batched semantics vs host: NSG and the BAMG refinement are node-order
independent, so the batched NSG differs from the host's only through the
frontier's fixed-hop termination (the refinement follows the host's scan
given the same base graph).  Batched Vamana applies each batch's edge
updates after searching the whole batch on one graph snapshot
(DiskANN-style batch insertion), where the host updates after every node.

`GraphBuilder.timings` holds the wall seconds of each stage of the last
build (every stage ends in a copy to the host, so the times include the
device's work), and `GraphBuilder.knn` the kNN graph that the last batched
NSG build started from.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .._device import reject_tpu_backend, resolve_device, to_device, to_numpy
from ..core import graph_build as host
from ..core.bamg import BAMGGraph, build_bamg_from
from ..core.block_assign import bnf_blocks
from ..core.distances import knn_graph, medoid
from ..kernels.beam_fused.ref import sq_norms
from .bamg_refine import walk_probe
from .chunking import map_chunks
from .frontier import BACKENDS as FRONTIER_BACKENDS
from .frontier import frontier_arrays, frontier_pools
from .knn import clustered_knn_graph
from .prune import robust_prune_batch

BACKENDS = ("host", "batched")


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    backend: str = "batched"     # "batched" | "host" (reference oracle)
    batch_size: int = 256        # nodes per frontier/prune step
    pair_chunk: int = 4096       # (v, q) probe pairs per BAMG refine chunk
    beam_width: int = 8          # frontier expansions per hop
    max_hops: int | None = None  # frontier hops (default: ~ef/beam_width)
    knn_mode: str = "clustered"  # batched NSG kNN stage: "clustered"|"exact"
    # candidate-beam implementation for the batched backend: "fused"
    # (the exact-L2 hop kernel at width 1 on a CUDA device, its plain
    # version on the CPU; beam_width is then ignored), "fused_ref" (the
    # plain version) or "batched" (the seen-mask beam); the JAX package's
    # TPU names raise with their counterpart
    frontier_backend: str = "fused"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        reject_tpu_backend(self.frontier_backend, FRONTIER_BACKENDS)
        if self.frontier_backend not in FRONTIER_BACKENDS:
            raise ValueError(
                f"frontier_backend must be one of {FRONTIER_BACKENDS}, "
                f"got {self.frontier_backend!r}")
        if self.knn_mode not in ("clustered", "exact"):
            raise ValueError(f"knn_mode must be 'clustered' or 'exact', "
                             f"got {self.knn_mode!r}")


class GraphBuilder:
    """Facade over the host and batched construction pipelines, on
    `device` (None: the CUDA device)."""

    def __init__(self, config: BuildConfig = BuildConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.timings: dict[str, float] = {}
        self.knn: np.ndarray | None = None

    def _timed(self, stage: str, t0: float) -> float:
        """Record the stage that started at `t0`; returns the time now."""
        now = time.perf_counter()
        self.timings[stage] = now - t0
        return now

    # -- helpers ------------------------------------------------------------
    def _prune(self, x, p_ids, cand_ids, r: int, alpha: float) -> np.ndarray:
        """Chunked batched RobustPrune; `x` may be a tensor already on the
        device.  Independent chunks are pipelined two-deep."""
        b = self.config.batch_size
        p_ids = np.asarray(p_ids, np.int64)
        cand_ids = np.asarray(cand_ids, np.int32)
        out = np.empty((len(p_ids), r), np.int32)

        def run(s):
            out[s:s + b] = robust_prune_batch(
                x, p_ids[s:s + b], cand_ids[s:s + b], None, r=r, alpha=alpha,
                device=self.device)

        map_chunks(list(range(0, len(p_ids), b)), run)
        return out

    # -- Vamana (DiskANN) ----------------------------------------------------
    def build_vamana(self, x: np.ndarray, r: int = 32, l_build: int = 64,
                     alpha: float = 1.2, seed: int = 0,
                     passes: int = 2) -> tuple[np.ndarray, int]:
        if self.config.backend == "host":
            return host.build_vamana(x, r=r, l_build=l_build, alpha=alpha,
                                     seed=seed, passes=passes,
                                     device=self.device)
        n = len(x)
        rng = np.random.default_rng(seed)
        neighbors = [rng.choice(n, size=min(r, n - 1), replace=False)
                     for _ in range(n)]
        neighbors = [row[row != i][:r] for i, row in enumerate(neighbors)]
        adj = host._pad_adj([np.asarray(v, np.int32) for v in neighbors], r)
        xt = to_device(x, self.device, torch.float32)
        n2 = sq_norms(xt)
        med = medoid(xt)
        bs = self.config.batch_size
        alphas = [1.0] * (passes - 1) + [alpha]
        for a in alphas:
            order = rng.permutation(n)
            for s in range(0, n, bs):
                nodes = order[s : s + bs]
                pool_ids, _ = frontier_pools(
                    x, adj, [med], nodes, ef=l_build,
                    max_hops=self.config.max_hops, batch=bs,
                    width=self.config.beam_width,
                    device_arrays=(xt, n2,
                                   to_device(adj, self.device, torch.int32)),
                    backend=self.config.frontier_backend)
                cand = np.concatenate([pool_ids, adj[nodes]], axis=1)
                kept = self._prune(xt, nodes, cand, r=r, alpha=a)
                for bi, p in enumerate(nodes.tolist()):
                    row = kept[bi]
                    row = row[row >= 0]
                    adj[p] = -1
                    adj[p, : len(row)] = row
                # reverse edges; rows that overflow collect for a batched
                # re-prune instead of the host's per-insert prune
                pending: dict[int, list[int]] = {}
                for bi, p in enumerate(nodes.tolist()):
                    for v in kept[bi][kept[bi] >= 0].tolist():
                        row = adj[v]
                        if p in row[row >= 0] or p in pending.get(v, ()):
                            continue
                        slot = np.nonzero(row < 0)[0]
                        if len(slot):
                            adj[v, slot[0]] = p
                        else:
                            pending.setdefault(v, []).append(p)
                if pending:
                    vs = np.asarray(sorted(pending), np.int64)
                    need = max(len(v) for v in pending.values())
                    cand2 = -np.ones((len(vs), r + need), np.int32)
                    for i, v in enumerate(vs.tolist()):
                        merged = adj[v][adj[v] >= 0].tolist() + pending[v]
                        cand2[i, : len(merged)] = merged
                    kept2 = self._prune(xt, vs, cand2, r=r, alpha=a)
                    for i, v in enumerate(vs.tolist()):
                        row = kept2[i]
                        row = row[row >= 0]
                        adj[v] = -1
                        adj[v, : len(row)] = row
        return adj, med

    # -- NSG -----------------------------------------------------------------
    def build_nsg(self, x: np.ndarray, r: int = 32, l_build: int = 64,
                  knn_k: int = 32, seed: int = 0) -> tuple[np.ndarray, int]:
        self.timings = {}
        self.knn = None
        if self.config.backend == "host":
            return host.build_nsg(x, r=r, l_build=l_build, knn_k=knn_k,
                                  seed=seed, device=self.device)
        n = len(x)
        t = time.perf_counter()
        if self.config.knn_mode == "clustered":
            knn = clustered_knn_graph(x, knn_k, seed=seed, device=self.device)
        else:
            knn = to_numpy(knn_graph(to_device(x, self.device, torch.float32),
                                     knn_k))
        t = self._timed("knn", t)
        self.knn = knn
        arrays = frontier_arrays(x, knn, self.device)
        med = medoid(arrays[0])
        pool_ids, _ = frontier_pools(
            x, knn, [med], np.arange(n), ef=l_build,
            max_hops=self.config.max_hops, batch=self.config.batch_size,
            width=self.config.beam_width, device_arrays=arrays,
            backend=self.config.frontier_backend)
        t = self._timed("frontier", t)
        cand = np.concatenate([pool_ids, knn], axis=1)
        kept = self._prune(arrays[0], np.arange(n), cand, r=r, alpha=1.0)
        t = self._timed("prune", t)
        adj = host._pad_adj([row[row >= 0] for row in kept], r)
        host.connect_to_entry(x, adj, med, device=self.device)
        self._timed("connect", t)
        return adj, med

    # -- BAMG ----------------------------------------------------------------
    def refine_bamg(self, x: np.ndarray, nsg_adj: np.ndarray, entry: int,
                    blocks: np.ndarray, capacity: int, alpha: int = 3,
                    beta: float = 1.0, occlusion_ref: str = "rule",
                    sibling_edges: bool = True,
                    max_degree: int | None = None) -> BAMGGraph:
        """Algorithm 2 given a prebuilt base graph + block assignment.

        The batched backend follows the host's scan given the same inputs
        (only the intra-block probes move to the device)."""
        t = time.perf_counter()
        probe = None
        if self.config.backend == "batched":
            probe = walk_probe(x, nsg_adj, blocks, alpha,
                               self.config.pair_chunk, self.device)
            t = self._timed("refine_pairs", t)
        g = build_bamg_from(x, nsg_adj, entry, blocks, capacity, alpha=alpha,
                            beta=beta, occlusion_ref=occlusion_ref,
                            sibling_edges=sibling_edges,
                            max_degree=max_degree, probe=probe)
        self._timed("refine_scan", t)
        return g

    def build_bamg(self, x: np.ndarray, capacity: int, alpha: int = 3,
                   beta: float = 1.0, r: int = 32, l_build: int = 64,
                   knn_k: int = 32, seed: int = 0,
                   occlusion_ref: str = "rule", sibling_edges: bool = True,
                   max_degree: int | None = None) -> BAMGGraph:
        """build_BAMG(X, alpha, beta) -- Algorithm 2 end to end."""
        nsg_adj, entry = self.build_nsg(x, r=r, l_build=l_build,
                                        knn_k=knn_k, seed=seed)
        t = time.perf_counter()
        blocks = bnf_blocks(nsg_adj, capacity, seed=seed)
        self._timed("bnf", t)
        return self.refine_bamg(x, nsg_adj, entry, blocks, capacity,
                                alpha=alpha, beta=beta,
                                occlusion_ref=occlusion_ref,
                                sibling_edges=sibling_edges,
                                max_degree=max_degree)
