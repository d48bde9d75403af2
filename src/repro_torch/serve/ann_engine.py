"""Fixed-shape batched BAMG search engine (port of
`repro.serve.ann_engine`).

The whole query batch moves through each step together:

- **ADC tables** `(B, M, K)` for the batch (`core.pq.adc_tables`), and
  query-sensitive entry seeds: the entry candidates' codes are scored with
  the `pq_adc` kernel and each row keeps its best `n_entry`.
- **Candidate pool**: sorted `(B, L)` ids, dists and expanded flags, seeded
  through `build.pool.pool_merge`.
- **Beam hops**: `max_hops` iterations of frontier pick, adjacency and
  code gathers, ADC score and pool merge -- one CUDA kernel for the whole
  loop under `"fused"` (`kernels.beam_fused`), or a Python loop whose
  scoring is the `pq_adc_rowwise` kernel under `"cuda"`.
- **Exact re-rank** of each row's pool prefix with tombstones masked
  (`kernels.l2_topk.l2_topk_rowwise`).

The JAX package's TPU backends (`pallas`, `interpret`, `fused_*`) have no
meaning here: the port has one Hopper kernel per function and no VMEM.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import reject_tpu_backend, resolve_device, to_device
from ..build.pool import pool_merge
from ..core.pq import adc_tables
from ..kernels.beam_fused import beam_hops
from ..kernels.l2_topk import l2_topk_rowwise
from ..kernels.pq_adc import pq_adc, pq_adc_rowwise

BACKENDS = ("auto", "fused", "cuda", "ref", "fused_ref")


def resolve_backend(backend: str, device) -> str:
    """Resolve `EngineConfig.backend` for an engine on `device`: "auto"
    is "fused" on a CUDA device and "ref" on the CPU.  The kernel backends
    ("fused", "cuda") raise on the CPU, and the TPU names raise with their
    Hopper counterpart."""
    reject_tpu_backend(backend, BACKENDS)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "fused" if on_cuda else "ref"
    if backend in ("fused", "cuda") and not on_cuda:
        raise ValueError(f"backend {backend!r} launches CUDA kernels; the "
                         f"engine is on {device}")
    return backend


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    l: int = 64               # candidate pool capacity per query
    max_hops: int = 32        # fixed beam-expansion iterations
    n_entry: int = 4          # entry seeds per query
    rerank: Optional[int] = None   # pool prefix reranked exactly (None = l)
    n_entry_cands: int = 256  # entry candidate pool scored by pq_adc
    # kernel backend, reaching entry scoring AND the hop loop:
    #   "auto"       "fused" on a CUDA device, "ref" on the CPU
    #   "fused"      the fused hop-loop kernel; the pq_adc kernel for entries
    #   "cuda"       the Python hop loop with the pq_adc_rowwise kernel per
    #                hop; the pq_adc kernel for entries
    #   "ref"        the Python hop loop, plain versions throughout
    #   "fused_ref"  `beam_hops_ref`, the fused semantics in plain torch
    backend: str = "auto"


def batched_search(x, adj, codes, codebooks, entry_cands, entry_codes,
                   queries, tomb, k: int, l: int, max_hops: int,
                   n_entry: int, rerank: int, backend: str):
    """One fixed-shape search step for a whole query batch.

    x (N, D) f32; adj (N, R) int32 with -1 pad; codes (N, M) uint8;
    codebooks (M, K, dsub) f32; entry_cands (E,) int64 vids with their
    codes (E, M); queries (B, D); tomb (N,) bool tombstone mask
    (tombstoned vids stay navigable but are masked at the exact re-rank).
    Returns (ids (B, k) int64 with -1 pad, dists (B, k) f32 ascending,
    hops_used (B,) int32).
    """
    b = queries.shape[0]
    dev = x.device
    queries = queries.float()
    backend = resolve_backend(backend, dev)
    stage = "cuda" if backend in ("fused", "cuda") else "ref"
    tables = adc_tables(queries, codebooks)                # (B, M, K)

    # --- query-sensitive entry selection (lower index first on ties)
    ed = pq_adc(tables, entry_codes, backend=stage)        # (B, E)
    seed_d, seed_idx = torch.sort(ed, dim=1, stable=True)
    seed_ids = entry_cands[seed_idx[:, :n_entry]].to(torch.int32)
    pool_ids, pool_d, pool_exp = pool_merge(
        torch.full((b, l), -1, dtype=torch.int32, device=dev),
        torch.full((b, l), torch.inf, dtype=torch.float32, device=dev),
        torch.zeros((b, l), dtype=torch.bool, device=dev),
        seed_ids, seed_d[:, :n_entry], l)

    if backend in ("fused", "fused_ref"):
        pool_ids, pool_d, pool_exp, hops, *_ = beam_hops(
            adj, pool_ids, pool_d, pool_exp, max_hops, tables=tables,
            codes=codes, backend=stage)
    else:
        rows = torch.arange(b, device=dev)
        hops = torch.zeros(b, dtype=torch.int32, device=dev)
        for _ in range(max_hops):
            frontier_d = torch.where(pool_exp | (pool_ids < 0), torch.inf,
                                     pool_d)
            j = torch.argmin(frontier_d, 1)
            has = torch.isfinite(frontier_d[rows, j])
            v = torch.where(has, pool_ids[rows, j], 0)
            pool_exp[rows, j] |= has
            nbrs = torch.where(has[:, None], adj[v.long()], -1)   # (B, R)
            nd = pq_adc_rowwise(tables, codes[nbrs.clamp_min(0).long()],
                                backend=stage)
            nd = torch.where(nbrs >= 0, nd, torch.inf)
            pool_ids, pool_d, pool_exp = pool_merge(
                pool_ids, pool_d, pool_exp, nbrs, nd, l)
            hops += has.to(torch.int32)

    # --- exact re-rank of each row's pool prefix, tombstones masked
    cand = pool_ids[:, :rerank]                            # (B, C)
    cc = cand.clamp_min(0).long()
    valid = (cand >= 0) & ~tomb[cc]
    dists, ridx = l2_topk_rowwise(queries, x[cc], k, valid=valid)
    ids = torch.gather(cand, 1, ridx).long()
    ids = torch.where(torch.isfinite(dists), ids, -1)
    return ids, dists, hops


class BatchedANNEngine:
    """Batched fixed-shape searcher over one BAMG sub-index.

    Constructed from an index (`from_index`) or from the array dict of
    `BAMGIndex.batch_arrays()` (or `core.engine.load_batch_arrays`), numpy
    arrays or tensors.  The arrays live on `device` (None means the CUDA
    device): PQ codes stay uint8, adjacency int32 with -1 pads, vectors
    and codebooks float32.
    `search_batch` accepts numpy or tensors and returns numpy.
    """

    # arrays moved between devices by place()/replicate()
    _ARRAY_ATTRS = ("x", "adj", "codes", "codebooks", "entry_cands",
                    "entry_codes", "tomb")

    def __init__(self, arrays: dict, config: Optional[EngineConfig] = None,
                 device=None):
        self.config = config = config if config is not None else EngineConfig()
        self.device = dev = resolve_device(device)
        self.n, self.d = arrays["x"].shape
        # numpy arrays are copied (they may be read-only)
        self.x = to_device(arrays["x"], dev, torch.float32)
        self.adj = to_device(arrays["adj"], dev, torch.int32)
        self.codes = to_device(arrays["codes"], dev, torch.uint8)
        self.codebooks = to_device(arrays["codebooks"], dev, torch.float32)
        self.entry_cands = to_device(arrays["entry_cands"], dev, torch.int64)
        self.entry_codes = self.codes[self.entry_cands].contiguous()
        self.tomb = torch.zeros(self.n, dtype=torch.bool, device=dev)
        l = min(config.l, self.n)
        self._l = l
        self._rerank = min(config.rerank if config.rerank is not None else l, l)
        self._n_entry = min(config.n_entry, len(self.entry_cands))
        self._fault: Optional[Exception] = None

    @classmethod
    def from_index(cls, idx, config: Optional[EngineConfig] = None
                   ) -> "BatchedANNEngine":
        """Serve a `core.engine.BAMGIndex` as it stands: its
        `batch_arrays(config.n_entry_cands)` on the index's own device,
        where its codebooks live."""
        config = config if config is not None else EngineConfig()
        return cls(idx.batch_arrays(n_entry_cands=config.n_entry_cands),
                   config, device=idx.device)

    @property
    def rerank_capacity(self) -> int:
        """Largest k this engine can serve (pool prefix reranked exactly)."""
        return self._rerank

    def effective_rerank(self, l: Optional[int] = None) -> int:
        """Rerank capacity under an optional per-call pool override `l`."""
        if l is None:
            return self._rerank
        return min(self._rerank, max(1, min(int(l), self.n)))

    def place(self, device) -> "BatchedANNEngine":
        """Move this engine's arrays onto `device`, in place (identity is
        kept, so fault hooks keep pointing at the served engine)."""
        self.device = dev = resolve_device(device)
        for a in self._ARRAY_ATTRS:
            setattr(self, a, getattr(self, a).to(dev))
        return self

    def replicate(self, device) -> "BatchedANNEngine":
        """A copy of this engine with its arrays on `device`; fault state
        is not shared with the original.  On the original's own device
        `.to` copies nothing, so the copy shares its arrays (serving
        replicas on one card cost no memory)."""
        new = copy.copy(self)
        new._fault = None
        return new.place(device)

    @property
    def healthy(self) -> bool:
        return self._fault is None

    def inject_fault(self, exc: Optional[Exception] = None) -> None:
        """Fault hook: every later `search_batch` raises (dead shard) until
        `heal()`."""
        self._fault = exc if exc is not None else RuntimeError(
            "injected engine fault")

    def heal(self) -> None:
        self._fault = None

    def _mask(self, vids) -> torch.Tensor:
        mask = np.zeros(self.n, bool)
        ids = np.asarray(vids, np.int64).ravel()
        ids = ids[(ids >= 0) & (ids < self.n)]
        mask[ids] = True
        return torch.as_tensor(mask, device=self.device)

    def set_tombstones(self, vids) -> None:
        """Replace the engine's tombstone mask (streaming freshness).
        `vids` is an iterable of vids to mask; out-of-range ids are
        ignored.  Deletes take effect on the next call."""
        self.tomb = self._mask(list(vids))

    def search_batch(self, queries, k: int, *, l: Optional[int] = None,
                     max_hops: Optional[int] = None, exclude=None):
        """queries (B, D) -> (ids (B, k) int64 with -1 pad, dists (B, k)).

        `l` / `max_hops` optionally shrink the pool / hop budget for this
        call.  `exclude` masks more vids for this call only (on top of
        the tombstones): an iterable of vids or an (N,) bool mask.
        """
        if self._fault is not None:
            raise self._fault
        if not torch.is_tensor(queries):
            queries = torch.from_numpy(np.array(queries, np.float32))
        q = queries.to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None]
        if q.shape[1] != self.d:
            raise ValueError(f"query dim {q.shape[1]} != corpus dim {self.d}")
        l_eff = self._l if l is None else max(1, min(int(l), self.n))
        rerank = self.effective_rerank(l)
        hops = (self.config.max_hops if max_hops is None
                else max(1, int(max_hops)))
        if k > rerank:
            raise ValueError(
                f"k={k} exceeds the rerank capacity {rerank}; raise "
                f"EngineConfig.l/rerank (fixed at engine construction) or "
                f"the per-call l override")
        tomb = self.tomb
        if exclude is not None:
            if not isinstance(exclude, np.ndarray):
                exclude = sorted(exclude)       # sets/frozensets/iterables
            extra = np.asarray(exclude)
            if extra.dtype == bool:
                tomb = tomb | torch.as_tensor(extra, device=self.device)
            else:
                tomb = tomb | self._mask(extra)
        ids, dists, _ = batched_search(
            self.x, self.adj, self.codes, self.codebooks, self.entry_cands,
            self.entry_codes, q, tomb, k=k, l=l_eff, max_hops=hops,
            n_entry=self._n_entry, rerank=rerank, backend=self.config.backend)
        return ids.cpu().numpy(), dists.cpu().numpy()

    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.x, self.adj, self.codes, self.codebooks))
