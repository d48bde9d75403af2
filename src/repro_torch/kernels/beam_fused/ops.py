"""Dispatch wrapper for the fused beam-hop kernels
(`csrc/beam_hops_adc.cu`, `csrc/beam_hops_l2.cu`).

`beam_hops` runs `max_hops` fused beam hops (frontier pick, adjacency
gather, score, ranked pool merge per hop) over a seeded sorted pool and
returns the final pool plus the per-hop frontier trace, the next pick and
the done mask.  The operands pick the scoring: `tables` and `codes` for
ADC (serving), `x`, `n2` and `queries` for exact L2 (construction).
backend: "cuda" launches the kernel (CUDA tensors only), "ref" runs
`beam_hops_ref`, "auto" launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  Launches are counted in
`beam_hops.launches` (ADC) and `beam_hops.l2_launches` (exact L2).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import beam_hops_ref, sq_norms

MAX_L = 1024    # one thread per pool slot, one block per row
MAX_R = 256


def beam_hops(adj, pool_ids, pool_d, pool_exp, max_hops: int, *,
              tables=None, codes=None, x=None, n2=None, queries=None,
              backend: str = "auto"):
    """Fused beam-hop loop.  adj (N, R) int32 with -1 pad; the seeded
    pool (B, L) triplet (int32 ids, f32 dists, bool expanded) must be
    sorted by (dist, id) with invalid entries (-1, +inf, False).  ADC:
    tables (B, M, K) f32 and codes (N, M) uint8 (every code < K).  Exact
    L2: x (N, D) f32, n2 (N,) f32 squared norms, queries (B, D) f32.

    Returns (pool_ids (B, L) int32, pool_d (B, L) f32, pool_exp (B, L)
    bool, hops (B,) int32, trace_ids (B, max_hops) int32, trace_d
    (B, max_hops) f32, next_id (B,) int32, done (B,) bool).
    """
    adc = codes is not None
    if not _build.use_kernel(backend, pool_ids, "beam_hops"):
        return beam_hops_ref(adj, pool_ids, pool_d, pool_exp, max_hops,
                             tables=tables, codes=codes, x=x, n2=n2,
                             queries=queries)
    dev = pool_ids.device
    b, l = pool_ids.shape
    n, r = adj.shape
    _build.check(adj, "adj", torch.int32, (n, r), dev)
    _build.check(pool_ids, "pool_ids", torch.int32, (b, l), dev)
    _build.check(pool_d, "pool_d", torch.float32, (b, l), dev)
    _build.check(pool_exp, "pool_exp", torch.bool, (b, l), dev)
    if l > MAX_L or r > MAX_R:
        raise ValueError(f"beam_hops kernel takes L <= {MAX_L} and "
                         f"R <= {MAX_R}, got L={l}, R={r}")
    lib = _build.library()
    if adc:
        _, m, k = tables.shape
        _build.check(codes, "codes", torch.uint8, (n, m), dev)
        _build.check(tables, "tables", torch.float32, (b, m, k), dev)
        smem = lib.beam_hops_adc_smem_bytes(l, r, m, k)
        shape = f"L={l}, R={r}, M={m}, K={k}"
    else:
        d = x.shape[1]
        _build.check(x, "x", torch.float32, (n, d), dev)
        _build.check(n2, "n2", torch.float32, (n,), dev)
        _build.check(queries, "queries", torch.float32, (b, d), dev)
        smem = lib.beam_hops_l2_smem_bytes(l, r, d)
        shape = f"L={l}, R={r}, D={d}"
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"beam_hops at {shape} needs {smem} bytes of shared "
                         f"memory; the limit is {_build.MAX_SMEM_BYTES}")
    h = max(int(max_hops), 0)
    i32, f32 = torch.int32, torch.float32
    out = (torch.empty((b, l), dtype=i32, device=dev),
           torch.empty((b, l), dtype=f32, device=dev),
           torch.empty((b, l), dtype=torch.bool, device=dev),
           torch.empty(b, dtype=i32, device=dev),
           torch.empty((b, h), dtype=i32, device=dev),
           torch.empty((b, h), dtype=f32, device=dev),
           torch.empty(b, dtype=i32, device=dev),
           torch.empty(b, dtype=torch.bool, device=dev))
    if not b:
        return out
    pool = (pool_ids.data_ptr(), pool_d.data_ptr(), pool_exp.data_ptr())
    outs = tuple(o.data_ptr() for o in out)
    if adc:
        _build.launch("beam_hops", "beam_hops_adc_launch", dev,
                      adj.data_ptr(), codes.data_ptr(), tables.data_ptr(),
                      *pool, *outs, b, l, r, m, k, h)
        _build.count(beam_hops)
    else:
        qn = sq_norms(queries)
        _build.launch("beam_hops", "beam_hops_l2_launch", dev,
                      adj.data_ptr(), x.data_ptr(), n2.data_ptr(),
                      queries.data_ptr(), qn.data_ptr(), *pool, *outs, b, l,
                      r, d, h)
        _build.count(beam_hops, "l2_launches")
    return out


beam_hops.launches = 0
beam_hops.l2_launches = 0
