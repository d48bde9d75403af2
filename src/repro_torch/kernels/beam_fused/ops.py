"""Dispatch wrapper for the fused ADC beam-hop kernel
(`csrc/beam_hops_adc.cu`).

`beam_hops` runs `max_hops` fused beam hops (frontier pick, adjacency and
code gathers, ADC score, ranked pool merge per hop) over a seeded sorted
pool and returns the final pool plus the per-hop frontier trace, the next
pick and the done mask.  backend: "cuda" launches the kernel (CUDA tensors
only), "ref" runs `beam_hops_ref`, "auto" launches the kernel for CUDA
tensors and runs the plain version for CPU tensors.  Launches are counted
in `beam_hops.launches`.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import beam_hops_ref

MAX_L = 1024    # one thread per pool slot, one block per row
MAX_R = 256


def beam_hops(adj, pool_ids, pool_d, pool_exp, max_hops: int, *, tables,
              codes, backend: str = "auto"):
    """Fused ADC beam-hop loop.  adj (N, R) int32 with -1 pad; the seeded
    pool (B, L) triplet (int32 ids, f32 dists, bool expanded) must be
    sorted by (dist, id) with invalid entries (-1, +inf, False); tables
    (B, M, K) f32; codes (N, M) uint8 (every code < K).

    Returns (pool_ids (B, L) int32, pool_d (B, L) f32, pool_exp (B, L)
    bool, hops (B,) int32, trace_ids (B, max_hops) int32, trace_d
    (B, max_hops) f32, next_id (B,) int32, done (B,) bool).
    """
    if not _build.use_kernel(backend, pool_ids, "beam_hops"):
        return beam_hops_ref(adj, pool_ids, pool_d, pool_exp, max_hops,
                             tables=tables, codes=codes)
    dev = pool_ids.device
    b, l = pool_ids.shape
    n, r = adj.shape
    _, m, k = tables.shape
    _build.check(adj, "adj", torch.int32, (n, r), dev)
    _build.check(codes, "codes", torch.uint8, (n, m), dev)
    _build.check(tables, "tables", torch.float32, (b, m, k), dev)
    _build.check(pool_ids, "pool_ids", torch.int32, (b, l), dev)
    _build.check(pool_d, "pool_d", torch.float32, (b, l), dev)
    _build.check(pool_exp, "pool_exp", torch.bool, (b, l), dev)
    if l > MAX_L or r > MAX_R:
        raise ValueError(f"beam_hops kernel takes L <= {MAX_L} and "
                         f"R <= {MAX_R}, got L={l}, R={r}")
    lib = _build.library()
    smem = lib.beam_hops_adc_smem_bytes(l, r, m, k)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"beam_hops at L={l}, R={r}, M={m}, K={k} needs "
                         f"{smem} bytes of shared memory; the limit is "
                         f"{_build.MAX_SMEM_BYTES}")
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
    if b:
        _build.launch(
            "beam_hops", "beam_hops_adc_launch", dev, adj.data_ptr(),
            codes.data_ptr(), tables.data_ptr(), pool_ids.data_ptr(),
            pool_d.data_ptr(), pool_exp.data_ptr(),
            *(o.data_ptr() for o in out), b, l, r, m, k, h)
        beam_hops.launches += 1
    return out


beam_hops.launches = 0
