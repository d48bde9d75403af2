"""Exact L2 top-k: the dispatch wrapper of the fused kernel
(`csrc/l2_topk.cu`), and the per-row re-rank.

`l2_topk` ports `repro.kernels.l2_topk.ops.l2_topk` (the Pallas
`l2_topk_pallas`).  backend: "cuda" launches the kernel (CUDA tensors
only), "ref" runs the plain version (`ref.l2_topk_ref`), "auto" launches
the kernel for CUDA tensors and runs the plain version for CPU tensors.
A call makes the four launches of `STAGES` (`plan(...).launches`), each
counted in `l2_topk.launches`.

`sq_l2_rowwise` and `l2_topk_rowwise` port the reference's functions of
the same names; they are plain jnp outside any Pallas kernel there, and
plain PyTorch here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build
from .ref import l2_topk_ref

MAX_K = 1024        # the resolve CTA sorts at most 1,024 selected keys
BINS = 2048          # the first radix digit: bits 30..20 of bits(dist)
WORKSPACE = BINS + 8  # int32 a query: histogram, then t, nb, nt, counters
QUERIES_PER_CTA = 8  # queries a scan CTA scores each staged tile against
THREADS = 256       # a scan CTA's threads: one per staged row
_TILE_BYTES = 64 * 1024    # shared memory a scan CTA stages base rows in
_TARGET_CTAS = 8 * 132     # 8 scan CTAs on each of the H100's 132 SMs
_MAX_STRIPE = 65535        # rows a CTA's 16-bit histogram counts can hold
_MAX_GRID_Y = 65535        # the emit grid's second dimension is B
STAGES = ("scan", "threshold", "emit", "resolve")


@dataclass(frozen=True)
class Plan:
    """The kernel's launch geometry for (B, N, D, k).

    ceil(B / 8) x stripes scan CTAs: CTA (g, s) scores queries [8g, 8g + 8)
    against base rows [s * stripe, (s + 1) * stripe), staged `tile` rows at
    a time in rows of `stride` floats (odd, so that a warp's 32 rows fall
    in 32 banks); emit_blocks x B emit CTAs stream the stored distances.
    `launches` is the number of kernel launches per call: the four of
    `STAGES`, or none when B = 0."""
    stripes: int
    stripe: int
    tile: int
    stride: int
    emit_blocks: int
    launches: int


def plan(b: int, n: int, d: int, k: int) -> Plan:
    """Launch geometry and launch count of one call (k does not change it:
    every k takes the same four launches)."""
    stride = d | 1
    tile = max(1, min(THREADS, _TILE_BYTES // (4 * stride)))
    groups = max(1, -(-b // QUERIES_PER_CTA))
    tiles = max(1, -(-n // tile))
    stripes = min(tiles, max(1, -(-_TARGET_CTAS // groups)))
    stripe = min(-(-tiles // stripes), _MAX_STRIPE // tile) * tile
    stripes = max(1, -(-n // stripe))
    emit_blocks = min(max(1, -(-n // (4 * THREADS))),
                      max(1, -(-4 * _TARGET_CTAS // max(b, 1))))
    return Plan(stripes, stripe, tile, stride, emit_blocks,
                len(STAGES) if b > 0 else 0)


def l2_topk(queries: torch.Tensor, base: torch.Tensor, k: int,
            backend: str = "auto"):
    """Exact k smallest squared-L2 distances of each query against `base`.

    queries (B, D), base (N, D), f32 (bf16 and other float types are
    cast to f32).  Returns (dists (B, k) f32 ascending, ids (B, k) int32),
    ordered by (dist, id); past N, dist = +inf and id = -1.  The kernel
    takes k <= 1024; the plain version any k.
    """
    if not _build.use_kernel(backend, queries, "l2_topk"):
        return l2_topk_ref(queries, base, k)
    dev = queries.device
    q = queries.float().contiguous()
    x = base.float().contiguous()
    b, d = q.shape
    n = x.shape[0]
    _build.check(q, "queries", torch.float32, (b, d), dev)
    _build.check(x, "base", torch.float32, (n, d), dev)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk kernel takes 1 <= k <= {MAX_K}, got {k}")
    if n >= 2 ** 31:
        raise ValueError(f"l2_topk kernel takes N < 2^31 (int32 ids), "
                         f"got {n}")
    if b > _MAX_GRID_Y:
        raise ValueError(f"l2_topk kernel takes B <= {_MAX_GRID_Y}, got {b}")
    p = plan(b, n, d, k)
    lib = _build.library()
    smem = lib.l2_topk_scan_smem_bytes(d, p.tile, p.stride,
                                       min(b, QUERIES_PER_CTA))
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"l2_topk kernel at D = {d} needs {smem} bytes of "
                         f"shared memory; the limit is "
                         f"{_build.MAX_SMEM_BYTES}")
    dists = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return dists, ids
    # per query: the first digit's histogram, then t, nb, nt and the emit
    # counters (zeroed in the C entry point); bits(dist) of every key, in
    # rows padded to 16 bytes; the emitted keys
    ws = torch.empty((b, WORKSPACE), dtype=torch.int32, device=dev)
    dist_bits = torch.empty((b, lib.l2_topk_bits_ld(n)), dtype=torch.int32,
                            device=dev)
    keys = torch.empty((b, max(n, 1)), dtype=torch.int64, device=dev)
    _build.launch("l2_topk", "l2_topk_launch", dev, q.data_ptr(),
                  x.data_ptr(), ws.data_ptr(), dist_bits.data_ptr(),
                  keys.data_ptr(), dists.data_ptr(), ids.data_ptr(), b, n, d,
                  k, p.stride, p.tile, p.stripe, p.stripes, p.emit_blocks)
    for _ in range(p.launches):     # one C call issues the four kernels
        _build.count(l2_topk)
    return dists, ids


l2_topk.launches = 0


def sq_l2_rowwise(queries: torch.Tensor, bases: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row exact squared L2: queries (B, D) vs bases (B, C, D) ->
    (B, C); invalid entries get +inf."""
    diff = bases.float() - queries.float()[:, None, :]
    d = (diff * diff).sum(-1)
    if valid is not None:
        d = torch.where(valid, d, torch.inf)
    return d


def l2_topk_rowwise(queries: torch.Tensor, bases: torch.Tensor, k: int,
                    valid: torch.Tensor | None = None):
    """Per-row exact re-rank: each query against its *own* candidates.

    queries (B, D); bases (B, C, D); valid (B, C) bool or None.  Returns
    (dists (B, k) ascending, idx (B, k) int64) where idx indexes into C.
    Ties keep the lower index first, as `jax.lax.top_k` does: a stable
    sort, since `torch.topk` promises no tie order.
    """
    d = sq_l2_rowwise(queries, bases, valid)
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]
