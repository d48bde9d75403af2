"""Exact L2 top-k: the dispatch wrapper of the fused kernel
(`csrc/l2_topk.cu`), and the per-row re-rank.

`l2_topk` ports `repro.kernels.l2_topk.ops.l2_topk` (the Pallas
`l2_topk_pallas`).  backend: "cuda" launches the kernel (CUDA tensors
only), "ref" runs the plain version (`ref.l2_topk_ref`), "auto" launches
the kernel for CUDA tensors and runs the plain version for CPU tensors.
Every pass of the kernel is one launch, counted in `l2_topk.launches`.

`sq_l2_rowwise` and `l2_topk_rowwise` port the reference's functions of
the same names; they are plain jnp outside any Pallas kernel there, and
plain PyTorch here.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import l2_topk_ref

MAX_K = 1024        # the kernel's chunks hold at least 2k keys
_MAX_CHUNK = 8192   # keys sorted by one CTA: 64 KB of shared memory
_MAX_GRID_Y = 65535


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def chunk_size(m: int, k: int) -> int:
    """Keys one CTA sorts (a power of two) when a pass selects from m per
    row: at least 2k, so each pass cuts a row's keys by C / k or more; 8k
    where that fits (a factor of 8 per pass) and at least 2,048, but no
    more than m needs."""
    lo = _pow2_at_least(2 * k)
    c = min(_MAX_CHUNK, max(2048, _pow2_at_least(8 * k)))
    return max(lo, min(c, _pow2_at_least(m)))


def plan(n: int, k: int) -> list[tuple[int, int]]:
    """The kernel's passes for N base rows and k: [(C, S)] per pass.  Pass
    1 sorts S = ceil(N / C) chunks of C rows per query; each later pass
    chunks of C of the m = S_prev * k keys left, until one chunk
    remains."""
    m, passes = n, []
    while not passes or passes[-1][1] > 1:
        c = chunk_size(m, k)
        passes.append((c, max(1, -(-m // c))))
        m = passes[-1][1] * k
    return passes


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
    passes = plan(n, k)
    (c, s), later = passes[0], passes[1:]
    if s > _MAX_GRID_Y:
        raise ValueError(f"l2_topk kernel takes N <= {_MAX_GRID_Y * c} at "
                         f"k = {k}, got {n}")
    lib = _build.library()
    smem = lib.l2_topk_smem_bytes(c, d)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"l2_topk kernel at D = {d} needs {smem} bytes of "
                         f"shared memory; the limit is "
                         f"{_build.MAX_SMEM_BYTES}")
    dists = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return dists, ids

    def keys_for(grid):     # None on the last pass: it writes dists, ids
        return (None if grid == 1 else
                torch.empty((b, grid, k), dtype=torch.int64, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = keys_for(s)
    _build.launch("l2_topk", "l2_topk_rows_launch", dev, q.data_ptr(),
                  x.data_ptr(), ptr(out), dists.data_ptr(), ids.data_ptr(),
                  b, n, d, c, s, k)
    _build.count(l2_topk)
    for c, s_next in later:
        keys, out = out, keys_for(s_next)
        _build.launch("l2_topk", "l2_topk_keys_launch", dev, keys.data_ptr(),
                      ptr(out), dists.data_ptr(), ids.data_ptr(), b, s * k,
                      c, s_next, k)
        _build.count(l2_topk)
        s = s_next
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
