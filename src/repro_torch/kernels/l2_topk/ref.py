"""Plain PyTorch version of the fused L2 top-k kernel (`csrc/l2_topk.cu`).

Port of `repro.kernels.l2_topk.ref.l2_topk_ref`, computed in the kernel's
order so that the two agree bitwise: |q|^2, |x|^2 and q.x are each summed
over i = 0, 1, ... by separate rounded multiplies and adds, and
d = max((|q|^2 + |x|^2) - 2 q.x, 0).  The reference's matmul form sums in
an order XLA chooses, so against it the port is held to a tolerance.
"""
from __future__ import annotations

import torch


def sq_l2_ordered(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(B, D), (N, D) -> (B, N) squared L2 in the kernel's order, clamped
    at +0.0 (a -0.0 or NaN difference becomes +0.0, as in the kernel)."""
    q = queries.float()
    x = base.float()
    b, d = q.shape
    qn = torch.zeros(b, dtype=torch.float32, device=q.device)
    xn = torch.zeros(x.shape[0], dtype=torch.float32, device=q.device)
    dot = torch.zeros((b, x.shape[0]), dtype=torch.float32, device=q.device)
    for i in range(d):
        qi, xi = q[:, i], x[:, i]
        qn = qn + qi * qi
        xn = xn + xi * xi
        dot = dot + qi[:, None] * xi[None, :]
    dist = (qn[:, None] + xn[None, :]) - 2.0 * dot
    return torch.where(dist > 0, dist, 0.0)


def l2_topk_ref(queries: torch.Tensor, base: torch.Tensor, k: int):
    """queries (B, D), base (N, D) -> (dists (B, k) f32 ascending, ids
    (B, k) int32), ordered by (dist, id) -- `jax.lax.top_k(-d, k)`'s
    order, lower id first on ties: a stable sort, since `torch.topk`
    promises no tie order.  Past N: dist +inf, id -1.  Any k >= 0."""
    dist = sq_l2_ordered(queries, base)
    b, n = dist.shape
    vals, ids = torch.sort(dist, dim=1, stable=True)
    vals, ids = vals[:, :k], ids[:, :k].to(torch.int32)
    if k > n:
        vals = torch.cat([vals, vals.new_full((b, k - n), torch.inf)], 1)
        ids = torch.cat([ids, ids.new_full((b, k - n), -1)], 1)
    return vals, ids
