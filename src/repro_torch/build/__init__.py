"""Batched fixed-shape index construction (port of `repro.build`).

- `frontier`: whole-batch beam candidate collection ((B, L) sorted pool,
  exact squared-L2 scoring), through the fused exact-L2 hop kernel under
  `frontier_backend="fused"`.
- `prune`: vectorized masked RobustPrune / MRNG edge selection.
- `bamg_refine`: Algorithm 2 with all intra-block monotone probes
  ((v, q) pairs) evaluated on the device.
- `builder.GraphBuilder`: the facade; batched with the fused frontier by
  default, `backend="host"` keeping the numpy reference oracle.
- `pool`: the (B, L) candidate pool of the serving engine.
"""
from .builder import BuildConfig, GraphBuilder
from .frontier import frontier_pools
from .pool import pool_merge
from .prune import robust_prune_batch, robust_prune_inc

__all__ = [
    "BuildConfig",
    "GraphBuilder",
    "frontier_pools",
    "pool_merge",
    "robust_prune_batch",
    "robust_prune_inc",
]
