"""Block-size arithmetic of the on-disk layouts (the part of
`repro.core.storage` that construction needs).

The storage classes themselves (`CoupledStorage`, `DecoupledStorage`) and
the block-device simulator they sit on come with the port of the host
index stack.
"""
from __future__ import annotations

BLOCK_SIZE = 4096  # OS page / logical disk block (repro.core.io_sim)


def max_capacity_for(r: int, block_size: int = BLOCK_SIZE) -> int:
    """Largest c such that c * (12 + 4R) <= block_size (decoupled layout)."""
    return max(1, block_size // (12 + 4 * r))


def coupled_nodes_per_block(d: int, r: int, block_size: int = BLOCK_SIZE) -> int:
    rec = 4 * d + 4 + 4 * r
    return max(1, block_size // rec) if rec <= block_size else 1
