"""Shared neural building blocks (port of the parts of
`repro.models.layers` that DIN needs)."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """A (d_in, d_out) weight, N(0, 1/d_in), in the reference's layout
    (applied as x @ w).  Drawn on the generator's device from `generator`
    (torch's draws, not jax.random's), then moved to `device`."""
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)
