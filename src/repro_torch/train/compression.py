"""Gradient compression for data parallelism across pods (port of
`repro.train.compression`).

Two wire formats + error feedback:
  * bf16: 2x reduction, no state.
  * int8 + per-tensor scale + error feedback (1-bit-Adam-style residual):
    4x reduction; the quantization residual is carried in `err` and added
    back before the next quantization, so the *accumulated* gradient is
    unbiased.

`torch.round` rounds half to even, as `jnp.round` does, so `q` is the
reference's bit for bit.  `compressed_psum`, the collective that
exchanges the compressed gradients, needs a process group and waits for
the sharded slice (ROADMAP Queue 1 item 7.3).
"""
from __future__ import annotations

import torch

from ..utils.tree import leaves, tree_map, unflatten


def compress_bf16(tree):
    return tree_map(lambda g: g.to(torch.bfloat16), tree)


def decompress_f32(tree):
    return tree_map(lambda g: g.float(), tree)


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(tree, err):
    """Error-feedback int8: quantize (g + err); new err = input - dequant.
    Returns (tree of (q, scale), tree of new errors)."""
    def one(g, e):
        x = g.float() + e
        q, s = quantize_int8(x)
        return (q, s), x - dequantize_int8(q, s)
    qs, errs = zip(*[one(g, e) for g, e in zip(leaves(tree), leaves(err))])
    return unflatten(tree, list(qs)), unflatten(tree, list(errs))


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(*args, **kwargs):
    """All-reduce-mean of a gradient tree with compression."""
    raise NotImplementedError(
        "compressed_psum (a compressed gradient all-reduce over a process "
        "group) waits for the sharded slice (ROADMAP Queue 1 item 7.3)")
