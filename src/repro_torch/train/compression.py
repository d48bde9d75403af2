"""Gradient compression for data parallelism across pods (port of
`repro.train.compression`).

Two wire formats + error feedback:
  * bf16: 2x reduction, no state.
  * int8 + per-tensor scale + error feedback (1-bit-Adam-style residual):
    4x reduction; the quantization residual is carried in `err` and added
    back before the next quantization, so the *accumulated* gradient is
    unbiased.

`torch.round` rounds half to even, as `jnp.round` does, so `q` is the
reference's bit for bit.  `compressed_psum` is the explicit collective of
the manual data-parallel step (`train.trainer.make_manual_dp_step`):
quantize -> all-reduce over the mesh's data axes -> mean, with the
reference's arithmetic (int8: each replica's `q.float() * scale` summed
in f32).
"""
from __future__ import annotations

import torch

from ..utils.sharding import all_reduce, axis_size
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
    qs, errs = zip(*[_ef_one(g, e) for g, e in zip(leaves(tree),
                                                   leaves(err))])
    return unflatten(tree, list(qs)), unflatten(tree, list(errs))


def _ef_one(g, e):
    x = g.float() + e
    q, s = quantize_int8(x)
    return (q, s), x - dequantize_int8(q, s)


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(tree, axis_names, method: str = "int8_ef", err=None,
                    *, mesh):
    """All-reduce-mean a gradient tree over `mesh`'s `axis_names` with
    compression; every rank of those axes calls it.  Returns
    (mean_grads_f32, new_err).

    "none": f32 sums; "bf16": bf16 payloads summed in bf16; "int8_ef":
    error-feedback int8 (`err` required), each replica's dequantized
    `q.float() * scale` summed in f32 (the reference's wire: int8 q and
    one f32 scale a tensor; the sum of the scaled values is exact in the
    dequantization's linearity)."""
    axes = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    n = 1
    for ax in axes:
        n *= axis_size(mesh, ax)

    if method == "none":
        return tree_map(lambda g: all_reduce(g.float(), mesh, axes) / n,
                        tree), err
    if method == "bf16":
        return tree_map(lambda g: all_reduce(g.to(torch.bfloat16), mesh,
                                             axes).float() / n, tree), err
    if method == "int8_ef":
        if err is None:
            raise ValueError("int8_ef needs error-feedback state")
        out, errs = [], []
        for g, e in zip(leaves(tree), leaves(err)):
            (q, s), new_e = _ef_one(g, e)
            out.append(all_reduce(q.float() * s, mesh, axes) / n)
            errs.append(new_e)
        return unflatten(tree, out), unflatten(tree, errs)
    raise ValueError(method)
