"""Split-KV flash-decode: the dispatch wrapper of the kernel
(`csrc/flash_decode.cu`).

`flash_decode` ports `repro.kernels.flash_decode.ops.flash_decode` (the
Pallas `flash_decode_pallas`).  backend: "cuda" launches the kernel (CUDA
tensors only), "ref" runs the plain version (`ref.flash_decode_ref`),
"auto" launches the kernel for CUDA tensors and runs the plain version for
CPU tensors.  A call is two launches, the split pass and the combine, each
counted in `flash_decode.launches`.  Unlike the reference's wrapper, S is
not padded to a multiple of a chunk: the kernel masks the ragged end
itself, and cache_len > S means all S positions.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import flash_decode_ref

MAX_DH = 256          # a row is at most 32 lanes of two 16-byte pieces
WARPS = 4             # warps of a CTA, each with its own ring
PASSES = 4            # row passes of a warp per ring stage
STAGES = 3            # depth of each warp's ring of K and V stages
HEADS_PER_CTA = 4     # query heads of one kv head that one CTA serves
MAX_SPLITS = 1024     # CTAs along S per (b, kv head group)
WAVES = 2             # whole waves of resident CTAs the grid aims at
SMS = 132             # the H100's SMs
SMEM_PER_SM = 233472  # shared memory of an SM (228 KB) ...
SMEM_PER_CTA = 1024   # ... less 1 KB the card reserves for each CTA
MAX_THREADS_PER_SM = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def row_lanes(dh: int, itemsize: int) -> tuple[int, int]:
    """(nv, lpr): 16-byte pieces a lane holds of a Dh row and lanes that
    hold a row, as the kernel lays them out: lpr the power of two at or
    above the row's pieces, at most 32, two pieces a lane past 32."""
    pieces = -(-dh * itemsize // 16)
    if pieces > 32:
        return 2, 32
    return 1, 1 << (pieces - 1).bit_length()


def stage_rows(dh: int, itemsize: int) -> int:
    """Positions a warp takes per ring stage: PASSES passes of 32 / lpr
    rows (8 at Dh = 128 in bf16)."""
    return PASSES * 32 // row_lanes(dh, itemsize)[1]


def ctas_per_sm(dh: int, itemsize: int) -> int:
    """CTAs an SM holds at once: the rings' shared memory binds (the
    kernel's __launch_bounds__ keeps its registers within it)."""
    nv = row_lanes(dh, itemsize)[0]
    smem = WARPS * STAGES * 2 * PASSES * nv * 32 * 16
    return min(SMEM_PER_SM // (smem + SMEM_PER_CTA),
               MAX_THREADS_PER_SM // (WARPS * 32))


def split_plan(b: int, hkv: int, g: int, s: int, dh: int,
               itemsize: int) -> tuple[int, int]:
    """(n_split, chunk): how the kernel splits S positions over CTAs, from
    the shapes alone.  The grid has B * Hkv * ceil(G / 4) CTAs per split;
    n_split makes it WAVES whole waves of the CTAs resident on the card
    (SMS * ctas_per_sm), or one split where that many groups already
    fill them (two waves, so that a CTA whose row ends early frees its
    slot for another).  A chunk is whole tiles of WARPS stages (every warp a stage),
    at least STAGES tiles where S allows (every ring full), at most
    MAX_SPLITS splits."""
    groups = b * hkv * -(-g // HEADS_PER_CTA)
    tile = WARPS * stage_rows(dh, itemsize)
    tiles = -(-s // tile)
    n = WAVES * SMS * ctas_per_sm(dh, itemsize) // max(groups, 1)
    n = max(1, min(n, -(-tiles // STAGES), MAX_SPLITS))
    chunk = -(-tiles // n) * tile
    return -(-s // chunk), chunk


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor, scale: float | None = None,
                 backend: str = "auto") -> torch.Tensor:
    """Decode (single new token) GQA attention over a KV cache.

    q (B, H, Dh); k, v (B, S, Hkv, Dh) contiguous; cache_len (B,) valid
    prefix lengths, on q's device.  Returns (B, H, Dh) float32.  The kernel
    takes f32 or bf16 q and caches, Dh <= 256 and any G = H / Hkv; it
    never reads cache_len on the host.
    """
    if not _build.use_kernel(backend, q, "flash_decode"):
        return flash_decode_ref(q, k, v, cache_len, scale=scale)
    dev = q.device
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"flash_decode kernel takes f32 or bf16 {name}, "
                             f"got {t.dtype}")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"flash_decode kernel takes 1 <= Dh <= {MAX_DH}, "
                         f"got {dh}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_decode: H = {h} is not a multiple of "
                         f"Hkv = {hkv}")
    if s < 1:
        raise ValueError("flash_decode kernel needs S >= 1")
    q = q.contiguous()
    lens = cache_len.to(torch.int32)
    _build.check(q, "q", q.dtype, (b, h, dh), dev)
    _build.check(k, "k", k.dtype, (b, s, hkv, dh), dev)
    _build.check(v, "v", k.dtype, (b, s, hkv, dh), dev)
    _build.check(lens, "cache_len", torch.int32, (b,), dev)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    n_split, chunk = split_plan(b, hkv, h // hkv, s, dh, k.element_size())
    part_m = torch.empty((b, h, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, n_split, dh), dtype=torch.float32,
                           device=dev)
    scale = dh ** -0.5 if scale is None else scale
    _build.launch("flash_decode", "flash_decode_split_launch", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                  part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                  b, s, h, hkv, dh, n_split, chunk, _DTYPES[q.dtype],
                  _DTYPES[k.dtype], float(scale))
    _build.count(flash_decode)
    _build.launch("flash_decode", "flash_decode_combine_launch", dev,
                  part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                  out.data_ptr(), b * h, n_split, dh)
    _build.count(flash_decode)
    return out


flash_decode.launches = 0
