"""Plain PyTorch version of the split-KV flash-decode kernel
(`csrc/flash_decode.cu`).

Port of `repro.kernels.flash_decode.ref.flash_decode_ref`, with the Pallas
kernel's semantics at the edges (`repro/kernels/flash_decode/kernel.py`):
masked scores are -1e30 and their weights are zeroed, and the weighted sum
is divided by max(l, 1e-30).  So a row with cache_len <= 0 attends to
nothing and returns zeros (the reference's plain version returns NaN
there), and positions past S simply do not exist (cache_len > S means
all S positions, as in the reference's plain version; its Pallas path
would also count the zero rows it pads S with).

The kernel sums in another order (an online softmax per split of the
positions, merged by the log-sum-exp rule), so the two agree within a
tolerance, not bitwise.
"""
from __future__ import annotations

import torch

from ...core.distances import f32_matmul

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """q (B, H, Dh); k, v (B, S, Hkv, Dh); cache_len (B,) -> (B, H, Dh) f32.

    H = G * Hkv (grouped-query attention): query head h reads kv head
    h // G.  Position j of row b counts iff j < cache_len[b].
    """
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, hkv, g, dh) * scale
    kf = k.float()
    vf = v.float()
    valid = (torch.arange(s, device=q.device)[None, :]
             < cache_len.to(q.device)[:, None])[:, None, None, :]
    with f32_matmul():
        scores = torch.einsum("bngd,bsnd->bngs", qf, kf)     # (B, Hkv, G, S)
        scores = torch.where(valid, scores, NEG_INF)
        m = scores.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(scores - m), 0.0)
        l = p.sum(-1, keepdim=True)
        acc = torch.einsum("bngs,bsnd->bngd", p, vf)
    return (acc / l.clamp_min(1e-30)).reshape(b, h, dh)
