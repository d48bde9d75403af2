"""Plain reference of an L2 nearest-neighbour search, and the comparison
that judges a system's answers by it.

The reference is an exact search over the benchmark's own corpus and
queries: squared distances by the expanded form in float32 with TF32 off
pick `k + EXTRA` candidates a query, and the candidates' distances are
worked out again in float64 from the differences, which orders them.  It
takes nothing the system made (no index, no codes, no distances).

`judge` holds a system's answers, (ids, squared distances) a query,
against it:

- `bad_rows`: rows with an id outside the corpus, a repeated id, a
  distance that is not finite, or distances out of ascending order;
- `dist_gap`: the widest relative gap between a returned squared distance
  and the float64 distance of the same query and id;
- `rel_excess`: ann-benchmarks' `rel` less 1, the distances of the ids
  returned over those of the exact top k, summed over the rows that are
  not bad, each distance worked out again by the reference.

It also gives the answers' recall@k against the exact top k.

`control_search` is this reference put in the system's place one
precision lower, TF32 for the configuration's float32: the products run
on TF32 tensor cores on a card, and with operands rounded to TF32's 10-bit
mantissa elsewhere.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench.data import exact_f32

BLOCK = 1 << 16      # corpus rows per distance block
EXTRA = 16           # candidates beyond k refined in float64


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _topk_expanded(x, q, k: int, tf32: bool):
    """Per query the k smallest ||x||^2 - 2 q.x (+ ||q||^2) over `x` in
    blocks: (dists (B, k) f32 ascending, ids (B, k) int64)."""
    on_card = x.is_cuda
    qn = (q * q).sum(1, keepdim=True)
    qm = _round_tf32(q) if tf32 and not on_card else q
    best_d = torch.full((q.shape[0], 0), torch.inf, device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    ctx = _tf32() if tf32 and on_card else exact_f32()
    with ctx:
        for s in range(0, x.shape[0], BLOCK):
            xb = x[s:s + BLOCK]
            xm = _round_tf32(xb) if tf32 and not on_card else xb
            d = qn + (xb * xb).sum(1)[None] - 2 * (qm @ xm.T)
            d, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            best_d = torch.cat([best_d, d], 1)
            best_i = torch.cat([best_i, i + s], 1)
            best_d, j = torch.topk(best_d, min(k, best_d.shape[1]), dim=1,
                                   largest=False)
            best_i = torch.gather(best_i, 1, j)
    return best_d, best_i


def _pair_d64(x, q, ids) -> torch.Tensor:
    """float64 squared distances of each query to its (B, c) ids."""
    diff = x[ids].double() - q.double()[:, None, :]
    return (diff * diff).sum(-1)


def exact_search(x: torch.Tensor, q: torch.Tensor, k: int):
    """The exact top k of each query: (ids (B, k) int64, squared
    distances (B, k) float64 ascending)."""
    _, cand = _topk_expanded(x, q, k + EXTRA, tf32=False)
    d64 = _pair_d64(x, q, cand)
    d64, j = torch.sort(d64, dim=1, stable=True)
    return torch.gather(cand, 1, j)[:, :k], d64[:, :k]


def control_search(x: torch.Tensor, q: torch.Tensor, k: int):
    """The reference one precision down, in the system's place: the
    top k and their squared distances as TF32 products give them, as
    numpy (ids (B, k) int64, dists (B, k) float32)."""
    d, i = _topk_expanded(x, q, k, tf32=True)
    return i.cpu().numpy(), d.cpu().numpy()


class Control:
    """`control_search` in the system's place, with the interface that
    `bench/run.py` drives."""

    def __init__(self, x: torch.Tensor):
        self.x = x

    def search(self, q: torch.Tensor, k: int, **kw):
        return control_search(self.x, q, k)

    def corpus_equals(self, x: torch.Tensor) -> bool:
        return bool(torch.equal(self.x, x))

    def close(self) -> None:
        self.x = None


def judge(x: torch.Tensor, q: torch.Tensor, gt, ids: np.ndarray,
          dists: np.ndarray):
    """The numbers compared for one batch of answers, and its recall@k:
    `x` the corpus and `q` the queries on one device, `gt` their exact
    (ids, squared distances) from `exact_search`, `ids` / `dists` the
    (B, k) answers."""
    gt_ids, gt_d = gt
    n, k = x.shape[0], gt_ids.shape[1]
    ids_t = torch.as_tensor(np.asarray(ids), device=x.device).long()
    d_t = torch.as_tensor(np.asarray(dists), device=x.device).float()
    if ids_t.shape != gt_ids.shape or d_t.shape != gt_ids.shape:
        raise ValueError(f"answers of shape {tuple(ids_t.shape)} / "
                         f"{tuple(d_t.shape)}, expected "
                         f"{tuple(gt_ids.shape)}")
    inside = (ids_t >= 0) & (ids_t < n)
    finite = torch.isfinite(d_t)
    s = torch.sort(ids_t, 1).values
    repeated = (s[:, 1:] == s[:, :-1]).any(1)
    unordered = (d_t[:, 1:] < d_t[:, :-1]).any(1)
    bad = ~inside.all(1) | ~finite.all(1) | repeated | unordered
    ok = inside & finite
    d_ref = _pair_d64(x, q, ids_t.clamp(0, n - 1))
    gap = (d_t.double() - d_ref).abs() / d_ref.clamp_min(1e-30)
    dist_gap = float(gap[ok].max()) if bool(ok.any()) else float("inf")
    good = ~bad
    if bool(good.any()):
        # ann-benchmarks' "rel": the distances found over the exact ones,
        # summed over the queries (here over the rows that are not bad)
        rel = float(d_ref[good].sqrt().sum() / gt_d[good].sqrt().sum())
    else:
        rel = float("inf")
    hits = (gt_ids[:, :, None] == torch.where(ok, ids_t, -1)[:, None, :]
            ).any(2)
    return ({"bad_rows": int(bad.sum()), "dist_gap": dist_gap,
             "rel_excess": rel - 1.0}, float(hits.float().mean()))
