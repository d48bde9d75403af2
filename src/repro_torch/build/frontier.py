"""Batched construction frontier: whole-batch beam candidate collection
(port of `repro.build.frontier`).

Vamana and NSG construction both run, for every node p, a beam search from
the medoid to collect the candidate pool that RobustPrune consumes.  The
host implementation (`core.graph_build.greedy_search`) is a Python heapq
loop per node; this module runs the beam for a whole node batch at once
with fixed-shape tensor ops, using the (B, L) sorted-pool pattern of the
serving engine:

- each hop expands the `width` best unexpanded candidates of every row at
  once (DiskANN-style beam width);
- a (B, N) `seen` mask (the host's `seen` set) filters re-proposed nodes
  *before* the merge truncates, so overlapping neighbourhoods do not
  collapse the pool to a handful of distinct ids;
- neighbour scoring is exact squared L2 in dot form with precomputed corpus
  norms, one batched product per hop in IEEE f32 (`core.distances.f32_matmul`);
- the merge keeps the `pl` smallest of pool + candidates by a stable sort
  (candidates are already distinct and disjoint from the pool).

The batch runs a fixed hop count, where the host stops at its bound check;
like the host, the pool it returns is the *expanded* (visited) set,
ascending by distance.

`frontier_pools(backend="fused" | "fused_ref")` instead runs the hops through
the fused beam-hop kernel in exact-L2 mode (`kernels.beam_fused.beam_hops`,
`csrc/beam_hops_l2.cu`) or its plain version, at width 1 with a
`pool_merge`-invariant pool; its per-hop frontier trace *is* the visited
set.  Its dot products are summed in the kernel's sequential order, so
the two backends' distances agree to rounding, not bitwise.  The ranked
merge dedupes against the live pool only, where the seen mask dedupes
against everything ever proposed, so the two backends visit the same
nodes when the pool is large enough that nothing useful is evicted.

Ties: every selection is a stable sort, which puts the lower index first
as `jax.lax.top_k` and `jnp.argsort` do in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import reject_tpu_backend, resolve_device, to_device, to_numpy
from ..core.distances import f32_matmul
from ..kernels.beam_fused import beam_hops
from ..kernels.beam_fused.ref import sq_norms
from .chunking import map_chunks
from .pool import pool_merge

# frontier_pools backend -> the beam_hops backend of the fused path
_FUSED = {"fused": "auto", "fused_ref": "ref"}
BACKENDS = ("batched", *_FUSED)
_SENT = torch.iinfo(torch.int32).max


def _smallest(d: torch.Tensor, k: int):
    """Sorted order of the k smallest entries of each row of d, lower
    index first on ties (`jax.lax.top_k(-d, k)`'s order)."""
    vals, o = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], o[:, :k]


def _score(x, n2, q, qn, ids):
    """Exact squared L2 of each row's query to corpus ids (B, C), one
    batched product: max(n2 - 2 x.q + |q|^2, 0), +inf where the id is -1."""
    c = ids.clamp_min(0).long()
    with f32_matmul():
        dot = torch.einsum("bcd,bd->bc", x[c], q)
    d = (n2[c] - 2.0 * dot + qn[:, None]).clamp_min(0.0)
    return torch.where(ids >= 0, d, torch.inf)


def _frontier_batch(x, n2, adj, entries, queries, ef: int, max_hops: int,
                    width: int):
    """The seen-mask beam for a query batch over a padded graph.

    x (N, D) f32; n2 (N,) squared norms; adj (N, R) int32 with -1 pad;
    entries (E,) int32 shared seed ids; queries (B, D).  Returns (ids
    (B, max_hops*width) int32 with -1 pad, dists ascending): every node
    the beam *expanded*, the analog of greedy_search's visited set.
    """
    b = queries.shape[0]
    n, r = adj.shape
    dev = queries.device
    q = queries.float()
    qn = sq_norms(q)
    rows = torch.arange(b, device=dev)[:, None]
    # beam pool slack: the host heap never forgets a pushed candidate, so
    # it can expand nodes ranked past ef once closer ones exhaust
    pl = ef + ef // 2

    def merge(pool_ids, pool_d, pool_exp, cand_ids, cand_d):
        ids = torch.cat([pool_ids, cand_ids], 1)
        d = torch.cat([pool_d, cand_d], 1)
        exp = torch.cat([pool_exp, torch.zeros_like(cand_ids, dtype=torch.bool)],
                        1)
        d, o = _smallest(d, pl)
        return torch.gather(ids, 1, o), d, torch.gather(exp, 1, o)

    # the seen mask has a spare column N that every -1 writes to, so no
    # two valid writes of a row ever collide
    seen = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    seen[:, entries.long()] = True
    seed_ids = entries[None, :].expand(b, -1).to(torch.int32)
    pool_ids, pool_d, pool_exp = merge(
        torch.full((b, pl), -1, dtype=torch.int32, device=dev),
        torch.full((b, pl), torch.inf, device=dev),
        torch.zeros((b, pl), dtype=torch.bool, device=dev),
        seed_ids, _score(x, n2, q, qn, seed_ids))

    vis_ids, vis_d = [], []
    for _ in range(max_hops):
        frontier_d = torch.where(pool_exp | (pool_ids < 0), torch.inf, pool_d)
        fd, jidx = _smallest(frontier_d, width)              # (B, W)
        has = torch.isfinite(fd)
        v = torch.where(has, torch.gather(pool_ids, 1, jidx), 0)
        pool_exp = pool_exp.scatter(1, jidx, torch.gather(pool_exp, 1, jidx)
                                    | has)
        nbrs = torch.where(has[:, :, None], adj[v.long()], -1)
        nbrs = nbrs.reshape(b, width * r)
        # within-hop dedupe by id, then drop already-seen nodes (the pool
        # is a subset of seen, so candidates never duplicate pool entries)
        key = torch.where(nbrs < 0, _SENT, nbrs)
        key_s, o = torch.sort(key, dim=1, stable=True)
        ids_s = torch.gather(nbrs, 1, o)
        dup = torch.zeros_like(key_s, dtype=torch.bool)
        dup[:, 1:] = key_s[:, 1:] == key_s[:, :-1]
        slot = torch.where(ids_s < 0, n, ids_s).long()
        new = (ids_s >= 0) & ~dup & ~seen[rows, slot]
        cand = torch.where(new, ids_s, -1)
        seen[rows, torch.where(new, slot, n)] = True
        pool_ids, pool_d, pool_exp = merge(pool_ids, pool_d, pool_exp, cand,
                                           _score(x, n2, q, qn, cand))
        vis_ids.append(torch.where(has, v, -1))
        vis_d.append(torch.where(has, fd, torch.inf))
    # visited (B, hops*W), ascending by distance: every expanded node is
    # returned even if later evicted from the beam pool
    vis_ids = torch.stack(vis_ids, 1).reshape(b, max_hops * width)
    vis_d = torch.stack(vis_d, 1).reshape(b, max_hops * width)
    vis_d, o = torch.sort(vis_d, dim=1, stable=True)
    return torch.gather(vis_ids, 1, o).to(torch.int32), vis_d


def _frontier_batch_fused(x, n2, adj, entries, queries, ef: int,
                          max_hops: int, backend: str):
    """Width-1 beam for a query batch through the fused hop kernel.

    Same operands and return contract as `_frontier_batch` with width=1:
    seed a (B, pl) `pool_merge`-invariant pool with the shared entries,
    run `max_hops` fused hops (exact-L2 scoring in the kernel's order,
    `kernels.beam_fused.ref.l2_score`), and return the per-hop frontier
    trace stable-sorted ascending by distance.  The seeds are scored by
    `_score`, as the reference scores them.
    """
    b = queries.shape[0]
    dev = queries.device
    q = queries.float().contiguous()
    pl = ef + ef // 2                                    # same beam slack
    seed_ids = entries[None, :].expand(b, -1).to(torch.int32)
    sd = _score(x, n2, q, sq_norms(q), seed_ids)
    pool = pool_merge(torch.full((b, pl), -1, dtype=torch.int32, device=dev),
                      torch.full((b, pl), torch.inf, device=dev),
                      torch.zeros((b, pl), dtype=torch.bool, device=dev),
                      seed_ids, sd, pl)
    _, _, _, _, tid, td, _, _ = beam_hops(
        adj, *(t.contiguous() for t in pool), max_hops, x=x, n2=n2,
        queries=q, backend=backend)
    td, o = torch.sort(td, dim=1, stable=True)
    return torch.gather(tid, 1, o), td


def default_hops(ef: int, width: int) -> int:
    """Hop count giving ~ef + 2*width expansions -- the host loop expands
    ~ef nodes before its bound check fires."""
    return -(-ef // width) + 2


def frontier_arrays(x, adj, device=None) -> tuple:
    """(x, n2, adj) on `device` (None: the CUDA device), built once per
    build and handed to every `frontier_pools` call so that the corpus
    and the graph stay on the device across chunks."""
    dev = resolve_device(device)
    xt = to_device(x, dev, torch.float32)
    return xt, sq_norms(xt), to_device(adj, dev, torch.int32)


def frontier_pools(
    x,
    adj,
    entries,
    node_ids,
    ef: int,
    max_hops: int | None = None,
    batch: int = 256,
    width: int = 8,
    device_arrays: tuple | None = None,
    backend: str = "batched",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Candidate pools for a set of build nodes, chunked over batches.

    Runs the batched beam from `entries` toward x[node_ids] and returns
    numpy (ids (n, max_hops*width) int32 with -1 pad, dists ascending) --
    each row is the beam's expanded/visited set, the host prune's
    candidate source.  Independent chunks are pipelined two-deep.
    `device_arrays` optionally carries `(x, n2, adj)` already on the
    device (`frontier_arrays`), so repeated calls (the Vamana batch
    loop) skip the upload; otherwise x and adj go to `device` (None: the
    CUDA device).

    backend: "batched" (the seen-mask beam above), "fused" (the L2
    kernel on a CUDA device, its plain version on the CPU) or "fused_ref"
    (the plain version) -- the last two run the fused beam-hop loop at
    width 1 (`width` is ignored; the hop count defaults to the width-1
    `default_hops`).  The JAX package's TPU names (`fused_pallas`,
    `fused_stream`, `fused_interpret`, `fused_stream_interpret`) raise a
    ValueError naming their counterpart.
    """
    reject_tpu_backend(backend, BACKENDS)
    if backend not in BACKENDS:
        raise ValueError(f"frontier backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device_arrays is None:
        device_arrays = frontier_arrays(x, adj, device)
    xt, n2, adjt = device_arrays
    dev = xt.device
    node_ids = np.asarray(node_ids, np.int64)
    entries = torch.as_tensor(np.asarray(entries, np.int32).ravel(),
                              device=dev)
    width = max(1, min(width, ef)) if backend == "batched" else 1
    if max_hops is None:
        max_hops = default_hops(ef, width)
    out_w = max_hops * width
    out_ids = np.empty((len(node_ids), out_w), np.int32)
    out_d = np.empty((len(node_ids), out_w), np.float32)

    def run(s):
        chunk = node_ids[s:s + batch]
        qs = xt[torch.as_tensor(chunk, device=dev)]
        if backend == "batched":
            ids, d = _frontier_batch(xt, n2, adjt, entries, qs, ef=ef,
                                     max_hops=max_hops, width=width)
        else:
            ids, d = _frontier_batch_fused(xt, n2, adjt, entries, qs, ef=ef,
                                           max_hops=max_hops,
                                           backend=_FUSED[backend])
        out_ids[s:s + len(chunk)] = to_numpy(ids)
        out_d[s:s + len(chunk)] = to_numpy(d)

    map_chunks(list(range(0, len(node_ids), batch)), run)
    return out_ids, out_d
