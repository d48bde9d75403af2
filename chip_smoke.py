#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched BAMG query and construction paths
on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py         # serve at N = 1,000,000, build at 100,000
    python3 chip_smoke.py --n 100000 --build-n 20000    # a quicker check

Phases, in order; any failed check raises and the script exits nonzero:

1. card: name and power limit (nvidia-smi), TF32 off for matmul and cuDNN;
2. build: nvcc compiles the kernels in `src/repro_torch/csrc/`;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes and on ragged cases (odd batch sizes, -1
   adjacency pads, rows that run out of frontier, integer-valued tables and
   vectors that force (dist, id) ties, tables above 48 KB of shared memory,
   D = 960 query rows); times by CUDA events beside the plain version, a
   one-call PyTorch yardstick where one exists, and the least time the card
   could take (`bound_ms`);
4. query path: `paper_dataset("sift-like")` at `--n` with exact top-100
   ground truth, an exact kNN graph at BAMG's serving width R = 32, PQ
   trained and encoded on the card, and 1,024 queries served in batches of
   64 under the backends "auto" (fused hop kernel), "cuda" (hop loop with
   the rowwise kernel) and "ref" (plain PyTorch).  The three must agree,
   the launch counters must show the kernels ran, every returned distance
   must be the exact one of its id, and tombstoned ids must never come
   back;
5. construction path: a BAMG built on the card at `--build-n` from
   `paper_dataset("sift-like")` with `BAMGParams`' defaults -- NSG through
   `GraphBuilder()`'s defaults, `BuildConfig(backend="batched",
   frontier_backend="fused")` (the exact-L2 hop kernel, one launch per 256
   nodes), BNF blocks, the Alg. 2 refine, PQ, the nav graph,
   `batch_arrays` -- then served under "auto" and "ref", beside an exact
   kNN graph of the same corpus.  On the build's own kNN graph and entry
   the kernel's frontier pools must equal the plain version's, and one
   profiled frontier run splits the stage into the kernel's device time,
   other device time and the host; the two backends must agree, and every
   stage's time is logged.

The last lines are the card's nvidia-smi line, one JSON object with every
kernel's numbers, and `{"ok": true, "device": {...}}`.  The script exits
nonzero, printing no result, where no CUDA device is present or where it
stands outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size of the query path (default: SIFT1M)")
    ap.add_argument("--build-n", type=int, default=100_000,
                    help="corpus size of the construction path (default: "
                         "a tenth of SIFT1M; the host-Python refine and nav "
                         "graph grow faster than N)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present; the port's kernels "
              "run only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.build import BuildConfig, GraphBuilder
    from repro_torch.build.frontier import frontier_arrays, frontier_pools
    from repro_torch.build.pool import pool_merge
    from repro_torch.core.block_assign import intra_edge_fraction
    from repro_torch.core.distances import knn_graph, medoid, recall_at_k
    from repro_torch.core.engine import _pick_pq_m, batch_arrays
    from repro_torch.core.graph_build import degree_stats
    from repro_torch.core.navgraph import build_navgraph
    from repro_torch.core.pq import train_pq
    from repro_torch.core.storage import max_capacity_for
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.beam_fused import beam_hops, beam_hops_ref
    from repro_torch.kernels.beam_fused.ref import l2_score, sq_norms
    from repro_torch.kernels.pq_adc import (pq_adc, pq_adc_ref,
                                            pq_adc_rowwise, pq_adc_rowwise_ref)
    from repro_torch.serve import BatchedANNEngine, EngineConfig

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sector_bytes(offsets) -> int:
        """Bytes device memory must move to read the bytes at `offsets`
        (byte offsets into one array): its distinct 32-byte sectors, each
        read once."""
        return int(torch.unique(offsets.reshape(-1) // 32).numel()) * 32

    def table_bytes(codes, k: int, valid=None) -> int:
        """Bytes of the (B, M, K) f32 ADC tables that the lookups
        tables[b, m, codes[b, x, m]] reach, for codes (B, X, M) and an
        optional (B, X) mask of the lookups made: the sectors they touch."""
        b, _, m = codes.shape
        off = ((torch.arange(b, device=dev)[:, None, None] * m
                + torch.arange(m, device=dev)) * k + codes.long()) * 4
        return sector_bytes(off if valid is None else off[valid])

    # each kernel's launch counter: (wrapper, attribute)
    counters = {"pq_adc": (pq_adc, "launches"),
                "pq_adc_rowwise": (pq_adc_rowwise, "launches"),
                "beam_hops": (beam_hops, "launches"),
                "beam_hops_l2": (beam_hops, "l2_launches")}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    # ---- 1. card ---------------------------------------------------------
    card = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card} | torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, nvcc "
        f"{_build.build_info.get('seconds', 0.0):.2f} s -> "
        f"{_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip().removeprefix("ptxas info    : "))

    # ---- 3. kernels against their plain versions --------------------------
    def call_ms(fn, iters=50, warmup=5) -> float:
        """Median ms per call on the stream: a pair of CUDA events around
        each of `iters` calls issued back to back, so the host's dispatch
        counts wherever it is slower than the card.  L2 stays warm, as
        the serving loop finds its tables and the 16 MB of codes."""
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def device_ms(fn, iters=20):
        """ms per call that the card spends running kernels, from the
        profiler's CUDA activity (gaps between launches excluded), and
        the kernels' names; (None, []) if it saw no device time."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        avgs = [a for a in prof.key_averages() if a.self_device_time_total > 0]
        us = sum(a.self_device_time_total for a in avgs)
        return (us / 1e3 / iters if us > 0 else None), [a.key for a in avgs]

    def timed(fn, iters=50, dev_iters=20):
        dms, names = device_ms(fn, dev_iters)
        return dict(call=call_ms(fn, iters), device=dms, names=names)

    def same(name, got, want, exact=False):
        """Integer outputs equal; float outputs within rtol = atol = 1e-5
        (the plain versions keep the kernels' summation order, so they
        are expected bitwise equal; the tolerance is the repo's bar), or
        bitwise where `exact`."""
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype.is_floating_point and exact:
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}[{i}]: outputs differ")
            elif g.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                           msg=lambda m: f"{name}[{i}]: {m}")
                fin = torch.isfinite(w)
                if not torch.equal(torch.isfinite(g), fin):
                    raise AssertionError(f"{name}[{i}]: inf pattern differs")
                if fin.any():
                    err = max(err, float((g[fin] - w[fin]).abs().max()))
            elif not torch.equal(g, w):
                raise AssertionError(f"{name}[{i}]: outputs differ")
        return err

    def tables_for(b, m, k, integer):
        t = rng.integers(0, 4, (b, m, k)) if integer else rng.random((b, m, k))
        return on_dev((t * (1 if integer else 16)).astype(np.float32))

    def seeded_pool(tables, codes, cands, n_entry, l):
        ed = pq_adc_ref(tables, codes[cands])
        sd, si = torch.sort(ed, dim=1, stable=True)
        b = tables.shape[0]
        return pool_merge(
            torch.full((b, l), -1, dtype=torch.int32, device=dev),
            torch.full((b, l), torch.inf, device=dev),
            torch.zeros((b, l), dtype=torch.bool, device=dev),
            cands[si[:, :n_entry]].to(torch.int32), sd[:, :n_entry], l)

    def random_graph(n, r, pad, dead):
        adj = torch.randint(0, n, (n, r), dtype=torch.int32, device=dev,
                            generator=gen)
        adj[torch.rand((n, r), device=dev, generator=gen) < pad] = -1
        adj[torch.rand(n, device=dev, generator=gen) < dead] = -1
        return adj

    def l2_pool(x, q, seeds, l):
        """A pool seeded by exact L2 with the (B, S) seed ids."""
        b = q.shape[0]
        return pool_merge(
            torch.full((b, l), -1, dtype=torch.int32, device=dev),
            torch.full((b, l), torch.inf, device=dev),
            torch.zeros((b, l), dtype=torch.bool, device=dev),
            seeds, l2_score(x, sq_norms(x), q, sq_norms(q), seeds), l)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {"pq_adc": 0.0, "pq_adc_rowwise": 0.0, "beam_hops": 0.0,
            "beam_hops_l2": 0.0}

    # ragged cases: odd B, N and R, integer tables, >48 KB tables (M = 64)
    for b, n, m, k, integer in ((37, 1000, 8, 64, True),
                                (5, 333, 64, 256, False),
                                (3, 70000, 16, 256, False)):
        t = tables_for(b, m, k, integer)
        c = on_dev(rng.integers(0, k, (n, m)).astype(np.uint8))
        errs["pq_adc"] = max(errs["pq_adc"], same(
            f"pq_adc B={b} N={n} M={m}", [pq_adc(t, c)], [pq_adc_ref(t, c)]))
    for b, r, m, k, integer in ((37, 5, 32, 256, True),
                                (3, 257, 64, 256, False)):
        t = tables_for(b, m, k, integer)
        c = on_dev(rng.integers(0, k, (b, r, m)).astype(np.uint8))
        errs["pq_adc_rowwise"] = max(errs["pq_adc_rowwise"], same(
            f"pq_adc_rowwise B={b} R={r} M={m}", [pq_adc_rowwise(t, c)],
            [pq_adc_rowwise_ref(t, c)]))
    # beam: padded graphs with dead ends, rows without seeds, hop budgets
    # past exhaustion, L not a warp multiple, and the limits L=1024, R=256
    for b, n, r, m, k, l, hops, integer in (
            (37, 5000, 24, 8, 64, 48, 40, True),
            (19, 300, 16, 8, 16, 300, 400, True),
            (8, 20000, 256, 64, 256, 1024, 8, False)):
        adj = random_graph(n, r, pad=0.2, dead=0.05)
        codes = on_dev(rng.integers(0, k, (n, m)).astype(np.uint8))
        t = tables_for(b, m, k, integer)
        cands = torch.arange(0, n, max(1, n // 64), device=dev)
        pool = seeded_pool(t, codes, cands, 4, l)
        pool[0][::5] = -1                        # rows with no seed at all
        pool[1][::5] = torch.inf
        got = beam_hops(adj, *pool, hops, tables=t, codes=codes)
        want = beam_hops_ref(adj, *pool, hops, tables=t, codes=codes)
        errs["beam_hops"] = max(errs["beam_hops"], same(
            f"beam_hops B={b} N={n} R={r} L={l} hops={hops}", got, want))
        log(f"kernel check beam_hops B={b} R={r} L={l} M={m} hops={hops}: ok "
            f"(done rows {int(got[7].sum())}/{b}, hops {got[3].min().item()}"
            f"..{got[3].max().item()})")
    # exact-L2 beam: the same ragged shapes, integer vectors (ties), a
    # GIST-wide D = 960 query row, and the limits L=1024, R=256
    for b, n, r, d, l, hops, integer in (
            (37, 5001, 23, 8, 48, 40, True),
            (19, 301, 15, 8, 301, 400, True),
            (7, 3000, 32, 960, 96, 30, False),
            (8, 20000, 256, 16, 1024, 8, False)):
        adj = random_graph(n, r, pad=0.2, dead=0.05)
        if integer:
            x = torch.randint(-3, 4, (n + b, d), device=dev, generator=gen)
        else:
            x = torch.randn((n + b, d), device=dev, generator=gen)
        x, q = x[:n].float().contiguous(), x[n:].float().contiguous()
        seeds = torch.arange(0, n, max(1, n // 64), device=dev,
                             dtype=torch.int32)[None, :].expand(b, -1)
        pool = l2_pool(x, q, seeds, l)
        pool[0][::5] = -1                        # rows with no seed at all
        pool[1][::5] = torch.inf
        kw = dict(x=x, n2=sq_norms(x), queries=q)
        got = beam_hops(adj, *pool, hops, **kw)
        want = beam_hops_ref(adj, *pool, hops, **kw)
        errs["beam_hops_l2"] = max(errs["beam_hops_l2"], same(
            f"beam_hops_l2 B={b} N={n} R={r} D={d} L={l} hops={hops}", got,
            want, exact=True))
        log(f"kernel check beam_hops_l2 B={b} R={r} L={l} D={d} hops={hops}:"
            f" ok (done rows {int(got[7].sum())}/{b}, hops "
            f"{got[3].min().item()}..{got[3].max().item()})")
    torch.cuda.synchronize()
    log("kernel checks (ragged): ok")

    # the main path's shapes: B=64, M=16, K=256, E=256, N=1M, R=32, L=64,
    # max_hops=32, on a random R=32 graph with 10% pads
    B, M, K, E, R, L, HOPS, NE = 64, 16, 256, 256, 32, 64, 32, 4
    n_main = args.n
    adj = random_graph(n_main, R, pad=0.1, dead=0.0)
    codes = on_dev(rng.integers(0, K, (n_main, M)).astype(np.uint8))
    tables = tables_for(B, M, K, False)
    cands = on_dev(np.linspace(0, n_main - 1, E, dtype=np.int64))
    ecodes = codes[cands].contiguous()
    rows = {}

    out = pq_adc(tables, ecodes)
    errs["pq_adc"] = max(errs["pq_adc"], same("pq_adc main", [out],
                                              [pq_adc_ref(tables, ecodes)]))
    w_adc = tables.permute(1, 2, 0).reshape(M * K, B).contiguous()
    i_adc = (ecodes.long() + torch.arange(M, device=dev) * K).contiguous()
    lib_out = F.embedding_bag(i_adc, w_adc, mode="sum").T
    log(f"  pq_adc yardstick embedding_bag max |diff| "
        f"{float((lib_out - out).abs().max()):.3g}")
    b_bytes = (table_bytes(ecodes[None].expand(B, E, M), K) + ecodes.numel()
               + B * E * 4)
    rows["pq_adc"] = dict(
        kernel=timed(lambda: pq_adc(tables, ecodes)),
        plain=timed(lambda: pq_adc_ref(tables, ecodes)),
        library=timed(lambda: F.embedding_bag(i_adc, w_adc, mode="sum")),
        bound=bound(b_bytes, B * E * M))

    nb = torch.randint(0, n_main, (B, R), device=dev, generator=gen)
    cand_codes = codes[nb].contiguous()                      # (B, R, M)
    out = pq_adc_rowwise(tables, cand_codes)
    errs["pq_adc_rowwise"] = max(errs["pq_adc_rowwise"], same(
        "pq_adc_rowwise main", [out], [pq_adc_rowwise_ref(tables, cand_codes)]))
    w_row = tables.reshape(B * M * K, 1)
    i_row = (cand_codes.long() + torch.arange(M, device=dev) * K
             + torch.arange(B, device=dev)[:, None, None] * (M * K)
             ).reshape(B * R, M).contiguous()
    b_bytes = table_bytes(cand_codes, K) + cand_codes.numel() + B * R * 4
    rows["pq_adc_rowwise"] = dict(
        kernel=timed(lambda: pq_adc_rowwise(tables, cand_codes)),
        plain=timed(lambda: pq_adc_rowwise_ref(tables, cand_codes)),
        library=timed(lambda: F.embedding_bag(i_row, w_row, mode="sum")),
        bound=bound(b_bytes, B * R * M))

    pool = seeded_pool(tables, codes, cands, NE, L)
    got = beam_hops(adj, *pool, HOPS, tables=tables, codes=codes)
    want = beam_hops_ref(adj, *pool, HOPS, tables=tables, codes=codes)
    errs["beam_hops"] = max(errs["beam_hops"], same("beam_hops main", got,
                                                    want))
    # what this run's data needs: the adjacency rows of the picked nodes,
    # the code rows of their valid neighbours and the table entries those
    # codes reach, each sector once; the pools in and out; the traces
    tid = got[4]
    picked = tid[tid >= 0].long()
    nbrs = adj[tid.clamp_min(0).long()].long()               # (B, HOPS, R)
    scored = ((tid >= 0)[:, :, None] & (nbrs >= 0)).reshape(B, HOPS * R)
    valid_nbrs = int(scored.sum())
    hop_total = int(got[3].sum())
    nbr_ids = nbrs.clamp_min(0).reshape(B, HOPS * R)[scored]
    b_bytes = (table_bytes(codes[nbrs.clamp_min(0)].reshape(B, HOPS * R, M),
                           K, scored)
               + sector_bytes(nbr_ids[:, None] * M
                              + torch.arange(M, device=dev))
               + sector_bytes((picked[:, None] * R
                               + torch.arange(R, device=dev)) * 4)
               + 2 * B * L * (4 + 4 + 1) + B * (4 + 4 + 1) + B * HOPS * 8)
    rows["beam_hops"] = dict(
        kernel=timed(lambda: beam_hops(adj, *pool, HOPS, tables=tables,
                                       codes=codes), iters=30),
        plain=timed(lambda: beam_hops_ref(adj, *pool, HOPS, tables=tables,
                                          codes=codes), iters=5, dev_iters=3),
        library=None,
        bound=bound(b_bytes, valid_nbrs * M))
    log(f"  beam_hops main: {hop_total} hops over {B} rows, "
        f"{valid_nbrs} valid neighbours scored")

    # the construction frontier's shapes (frontier_pools under "fused"):
    # B=256 build nodes as queries, L = ef + ef//2 = 96, 66 hops, one
    # shared entry (the medoid), on a random R=32, d=128 graph of --n nodes
    B2, R2, D2, L2, HOPS2 = 256, 32, 128, 96, 66
    del adj
    adj = random_graph(n_main, R2, pad=0.1, dead=0.0)
    x = torch.randn((n_main, D2), device=dev, generator=gen)
    n2 = sq_norms(x)
    q = x[torch.randperm(n_main, device=dev, generator=gen)[:B2]]
    med = medoid(x)
    seeds = torch.full((B2, 1), med, dtype=torch.int32, device=dev)
    pool = l2_pool(x, q, seeds, L2)
    kw = dict(x=x, n2=n2, queries=q)
    got = beam_hops(adj, *pool, HOPS2, **kw)
    want = beam_hops_ref(adj, *pool, HOPS2, **kw)
    errs["beam_hops_l2"] = max(errs["beam_hops_l2"], same(
        "beam_hops_l2 main", got, want, exact=True))
    # what this run's data needs: the adjacency rows of the picked nodes,
    # the vector rows (D*4 = 512 bytes, 16 whole sectors each) and norms of
    # their valid neighbours, each sector once; the queries and their
    # norms; the pools in and out; the traces
    tid = got[4]
    picked = tid[tid >= 0].long()
    nbrs = adj[tid.clamp_min(0).long()].long()               # (B, HOPS, R)
    scored = ((tid >= 0)[:, :, None] & (nbrs >= 0)).reshape(B2, HOPS2 * R2)
    valid_l2 = int(scored.sum())
    nbr_ids = nbrs.reshape(B2, HOPS2 * R2)[scored]
    b_bytes = (int(torch.unique(nbr_ids).numel()) * D2 * 4
               + sector_bytes(nbr_ids * 4)
               + sector_bytes((picked[:, None] * R2
                               + torch.arange(R2, device=dev)) * 4)
               + B2 * (D2 + 1) * 4
               + 2 * B2 * L2 * (4 + 4 + 1) + B2 * (4 + 4 + 1)
               + B2 * HOPS2 * 8)
    rows["beam_hops_l2"] = dict(
        kernel=timed(lambda: beam_hops(adj, *pool, HOPS2, **kw), iters=30),
        plain=timed(lambda: beam_hops_ref(adj, *pool, HOPS2, **kw), iters=3,
                    dev_iters=2),
        library=None,
        bound=bound(b_bytes, valid_l2 * 2 * D2))
    log(f"  beam_hops_l2 main: {int(got[3].sum())} hops over {B2} rows, "
        f"{valid_l2} valid neighbours scored")
    del x, n2, q

    def fmt(t):
        if t is None:
            return "none"
        dev_t = ("not seen" if t["device"] is None
                 else f"{t['device']:.4f} ms")
        return f"device {dev_t}, per call {t['call']:.4f} ms"
    for name, row in rows.items():
        log(f"kernel {name}: {fmt(row['kernel'])} | plain {fmt(row['plain'])}"
            f" | library {fmt(row['library'])} | bound "
            f"{row['bound'][0] * 1e3:.3f} us ({row['bound'][1]}) | max|err| "
            f"{errs[name]:.3g} | {card}")
        log(f"  device kernels seen: {row['kernel']['names']}")
    del adj, codes, nb, cand_codes, pool, got, want, kw
    torch.cuda.empty_cache()

    # ---- 4. main path at full size ----------------------------------------
    t0 = time.perf_counter()
    ds = paper_dataset("sift-like", n=n_main, nq=1024, seed=SEED, device=dev)
    t_data = time.perf_counter() - t0
    x = on_dev(ds.base)
    t0 = time.perf_counter()
    adj = knn_graph(x, R)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec = train_pq(x, m=_pick_pq_m(x.shape[1]), k=K, seed=SEED)
    codes = codec.encode(x)
    torch.cuda.synchronize()
    t_pq = time.perf_counter() - t0
    log(f"set-up: data+gt {t_data:.2f} s | kNN graph R={R} {t_graph:.2f} s | "
        f"PQ M={codec.m} K={codec.k} train+encode {t_pq:.2f} s | N={n_main} "
        f"d={x.shape[1]} | {card}")
    if adj.shape != (n_main, R) or (adj < 0).any():
        raise AssertionError("the kNN graph is not a full (N, R) graph")
    arrays = dict(x=x, adj=adj, codes=codes, codebooks=codec.codebooks,
                  entry_cands=np.linspace(0, n_main - 1, E, dtype=np.int64))
    queries = ds.queries
    results, launches = {}, {}
    for backend in ("auto", "cuda", "ref"):
        eng = BatchedANNEngine(arrays, EngineConfig(
            l=L, max_hops=HOPS, n_entry=NE, backend=backend),
            device=dev)
        reset_counts()
        ids, dists, times = [], [], []
        t_all = time.perf_counter()
        for s in range(0, len(queries), B):
            t0 = time.perf_counter()
            i, d = eng.search_batch(queries[s:s + B], 10)
            times.append((time.perf_counter() - t0) * 1e3)
            ids.append(i)
            dists.append(d)
        t_all = time.perf_counter() - t_all
        launches[backend] = read_counts()
        results[backend] = (np.concatenate(ids), np.concatenate(dists))
        med = statistics.median(times)
        # the card's busy time per batch, profiled over all the batches
        # again; the profiler slows the host, so the share is taken of the
        # unprofiled median batch
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(0, len(queries), B):
                eng.search_batch(queries[s:s + B], 10)
            wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        busy = sum(a.self_device_time_total for a in avgs) / 1e3 / len(times)
        log(f"  {backend}: card busy {busy:.4f} ms per batch (torch.profiler"
            f" CUDA activity over all {len(times)} batches, "
            f"{sum(a.count for a in avgs) / len(times):.1f} kernel runs per "
            f"batch) = {busy / med:.2%} of the unprofiled per-batch median; "
            f"profiled wall {wall * 1e3 / len(times):.3f} ms per batch")
        log(f"serve {backend}: recall@10 "
            f"{recall_at_k(results[backend][0], ds.gt, 10):.4f} | per-batch "
            f"median {med:.3f} ms (B={B}) | QPS {B / med * 1e3:.1f} "
            f"(median), {len(queries) / t_all:.1f} (all {len(times)} batches)"
            f" | launches {launches[backend]} | {card}")
    n_batches = len(queries) // B + (len(queries) % B > 0)
    if launches["auto"]["beam_hops"] != n_batches:
        raise AssertionError(f"auto: beam_hops launched "
                             f"{launches['auto']['beam_hops']} times, "
                             f"expected {n_batches}")
    if launches["cuda"]["pq_adc_rowwise"] != HOPS * n_batches:
        raise AssertionError(f"cuda: pq_adc_rowwise launched "
                             f"{launches['cuda']['pq_adc_rowwise']} times, "
                             f"expected {HOPS * n_batches}")
    if min(launches["auto"]["pq_adc"], launches["cuda"]["pq_adc"]) < 1:
        raise AssertionError("pq_adc was not launched on the main path")
    if any(launches["ref"].values()):
        raise AssertionError(f"ref launched kernels: {launches['ref']}")
    ref_ids, ref_d = results["ref"]
    for backend in ("auto", "cuda"):
        np.testing.assert_array_equal(results[backend][0], ref_ids,
                                      err_msg=backend)
        np.testing.assert_allclose(results[backend][1], ref_d, rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
    if (ref_ids < 0).any():
        raise AssertionError("a query returned fewer than 10 ids")
    q_dev = on_dev(queries)
    exact = ((x[on_dev(ref_ids)] - q_dev[:, None, :]) ** 2).sum(-1)
    torch.testing.assert_close(on_dev(ref_d), exact, rtol=1e-4, atol=0.0)
    if (np.diff(ref_d, axis=1) < 0).any():
        raise AssertionError("returned distances are not ascending")
    log("main path: auto == cuda == ref (ids equal, dists within 1e-5); "
        "dists exact to 1e-4 relative")

    eng = BatchedANNEngine(arrays, EngineConfig(l=L, max_hops=HOPS,
                                                n_entry=NE), device=dev)
    dead = set(ref_ids[:B, :3].ravel().tolist())
    eng.set_tombstones(sorted(dead))
    for backend in ("auto", "cuda"):
        eng.config = EngineConfig(l=L, max_hops=HOPS, n_entry=NE,
                                  backend=backend)
        i, _ = eng.search_batch(queries[:B], 10)
        if set(i.ravel().tolist()) & dead:
            raise AssertionError(f"{backend}: a tombstoned id came back")
    log(f"tombstones: {len(dead)} ids masked, none returned | peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | "
        f"resident index {eng.memory_bytes() / 2 ** 30:.3f} GiB")
    del eng, arrays, x, adj, codes, codec, ds, exact
    torch.cuda.empty_cache()

    # ---- 5. construction path: build a BAMG on the card, serve it ----------
    n_build = args.build_n
    t0 = time.perf_counter()
    ds = paper_dataset("sift-like", n=n_build, nq=1024, seed=SEED, device=dev)
    t_data = time.perf_counter() - t0
    xb, queries = ds.base, ds.queries
    # BAMGParams' defaults: alpha 3, beta 1.05, R 32, l_build 64, knn_k 32,
    # gamma 256, the largest block capacity for R at 4 KB
    R5, capacity = 32, max_capacity_for(32)
    builder = GraphBuilder(device=dev)
    if builder.config != BuildConfig(backend="batched",
                                     frontier_backend="fused"):
        raise AssertionError(f"GraphBuilder's default is {builder.config}")
    reset_counts()
    t0 = time.perf_counter()
    graph = builder.build_bamg(xb, capacity, alpha=3, beta=1.05, r=R5,
                               l_build=64, knn_k=32, seed=SEED, max_degree=R5)
    t_graph = time.perf_counter() - t0
    build_launches = read_counts()
    chunks = -(-n_build // 256)
    if build_launches != {"pq_adc": 0, "pq_adc_rowwise": 0, "beam_hops": 0,
                          "beam_hops_l2": chunks}:
        raise AssertionError(f"build launches {build_launches}: expected "
                             f"beam_hops_l2 = ceil(N / 256) = {chunks} and "
                             f"no other kernel")
    xt = on_dev(xb)
    t0 = time.perf_counter()
    codec = train_pq(xt, m=_pick_pq_m(xt.shape[1]), k=K, seed=SEED)
    codes = codec.encode(xt)
    torch.cuda.synchronize()
    t_pq = time.perf_counter() - t0
    t0 = time.perf_counter()
    nav = build_navgraph(xb, graph, alpha=3, beta=1.05, gamma=256,
                         capacity=capacity, seed=SEED, device=dev)
    t_nav = time.perf_counter() - t0
    arrays = batch_arrays(xb, graph, codes, codec.codebooks, nav)
    stages = dict(builder.timings, pq=t_pq, nav=t_nav)
    log(f"build: N={n_build} d={xb.shape[1]} R={R5} capacity={capacity} | "
        f"data+gt {t_data:.2f} s | graph {t_graph:.2f} s | stages (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f" | beam_hops_l2 launches {build_launches['beam_hops_l2']} | "
        f"{card}")
    deg = degree_stats(graph.adj, graph.blocks)
    log(f"  BAMG: mean out-degree {deg['total']:.3f} (intra {deg['intra']:.3f}"
        f", cross {deg['cross']:.3f}), intra-block edge share "
        f"{intra_edge_fraction(graph.adj, graph.blocks):.4f}, "
        f"{graph.members.shape[0]} blocks, nav layers "
        f"{[len(layer.vids) for layer in nav.layers]}, entry cands "
        f"{len(arrays['entry_cands'])}")

    # the frontier stage again, on the build's own kNN graph and entry:
    # timed over every node, the kernel's pools against the plain
    # version's on every 8th node, then one profiled run over every node
    f_arrays = frontier_arrays(xb, builder.knn, dev)
    def frontier(nodes, backend):
        return frontier_pools(xb, builder.knn, [graph.entry], nodes, ef=64,
                              device_arrays=f_arrays, backend=backend)
    nodes = np.arange(n_build)
    t0 = time.perf_counter()
    frontier(nodes, "fused")
    t_front = time.perf_counter() - t0
    got = frontier(nodes[::8], "fused")
    want = frontier(nodes[::8], "fused_ref")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        frontier(nodes, "fused")
        torch.cuda.synchronize()
    dev_us = {a.key: a.self_device_time_total for a in prof.key_averages()
              if a.self_device_time_total > 0}
    l2_ms = sum(v for k, v in dev_us.items() if "beam_hops_l2" in k) / 1e3
    other_ms = sum(dev_us.values()) / 1e3 - l2_ms
    n_other = sum("beam_hops_l2" not in k for k in dev_us)
    split = (f"L2 kernel {l2_ms:.3f} ms device over {chunks} launches "
             f"({l2_ms / chunks:.4f} ms each), other device {other_ms:.3f} "
             f"ms ({n_other} kernel kinds), host and idle "
             f"{t_front * 1e3 - l2_ms - other_ms:.1f} ms" if dev_us else
             "the profiler saw no device time")
    log(f"  frontier on the build's kNN graph and entry: fused == fused_ref "
        f"on {len(want[0])} of {n_build} nodes (ids and dists bitwise) | "
        f"stage rerun {t_front * 1e3:.1f} ms wall | {split} | {card}")

    # serve the BAMG, then the exact kNN graph of the same corpus
    served = {}
    stand_in = dict(arrays, adj=knn_graph(xt, R5),
                    entry_cands=np.linspace(0, n_build - 1, E, dtype=np.int64))
    for name, arr, backend in (("bamg", arrays, "auto"), ("bamg", arrays, "ref"),
                               ("knn", stand_in, "auto")):
        eng = BatchedANNEngine(arr, EngineConfig(
            l=L, max_hops=HOPS, n_entry=NE, backend=backend), device=dev)
        reset_counts()
        ids, dists, times = [], [], []
        for s0 in range(0, len(queries), B):
            t0 = time.perf_counter()
            i, d = eng.search_batch(queries[s0:s0 + B], 10)
            times.append((time.perf_counter() - t0) * 1e3)
            ids.append(i)
            dists.append(d)
        served[name, backend] = (np.concatenate(ids), np.concatenate(dists))
        med_ms = statistics.median(times)
        log(f"serve {name} {backend}: recall@10 "
            f"{recall_at_k(served[name, backend][0], ds.gt, 10):.4f} | "
            f"per-batch median {med_ms:.3f} ms (B={B}) | QPS "
            f"{B / med_ms * 1e3:.1f} | launches {read_counts()} | {card}")
        if backend == "auto" and read_counts()["beam_hops"] != len(times):
            raise AssertionError(f"{name}: beam_hops launched "
                                 f"{read_counts()['beam_hops']} times")
    ids, dists = served["bamg", "ref"]
    np.testing.assert_array_equal(served["bamg", "auto"][0], ids)
    np.testing.assert_allclose(served["bamg", "auto"][1], dists, rtol=1e-5,
                               atol=1e-5)
    if (ids < 0).any():
        raise AssertionError("a query returned fewer than 10 ids")
    exact = ((xt[on_dev(ids)] - on_dev(queries)[:, None, :]) ** 2).sum(-1)
    torch.testing.assert_close(on_dev(dists), exact, rtol=1e-4, atol=0.0)
    eng = BatchedANNEngine(arrays, EngineConfig(l=L, max_hops=HOPS,
                                                n_entry=NE), device=dev)
    dead = set(ids[:B, :3].ravel().tolist())
    eng.set_tombstones(sorted(dead))
    if set(eng.search_batch(queries[:B], 10)[0].ravel().tolist()) & dead:
        raise AssertionError("BAMG: a tombstoned id came back")
    log("construction path: auto == ref on the built BAMG (ids equal, dists "
        f"within 1e-5, exact to 1e-4 relative); {len(dead)} tombstoned ids "
        "never returned")

    # ---- result lines -------------------------------------------------------
    meta = {
        "pq_adc": ("src/repro_torch/csrc/pq_adc.cu",
                   "src/repro/kernels/pq_adc/kernel.py:91"),
        "pq_adc_rowwise": ("src/repro_torch/csrc/pq_adc.cu",
                           "src/repro/kernels/pq_adc/kernel.py:61"),
        "beam_hops": ("src/repro_torch/csrc/beam_hops_adc.cu",
                      "src/repro/kernels/beam_fused/kernel.py:442"),
        "beam_hops_l2": ("src/repro_torch/csrc/beam_hops_l2.cu",
                         "src/repro/kernels/beam_fused/kernel.py:472"),
    }
    also = {"beam_hops": "src/repro/kernels/beam_fused/kernel.py:511",
            "beam_hops_l2": "src/repro/kernels/beam_fused/kernel.py:546"}
    # launches on the main paths: the query path's auto and cuda runs, and
    # the construction path's build for the exact-L2 kernel
    path_launches = {k: launches["auto"][k] + launches["cuda"][k]
                     for k in counters}
    path_launches["beam_hops_l2"] = build_launches["beam_hops_l2"]
    def on_card(t):
        if t is None:
            return None
        return t["device"] if t["device"] is not None else t["call"]
    seen = all(r["kernel"]["device"] is not None for r in rows.values())
    timing = ("ms: the card's kernel time per call (torch.profiler CUDA "
              "activity); call_ms: median of CUDA events around each of "
              "back-to-back calls" if seen else "ms and call_ms: median of "
              "CUDA events around each of back-to-back calls (the profiler "
              "saw no device time)")
    kernels = []
    for name, row in rows.items():
        entry = {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": path_launches[name],
            "max_abs_err": errs[name], "ms": on_card(row["kernel"]),
            "plain_ms": on_card(row["plain"]), "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": on_card(row["library"]),
            "call_ms": row["kernel"]["call"],
            "plain_call_ms": row["plain"]["call"],
            "library_call_ms": (None if row["library"] is None
                                else row["library"]["call"]),
            "timing": timing}
        if name in also:
            entry["also_replaces"] = also[name]
        kernels.append(entry)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
