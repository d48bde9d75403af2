#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched BAMG query and construction paths,
DIN serving and OLMo-1B decode serving on one NVIDIA GPU.

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
   D = 960 query rows); for the L2 top-k kernel, bitwise, odd B, N not a
   multiple of its tile, k = 1, k = N and k > N (+inf / -1), integer data
   (ties), D = 1 and 960, bf16 inputs and a base of identical rows, each
   call making the launches `plan` counts, then DIN's retrieval shapes
   (B = 1 and 64, N = 1,048,576, D = 18, k = 1024) and the kernel bench's
   (B = 8, N = 100,000, D = 128, k = 100); for flash-decode, within atol
   1e-5 of its plain version, the reference's sweep, G = 1, 4 and 32,
   Dh = 16, 120, 128 and 256, ragged S, cache_len ragged, 1, S, 0 (zeros)
   and > S (clamped), f32 and bf16 caches, then one decode_32k layer
   (B = 8, H = Hkv = 16, Dh = 128, S = 32,768, bf16), the kernel bench's
   shape (B = 4, H = 32, Hkv = 8, S = 8,192) and one long_500k layer
   (B = 1, S = 524,288); times by CUDA events beside the plain version, a
   PyTorch yardstick where one exists, and the least time the card could
   take (`bound_ms`); for flash-decode also the bytes of its bound over
   its time (GB/s) and their share of the card's 3.35 TB/s;
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
   stage's time is logged;
6. DIN serving at `din_cfg.model_config()` (embed 18, history 100,
   attention MLP 80-40, MLP 200-80, 1,048,576 items, rerank_k 1,024),
   parameters from the port's `init_params` with a seeded generator on the
   card: `serve_p99` (16 batches of 512 rows from `din_batch`; the first
   against the same model on the CPU), `serve_bulk` (262,144 rows in calls
   of 8,192), and `retrieval_cand` (64 calls of B = 1 and one of B = 64
   against all 1,048,576 items, k = 100) under "auto" (the L2 top-k
   kernel) and "ref" (plain PyTorch): shortlists and final items must be
   equal, the kernel must have launched under "auto" only, and each call's
   time is split into shortlist and re-rank;
7. OLMo-1B decode serving at `olmo_1b.model_config()` (16 layers, d =
   2048, 16 heads of 128, d_ff 8192, vocab 50,304), parameters from the
   port's `init_lm_params` with a seeded generator on the card, held in
   bf16: B = 8 prompts of 1,024 tokens from `lm_batch` prefilled into a
   cache of 1,024 + 32, then 32 greedy `decode_step`s under "auto" (the
   flash-decode kernel, 2 launches per layer) and "ref" (plain PyTorch,
   fed the same tokens): logits within 0.25 and greedy tokens equal
   wherever ref's top-2 margin exceeds that; the same path in f32 for 4
   steps, each token the argmax of a fresh teacher-forced prefill where
   its margin exceeds 1e-3; then decode_32k at B = 8 (the cell's 128 would
   need a 550 GB cache): a 32,768-slot bf16 cache filled N(0, 1) below
   position 32,767 and 16 steps there under both backends, with the step
   time, tokens/s, the card's busy share and the kernel's part of it;
   then the same 16 steps once more as an f32 oracle (the bf16 weights
   cast up, the plain version, the same cache, the kernel run's tokens),
   with max and mean |auto - oracle| and |ref - oracle|.

The last lines are the card's nvidia-smi line, one JSON object with every
kernel's numbers, and `{"ok": true, "device": {...}}`.  The script exits
nonzero, printing no result, where no CUDA device is present or where it
stands outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import copy
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


def din_serving(dev, card: str, reset_counts, read_counts) -> int:
    """Phase 6: DIN's serving shapes at its full published width; returns
    the L2 top-k kernel's launches on the retrieval path under "auto"."""
    import numpy as np
    import torch

    from repro_torch.configs import din_cfg
    from repro_torch.data.synthetic import din_batch
    from repro_torch.kernels.l2_topk.ops import plan
    from repro_torch.models.recsys.din import BATCH_KEYS, init_params

    t_phase = time.perf_counter()
    cfg = din_cfg.model_config(reduced=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    log(f"DIN: {cfg} | init_params on the card {time.perf_counter() - t0:.2f}"
        f" s | item table {model.item_emb.numel() * 4 / 1e6:.1f} MB")

    def batch(step, b):
        arrays = din_batch(step, b, cfg.seq_len, cfg.n_items, cfg.n_cates,
                           seed=SEED)
        return dict(zip(BATCH_KEYS, arrays[:5]))

    def synced(fn):
        """(fn(), host ms) with the card synchronised on both sides."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def busy(fn, calls: int) -> tuple[float, float, float]:
        """Card time per call that torch.profiler's CUDA activity sees over
        `calls` calls run by fn(), the part of it in the l2_topk kernels,
        and kernel runs per call."""
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avgs = [a for a in prof.key_averages() if a.self_device_time_total > 0]
        return (sum(a.self_device_time_total for a in avgs) / 1e3 / calls,
                sum(a.self_device_time_total for a in avgs
                    if "l2_topk" in a.key) / 1e3 / calls,
                sum(a.count for a in avgs) / calls)

    # serve_p99: 16 batches of 512; the first also on a CPU copy of the
    # model (cuBLAS and the CPU's BLAS sum in other orders: rtol 1e-4,
    # atol 1e-5)
    p99 = [batch(s, 512) for s in range(16)]
    model.forward_scores(p99[0])                              # warm-up
    times = []
    for b in p99:
        scores, ms = synced(lambda: model.forward_scores(b))
        times.append(ms)
        if scores.shape != (512,) or not torch.isfinite(scores).all():
            raise AssertionError("serve_p99: scores not finite of shape (512,)")
    on_cpu = copy.deepcopy(model).cpu().forward_scores(p99[0])
    got = model.forward_scores(p99[0]).cpu()
    torch.testing.assert_close(got, on_cpu, rtol=1e-4, atol=1e-5)
    med = statistics.median(times)
    dev_ms, _, runs = busy(lambda: [model.forward_scores(b) for b in p99], 16)
    log(f"  serve_p99: card busy {dev_ms:.4f} ms per batch ({runs:.1f} "
        f"kernel runs) = {dev_ms / med:.2%} of the per-batch median")
    log(f"serve_p99: B=512 x 16 batches | per-batch median {med:.3f} ms, "
        f"min {min(times):.3f}, max {max(times):.3f} | {512 / med * 1e3:.1f} "
        f"rows/s (median), {512 * 16 / sum(times) * 1e3:.1f} (all) | card vs "
        f"CPU max |diff| {float((got - on_cpu).abs().max()):.3g} | {card}")

    # serve_bulk: 262,144 rows in 32 calls of 8,192 (one call would hold
    # 32 times a call's activations at once: its attention features alone,
    # 262,144 x 100 x 144 f32, are 15.1 GB)
    bulk = [batch(1000 + s, 8192) for s in range(32)]
    model.forward_scores(bulk[0])                             # warm-up
    torch.cuda.reset_peak_memory_stats()

    def run_bulk():
        return [model.forward_scores(b) for b in bulk]
    outs, ms = synced(run_bulk)
    if not all(o.shape == (8192,) and torch.isfinite(o).all() for o in outs):
        raise AssertionError("serve_bulk: scores not finite")
    dev_ms, _, runs = busy(run_bulk, 32)
    log(f"  serve_bulk: card busy {dev_ms:.4f} ms per call of 8192 rows "
        f"({runs:.1f} kernel runs) = {dev_ms * 32 / ms:.2%} of the wall time")
    log(f"serve_bulk: 262144 rows in 32 calls of 8192 | {ms:.1f} ms | "
        f"{262144 / ms * 1e3:.1f} rows/s | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {card}")
    del outs, bulk

    # retrieval_cand: 64 calls of B = 1 and one of B = 64 against all
    # 2^20 items, k = 100 (the reference's cell), under the kernel and the
    # plain version
    n_cand, k = cfg.n_items, min(100, cfg.rerank_k)
    requests = [batch(2000 + i, 1) for i in range(64)] + [batch(3000, 64)]
    for b in requests[:2]:                                    # warm-up
        model.rerank(b, model.shortlist(b, n_cand), k)
    out, launches, call_med = {}, {}, {}
    for backend in ("auto", "ref"):
        reset_counts()
        res, t_short, t_rerank = [], [], []
        for b in requests:
            short, ms_s = synced(lambda: model.shortlist(b, n_cand, backend))
            (scores, ids), ms_r = synced(lambda: model.rerank(b, short, k))
            res.append((short, scores, ids))
            t_short.append(ms_s)
            t_rerank.append(ms_r)
        launches[backend] = read_counts()
        out[backend] = res
        call_med[backend] = statistics.median(
            s + r for s, r in zip(t_short[:64], t_rerank[:64]))
        log(f"retrieval_cand {backend}: B=1 per-call median "
            f"{call_med[backend]:.3f} ms (shortlist "
            f"{statistics.median(t_short[:64]):.3f}, re-rank "
            f"{statistics.median(t_rerank[:64]):.3f}) | B=64 one call "
            f"{t_short[64] + t_rerank[64]:.3f} ms (shortlist "
            f"{t_short[64]:.3f}, re-rank {t_rerank[64]:.3f}) | launches "
            f"{launches[backend]} | {card}")
    dev_ms, l2_ms, runs = busy(lambda: [
        model.rerank(b, model.shortlist(b, n_cand), k)
        for b in requests[:64]], 64)
    log(f"  retrieval_cand auto, B=1: card busy {dev_ms:.4f} ms per call "
        f"({runs:.1f} kernel runs; l2_topk {l2_ms:.4f} ms) = "
        f"{dev_ms / call_med['auto']:.2%} of the per-call median")
    per_call = [plan(len(b["hist_len"]), n_cand, cfg.embed_dim,
                     min(cfg.rerank_k, n_cand)).launches for b in requests]
    want = {name: 0 for name in launches["auto"]}
    if launches["ref"] != want:
        raise AssertionError(f"ref launched kernels: {launches['ref']}")
    if launches["auto"] != dict(want, l2_topk=sum(per_call)):
        raise AssertionError(f"auto launches {launches['auto']}: expected "
                             f"l2_topk = {sum(per_call)} only")
    err = 0.0
    for (s_a, sc_a, i_a), (s_r, sc_r, i_r) in zip(out["auto"], out["ref"]):
        if not (torch.equal(s_a, s_r) and torch.equal(i_a, i_r)):
            raise AssertionError("retrieval_cand: auto and ref differ")
        torch.testing.assert_close(sc_a, sc_r, rtol=1e-6, atol=1e-7)
        err = max(err, float((sc_a - sc_r).abs().max()))
        if (not torch.isfinite(sc_a).all() or (sc_a.diff(dim=1) > 0).any()
                or ((i_a < 0) | (i_a >= n_cand)).any()):
            raise AssertionError("retrieval_cand: bad scores or ids")
    # the cascade's entry point gives the split calls' answer, and its
    # scores are the forward scores of (user, returned item)
    big = requests[64]
    scores, ids = model.retrieval_step(big, n_cand, k=k)
    if not torch.equal(ids, out["auto"][64][2]):
        raise AssertionError("retrieval_step differs from its stages")
    rows = {key: np.repeat(v, k, axis=0) for key, v in big.items()}
    rows["target_item"] = ids.cpu().numpy().reshape(-1).astype(np.int32)
    rows["target_cate"] = rows["target_item"] % cfg.n_cates
    torch.testing.assert_close(model.forward_scores(rows).reshape(64, k),
                               scores, rtol=1e-5, atol=1e-6)
    log(f"retrieval_cand: auto == ref on all {len(requests)} calls "
        f"(shortlists and items equal, scores max |diff| {err:.3g}); "
        f"l2_topk launched {launches['auto']['l2_topk']} times under auto "
        f"({per_call[0]} per call at B=1, {per_call[-1]} at B=64), 0 under "
        f"ref | phase 6 took "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")
    return launches["auto"]["l2_topk"]


def lm_serving(dev, card, reset_counts, read_counts) -> int:
    """Phase 7: OLMo-1B decode serving at its full config; returns the
    flash_decode kernel's launches on the bf16 `auto` runs (the requests
    and decode_32k)."""
    import dataclasses

    import torch

    from repro_torch.configs import olmo_1b
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.transformer import (compute_cast, decode_step,
                                                init_cache, init_lm_params,
                                                serve_prefill)

    t_phase = time.perf_counter()
    cfg = olmo_1b.model_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params32 = init_lm_params(cfg, gen, device=dev)
    params = compute_cast(params32, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"LM: {cfg.name} {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads} "
        f"Hkv={cfg.n_kv_heads} Dh={cfg.d_head} ff={cfg.d_ff} V={cfg.vocab} "
        f"{cfg.norm} {cfg.activation} | {cfg.n_params()} parameters, "
        f"{cfg.n_params() * 2 / 1e9:.3f} GB in bf16 | init_lm_params on the "
        f"card {time.perf_counter() - t0:.2f} s")
    n_layers = cfg.n_layers
    # bf16 logits (std about 1, the largest about 5): the kernel and the
    # plain version differ in the f32 attention sums at about 1e-7, and 16
    # bf16 layers of random weights spread that over most logits at a few
    # bf16 ulps (2^-5 at 4); a fault in the kernel moves them by O(1).
    # 0.25 is a quarter of the logits' spread and 8 ulps at the largest
    tol = 0.25

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def decode(p, c, caches, logits, positions, n, backend, feed=()):
        """n greedy decode steps from `logits`, step i at positions(i) and
        fed feed[i] where given (not None), else the last logits' argmax;
        returns (per-step logits (n, B, V) f32, tokens, per-step ms)."""
        steps, toks, times = [], [], []
        for i in range(n):
            tok = (feed[i] if i < len(feed) and feed[i] is not None
                   else logits.argmax(-1)[:, None].int())
            pos = positions(i)
            (logits, caches), ms = synced(lambda: decode_step(
                p, c, tok, pos, caches, backend=backend))
            steps.append(logits.float())
            toks.append(tok)
            times.append(ms)
        return torch.stack(steps), toks, times

    def agree(name, got, want, tol):
        """Logits within `tol`; argmax equal wherever `want`'s top-2
        margin exceeds it.  Returns a log fragment: max and mean |diff|,
        the share of logits that differ, positions checked."""
        d = (got - want).abs()
        if float(d.max()) > tol:
            raise AssertionError(f"{name}: logits differ by {float(d.max())}"
                                 f" > {tol}")
        top2 = want.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > tol
        if not torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]):
            raise AssertionError(f"{name}: greedy tokens differ")
        share = float((d > 0).float().mean())
        return (f"logits max |auto - ref| {float(d.max()):.4g} (tol {tol}), "
                f"mean {float(d.mean()):.4g}, {share:.2%} of logits differ, "
                f"max |ref logit| "
                f"{float(want.abs().max()):.4g}; greedy tokens equal at "
                f"{int(sure.sum())} of {sure.numel()} positions with margin "
                f"> tol")

    def busy(step, n=8):
        """Card time per step that torch.profiler's CUDA activity sees over
        n calls of step(i), the part of it in flash_decode, and kernel runs
        per step."""
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
        avgs = [a for a in prof.key_averages() if a.self_device_time_total > 0]
        return (sum(a.self_device_time_total for a in avgs) / 1e3 / n,
                sum(a.self_device_time_total for a in avgs
                    if "flash_decode" in a.key) / 1e3 / n,
                sum(a.count for a in avgs) / n)

    def busy_log(name, step, med):
        dev_ms, fd_ms, runs = busy(step)
        log(f"  {name} auto: card busy {dev_ms:.4f} ms per step ({runs:.1f} "
            f"kernel runs; flash_decode {fd_ms:.4f} ms, "
            f"{fd_ms / dev_ms if dev_ms else 0:.2%} of busy) = "
            f"{dev_ms / med:.2%} of the per-step median")

    def expect(launches, n_fd):
        want = {name: 0 for name in launches}
        want["flash_decode"] = n_fd
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")

    # requests: B = 8 prompts of 1,024 tokens, a cache of 1,024 + 32, then
    # 32 greedy steps under the kernel and under the plain version (which
    # is fed the kernel run's tokens)
    b, p_len, n_new = 8, 1024, 32
    prompt = torch.from_numpy(lm_batch(0, b, p_len, cfg.vocab,
                                       seed=SEED)[0]).to(dev)
    serve_prefill(params, cfg, prompt[:, :64])                   # warm-up
    (logits0, (ck, cv), lens), ms_pre = synced(
        lambda: serve_prefill(params, cfg, prompt))
    ck0, cv0, _ = init_cache(cfg, b, p_len + n_new, device=dev)
    ck0[:, :, :p_len], cv0[:, :, :p_len] = ck, cv
    del ck, cv
    runs, launches = {}, {}
    for backend in ("auto", "ref"):
        caches = (ck0.clone(), cv0.clone(), lens)
        reset_counts()
        runs[backend] = decode(params, cfg, caches, logits0,
                               lambda i: torch.full((b,), p_len + i,
                                                    device=dev),
                               n_new, backend,
                               () if backend == "auto" else runs["auto"][1])
        launches[backend] = read_counts()
        del caches
    expect(launches["auto"], n_new * n_layers * 2)
    expect(launches["ref"], 0)
    agreed = agree("requests", runs["auto"][0], runs["ref"][0], tol)
    med = {k: statistics.median(r[2]) for k, r in runs.items()}
    # the card's busy time per step over 8 more steps on a copy of the
    # prompt's cache; the share is taken of the unprofiled median
    caches = (ck0.clone(), cv0.clone(), lens)
    tok = runs["auto"][1][0]
    busy_log("requests", lambda i: decode_step(
        params, cfg, tok, torch.full((b,), p_len + i, device=dev), caches),
        med["auto"])
    del caches
    log(f"LM requests: B={b} prompt {p_len} | prefill {ms_pre:.3f} ms "
        f"({b * p_len / ms_pre * 1e3:.1f} tokens/s) | {n_new} decode steps: "
        f"auto median {med['auto']:.3f} ms ({b / med['auto'] * 1e3:.1f} "
        f"tokens/s), ref {med['ref']:.3f} ms | {agreed} | launches auto "
        f"{launches['auto']['flash_decode']}, ref 0 | {card}")
    req_launches = launches["auto"]["flash_decode"]
    del runs, ck0, cv0

    # the same path in f32 for 4 steps: each greedy token is the argmax of
    # a fresh teacher-forced prefill over the extended sequence wherever
    # that prefill's top-2 margin exceeds 1e-3 (tests/test_lm.py)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    n32 = 4
    logits, (ck, cv), lens = serve_prefill(params32, cfg32, prompt)
    ck0, cv0, _ = init_cache(cfg32, b, p_len + n32, device=dev)
    ck0[:, :, :p_len], cv0[:, :, :p_len] = ck, cv
    del ck, cv
    reset_counts()
    steps, toks, _ = decode(params32, cfg32, (ck0, cv0, lens), logits,
                            lambda i: torch.full((b,), p_len + i, device=dev),
                            n32, "auto")
    expect(read_counts(), n32 * n_layers * 2)
    del ck0, cv0
    seq, checked, worst = prompt, 0, 0.0
    for i in range(n32):
        want = serve_prefill(params32, cfg32, seq)[0]
        if i:       # step i - 1's logits: the token after seq[:, :-1]
            worst = max(worst, float((steps[i - 1] - want).abs().max()))
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 1e-3
        if not torch.equal(want.argmax(-1)[sure], toks[i][:, 0].long()[sure]):
            raise AssertionError(f"f32 step {i}: decode's token differs from "
                                 f"the teacher-forced prefill's")
        checked += int(sure.sum())
        seq = torch.cat([seq, toks[i]], 1)
    log(f"LM f32: {n32} decode steps (auto) == teacher-forced prefill argmax "
        f"at {checked} of {n32 * b} positions with margin > 1e-3; decode vs "
        f"prefill logits max |diff| {worst:.3g}")
    del params32, steps, seq
    torch.cuda.empty_cache()

    # decode_32k at B = 8 (the cell's batch is 128; its cache would be 550
    # GB): positions 0-32,766 of a 32,768-slot cache drawn N(0, 1) in bf16,
    # then 16 steps at position 32,767 under the kernel and the plain
    # version (fed the kernel run's tokens); each step rewrites slot 32,767
    # of every layer before reading it
    shape = LM_SHAPES["decode_32k"]
    s = shape.seq_len
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ck, cv, _ = init_cache(cfg, b, s, device=dev)
    for li in range(n_layers):
        ck[li, :, :s - 1].normal_(generator=gen)
        cv[li, :, :s - 1].normal_(generator=gen)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    lens = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    first = torch.from_numpy(lm_batch(1, b, 1, cfg.vocab, seed=SEED)[0]).to(
        dev)
    logits = torch.zeros((b, cfg.vocab), device=dev)
    n_steps = 16
    at_end = lambda i: torch.full((b,), s - 1, device=dev)    # noqa: E731
    decode(params, cfg, (ck, cv, lens), logits, at_end, 2, "auto",
           [first] * 2)                                          # warm-up
    runs = {}
    for backend in ("auto", "ref"):
        reset_counts()
        runs[backend] = decode(params, cfg, (ck, cv, lens), logits, at_end,
                               n_steps, backend,
                               [first] if backend == "auto"
                               else runs["auto"][1])
        launches[backend] = read_counts()
    expect(launches["auto"], n_steps * n_layers * 2)
    expect(launches["ref"], 0)
    agreed = agree("decode_32k", runs["auto"][0], runs["ref"][0], tol)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {k: statistics.median(r[2]) for k, r in runs.items()}
    tok = runs["auto"][1][-1]
    busy_log("decode_32k", lambda i: decode_step(
        params, cfg, tok, at_end(i), (ck, cv, lens)), med["auto"])
    log(f"LM decode_32k: B={b} (cell 128) S={s} | cache fill {t_fill:.2f} s "
        f"| {n_steps} steps at position {s - 1}: auto median "
        f"{med['auto']:.3f} ms, min {min(runs['auto'][2]):.3f}, max "
        f"{max(runs['auto'][2]):.3f} ({b / med['auto'] * 1e3:.1f} tokens/s)"
        f", ref {med['ref']:.3f} ms ({b / med['ref'] * 1e3:.1f} tokens/s) | "
        f"{agreed} | peak device memory {peak:.2f} GiB | launches auto "
        f"{launches['auto']['flash_decode']}, ref 0 | phase 7 took "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")
    # the logits watch: both backends against an f32 oracle of the same 16
    # teacher-forced steps -- the bf16 weights cast up to f32 (exact), the
    # plain version, the same bf16 cache, fed the kernel run's tokens
    oracle_p = compute_cast(params, torch.float32)
    reset_counts()
    oracle = decode(oracle_p, dataclasses.replace(cfg, dtype="float32"),
                    (ck, cv, lens), logits, at_end, n_steps, "ref",
                    runs["auto"][1])[0]
    expect(read_counts(), 0)
    del oracle_p
    gap = {}
    for backend in ("auto", "ref"):
        d = (runs[backend][0] - oracle).abs()
        gap[backend] = (float(d.max()), float(d.mean()))
    near = all(gap["auto"][i] <= 1.1 * gap["ref"][i] for i in (0, 1))
    log(f"LM decode_32k f32 oracle (bf16 weights cast up, plain version, "
        f"same cache and tokens, {n_steps} steps): |auto - oracle| max "
        f"{gap['auto'][0]:.4g} mean {gap['auto'][1]:.4g}; |ref - oracle| max "
        f"{gap['ref'][0]:.4g} mean {gap['ref'][1]:.4g}; auto "
        f"{'within 10% of ref or below' if near else 'more than 10% above ref'}"
        f" | {card}")
    del ck, cv, runs, params, oracle
    torch.cuda.empty_cache()
    return req_launches + launches["auto"]["flash_decode"]


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
    from repro_torch.configs import din_cfg
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
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.l2_topk import l2_topk, l2_topk_ref
    from repro_torch.kernels.l2_topk.ops import plan
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
                "beam_hops_l2": (beam_hops, "l2_launches"),
                "l2_topk": (l2_topk, "launches"),
                "flash_decode": (flash_decode, "launches")}

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
            "beam_hops_l2": 0.0, "l2_topk": 0.0, "flash_decode": 0.0}

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

    # exact L2 top-k, bitwise: ragged N, odd B, k = 1, k = N, k > N, ties
    # of integer data, D = 1 and 960, bf16 inputs
    t_l2 = time.perf_counter()

    def l2_case(b, n, d, kind):
        if kind == "integer":
            x = torch.randint(-2, 3, (n + b, d), device=dev,
                              generator=gen).float()
        else:
            x = torch.randn((n + b, d), device=dev, generator=gen)
        if kind == "bf16":
            x = x.bfloat16()
        if kind == "identical":
            x[:n] = x[0]
        return x[n:].contiguous(), x[:n].contiguous()

    def l2_launch(q, base, k):
        """The kernel's result, after checking that it made the launches
        that `plan` counts."""
        want = plan(q.shape[0], base.shape[0], q.shape[1], k).launches
        before = l2_topk.launches
        got = l2_topk(q, base, k)
        if l2_topk.launches - before != want:
            raise AssertionError(f"l2_topk made {l2_topk.launches - before} "
                                 f"launches, plan says {want}")
        return got

    for b, n, d, k, kind in ((37, 20001, 18, 100, "integer"),
                             (5, 777, 4, 1, "normal"),
                             (4, 300, 8, 300, "integer"),
                             (4, 300, 8, 1000, "normal"),
                             (3, 5000, 1, 64, "integer"),
                             (2, 3000, 960, 8, "normal"),
                             (3, 9000, 64, 16, "bf16"),
                             (7, 65537, 18, 1024, "normal"),
                             (2, 1 << 16, 18, 1024, "identical")):
        q, base = l2_case(b, n, d, kind)
        got = l2_launch(q, base, k)
        same(f"l2_topk B={b} N={n} D={d} k={k} {kind}", got,
             l2_topk_ref(q, base, k), exact=True)
        if k > n and not ((got[1][:, n:] == -1).all()
                          and torch.isinf(got[0][:, n:]).all()):
            raise AssertionError("l2_topk: no +inf / -1 past N")
        if kind == "identical" and not torch.equal(
                got[1], torch.arange(k, dtype=torch.int32, device=dev)
                .expand(b, k)):
            raise AssertionError("l2_topk: identical rows not in id order")
    log("kernel checks l2_topk (ragged, ties, k > N, D = 1 and 960, bf16, "
        "identical rows): ok, bitwise")
    # DIN's retrieval shapes (B = 1 is the retrieval_cand cell; N, D and
    # k are the item table's rows, its width and rerank_k) and the kernel
    # bench's; each byte counted once, the distances' operations as
    # 2*B*N*D + 2*N*D
    din = din_cfg.model_config()
    main_l2 = (1, din.n_items, din.embed_dim, din.rerank_k)
    l2_rows = {}
    for b, n, d, k in (main_l2, (64,) + main_l2[1:], (8, 100_000, 128, 100)):
        q, base = l2_case(b, n, d, "normal")
        got = l2_launch(q, base, k)
        errs["l2_topk"] = max(errs["l2_topk"], same(
            f"l2_topk B={b} N={n} D={d} k={k}", got,
            l2_topk_ref(q, base, k), exact=True))
        lib = torch.topk(torch.cdist(q, base), k, largest=False)
        log(f"  l2_topk B={b} N={n} D={d} k={k}: "
            f"{plan(b, n, d, k).launches} launches per call ({plan(b, n, d, k)}"
            f"); yardstick topk(cdist) ids equal to the "
            f"kernel's at {float((lib.indices == got[1]).float().mean()):.4f}"
            f" of positions")
        l2_rows[b, n, d, k] = dict(
            kernel=timed(lambda: l2_topk(q, base, k), iters=30),
            plain=timed(lambda: l2_topk_ref(q, base, k), iters=3,
                        dev_iters=2),
            library=timed(lambda: torch.topk(torch.cdist(q, base), k,
                                             largest=False), iters=10,
                          dev_iters=5),
            bound=bound((b * d + n * d) * 4 + b * k * 8,
                        2 * b * n * d + 2 * n * d))
        del q, base, lib
    rows["l2_topk"] = l2_rows[main_l2]
    log(f"  l2_topk checks and timings took {time.perf_counter() - t_l2:.1f} s")

    # flash-decode within atol 1e-5 of its plain version: the reference's
    # sweep (tests/test_kernels.py), G = 1, 4 and 32, Dh = 16, 120, 128 and
    # 256, ragged S; cache_len ragged, 1, S, 0 (zeros) and > S (clamped);
    # f32 and bf16 caches and queries
    t_fd = time.perf_counter()

    def fd_case(b, h, hkv, dh, s, dt):
        return (torch.randn((b, h, dh), device=dev, generator=gen).to(dt),
                torch.randn((b, s, hkv, dh), device=dev, generator=gen,
                            dtype=dt),
                torch.randn((b, s, hkv, dh), device=dev, generator=gen,
                            dtype=dt))

    def fd_check(name, q, k, v, lens):
        got = flash_decode(q, k, v, lens)
        want = flash_decode_ref(q, k, v, lens)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
        errs["flash_decode"] = max(errs["flash_decode"],
                                   float((got - want).abs().max()))
        return got

    f32, bf16 = torch.float32, torch.bfloat16
    for b, h, hkv, dh, s, dt in ((2, 8, 4, 64, 300, f32),
                                 (1, 4, 1, 32, 512, f32),
                                 (3, 16, 16, 64, 200, f32),
                                 (2, 8, 2, 128, 1000, f32),
                                 (2, 8, 2, 128, 1000, bf16),
                                 (3, 16, 16, 128, 777, bf16),
                                 (2, 8, 2, 120, 333, bf16),
                                 (3, 4, 4, 16, 77, bf16),
                                 (2, 8, 1, 256, 513, bf16),
                                 (2, 64, 2, 64, 100, f32)):
        q, k, v = fd_case(b, h, hkv, dh, s, dt)
        for kind, n in (
                ("ragged", torch.randint(1, s + 1, (b,), device=dev,
                                         generator=gen)),
                ("1", torch.ones(b, device=dev)),
                ("S", torch.full((b,), s, device=dev)),
                ("0", torch.zeros(b, device=dev)),
                ("> S", torch.full((b,), s + 5, device=dev))):
            fd_out = fd_check(f"flash_decode B={b} H={h} Hkv={hkv} Dh={dh} "
                           f"S={s} {dt} cache_len {kind}", q, k, v, n.int())
            if kind == "0" and (fd_out != 0).any():
                raise AssertionError("flash_decode: cache_len 0 is not zeros")
    log(f"kernel checks flash_decode (G = 1, 4, 32; Dh = 16, 120, 128, 256; "
        f"cache_len ragged, 1, S, 0, > S; f32 and bf16): ok, max |err| "
        f"{errs['flash_decode']:.3g}")
    # one decode_32k layer at B = 8 (the main path's shape), the kernel
    # bench's (bench_kernels.py) and one long_500k layer, bf16, every
    # position valid; bytes: K and V once, q in, out f32; operations
    # 4 B H S Dh
    main_fd = (8, 16, 16, 128, 32768)
    fd_rows = {}
    for b, h, hkv, dh, s in (main_fd, (4, 32, 8, 128, 8192),
                             (1, 16, 16, 128, 524288)):
        q, k, v = fd_case(b, h, hkv, dh, s, bf16)
        n = torch.full((b,), s, dtype=torch.int32, device=dev)
        fd_out = fd_check(f"flash_decode B={b} H={h} Hkv={hkv} Dh={dh} S={s}",
                       q, k, v, n)
        mask = (torch.arange(s, device=dev)[None, :]
                < n[:, None])[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
        log(f"  flash_decode B={b} H={h} Hkv={hkv} Dh={dh} S={s}: "
            f"2 launches per call; yardstick SDPA (bf16 out) max |diff| "
            f"{float((sdpa()[:, :, 0].float() - fd_out).abs().max()):.3g}")
        fd_bytes = 2 * k.numel() * 2 + q.numel() * 2 + b * h * dh * 4
        fd_rows[b, h, hkv, dh, s] = dict(
            kernel=timed(lambda: flash_decode(q, k, v, n), iters=30),
            plain=timed(lambda: flash_decode_ref(q, k, v, n), iters=3,
                        dev_iters=2),
            library=timed(sdpa, iters=10, dev_iters=5),
            bound=bound(fd_bytes, 4 * b * h * s * dh), bytes=fd_bytes)
        del q, k, v, kt, vt, fd_out, mask
        torch.cuda.empty_cache()
    rows["flash_decode"] = fd_rows[main_fd]
    log(f"  flash_decode checks and timings took "
        f"{time.perf_counter() - t_fd:.1f} s")

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
    for (b, n, d, k), row in l2_rows.items():
        log(f"kernel l2_topk B={b} N={n} D={d} k={k}: {fmt(row['kernel'])} "
            f"| plain {fmt(row['plain'])} | library topk(cdist), two calls: "
            f"{fmt(row['library'])} | bound {row['bound'][0] * 1e3:.3f} us "
            f"({row['bound'][1]}) | {card}")
    for (b, h, hkv, dh, s), row in fd_rows.items():
        log(f"kernel flash_decode B={b} H={h} Hkv={hkv} Dh={dh} S={s} bf16: "
            f"{fmt(row['kernel'])} | plain {fmt(row['plain'])} | library "
            f"SDPA {fmt(row['library'])} | bound {row['bound'][0] * 1e3:.3f} "
            f"us ({row['bound'][1]}) | {card}")
        # the bound's bytes over the kernel's time, against the data sheet
        t = row["kernel"]
        ms = t["device"] if t["device"] is not None else t["call"]
        rate = row["bytes"] / (ms * 1e-3)
        log(f"  flash_decode B={b} H={h} Hkv={hkv} Dh={dh} S={s} bf16 "
            f"achieved {rate / 1e9:.1f} GB/s "
            f"({'device' if t['device'] is not None else 'per-call'} ms "
            f"{ms:.4f}), {100 * rate / HBM_BYTES_PER_S:.2f}% of 3.35 TB/s "
            f"| {card}")
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
                          "beam_hops_l2": chunks, "l2_topk": 0,
                          "flash_decode": 0}:
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
    torch.cuda.empty_cache()

    # ---- 6. DIN serving -------------------------------------------------------
    din_launches = din_serving(dev, card, reset_counts, read_counts)

    # ---- 7. OLMo-1B decode serving ------------------------------------------
    lm_launches = lm_serving(dev, card, reset_counts, read_counts)

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
        "l2_topk": ("src/repro_torch/csrc/l2_topk.cu",
                    "src/repro/kernels/l2_topk/kernel.py:67"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode/kernel.py:81"),
    }
    also = {"beam_hops": "src/repro/kernels/beam_fused/kernel.py:511",
            "beam_hops_l2": "src/repro/kernels/beam_fused/kernel.py:546"}
    # launches on the main paths: the query path's auto and cuda runs, and
    # the construction path's build for the exact-L2 kernel
    path_launches = {k: launches["auto"][k] + launches["cuda"][k]
                     for k in counters}
    path_launches["beam_hops_l2"] = build_launches["beam_hops_l2"]
    path_launches["l2_topk"] = din_launches
    path_launches["flash_decode"] = lm_launches
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
        if name == "l2_topk":
            entry["shape"] = ("B={} N={} D={} k={} (retrieval_cand)"
                              .format(*main_l2))
            entry["library"] = "torch.topk(torch.cdist(q, x)): two calls"
        if name == "flash_decode":
            entry["shape"] = ("B={} H={} Hkv={} Dh={} S={} bf16 (one "
                              "decode_32k layer)".format(*main_fd))
            entry["library"] = ("F.scaled_dot_product_attention(q[:, :, None]"
                                ", k.transpose(1, 2), v.transpose(1, 2), "
                                "attn_mask=pos < cache_len, enable_gqa=True)")
        kernels.append(entry)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
