#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched BAMG query and construction paths,
its disk-resident index, its serving fleet, deployment and freshness, DIN
serving, LM serving (OLMo-1B, Gemma-7B, H2O-Danube3-4B,
Qwen1.5-MoE-A2.7B, Moonlight-16B-A3B) and training (OLMo-1B,
Qwen1.5-MoE-A2.7B, DIN, and the GNN family: GraphCast, NequIP, MACE,
DimeNet) on one NVIDIA GPU, and its sharded mesh on ranks that share it.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py         # serve at N = 1,000,000, build at 25,000
    python3 chip_smoke.py --n 100000 --build-n 10000 --disk-n 2000  # quicker

Phases, in the order they run (9 runs right after 4, on its corpus; 8
right after 5, on its BAMG; 10 right after 8, on its index; 11, 12,
13, then 14 last);
any failed
check raises and the script exits nonzero:

1. card: name and power limit (nvidia-smi), TF32 off for matmul and cuDNN;
2. build: nvcc compiles the kernels in `src/repro_torch/csrc/`;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes and on ragged cases (odd batch sizes, -1
   adjacency pads, rows that run out of frontier, integer-valued tables and
   vectors that force (dist, id) ties, tables above 48 KB of shared memory,
   D = 960 query rows, graphs heavy with duplicate and in-pool neighbours,
   D = 7 rows one float into their storage), both beam-hop kernels held
   bitwise; both ADC kernels bitwise in both of `plan`'s forms, either side
   of its cut, at M = 8, 12, 48 and 64, K = 16, B = N = 1 and codes one byte
   into their storage, with an empty kernel at each main shape's geometry
   timed as the design floor; for the L2 top-k kernel, bitwise, odd B, N not
   a multiple of its tile, k = 1, k = N and k > N (+inf / -1), integer data
   (ties), D = 1 and 960, bf16 inputs and a base of identical rows, each
   call making the launches `plan` counts, then DIN's retrieval shapes
   (B = 1 and 64, N = 1,048,576, D = 18, k = 1024) and the kernel bench's
   (B = 8, N = 100,000, D = 128, k = 100); for flash-decode, within atol
   1e-5 of its plain version, the reference's sweep, G = 1, 4 and 32,
   Dh = 16, 120, 128 and 256, ragged S, cache_len ragged, 1, S, 0 (zeros)
   and > S (clamped), f32 and bf16 caches, then one decode_32k layer (B = 8,
   H = Hkv = 16, Dh = 128, S = 32,768, bf16), the kernel bench's shape
   (B = 4, H = 32, Hkv = 8, S = 8,192), one long_500k layer (B = 1,
   S = 524,288) and phase 11's decode_32k layers of gemma-7b (B = 2,
   H = Hkv = 16, Dh = 256, S = 32,768) and h2o-danube-3-4b (B = 128,
   H = 32, Hkv = 8, Dh = 120, its 4,096-slot ring); times by CUDA
   events beside the plain version, a PyTorch yardstick where one
   exists, and the least time the card could take (`bound_ms`); for
   flash-decode also the bytes of its bound over its time (GB/s) and
   their share of the card's 3.35 TB/s;
4. query path: `paper_dataset("sift-like")` at `--n` with exact top-100
   ground truth, an exact kNN graph at BAMG's serving width R = 32, PQ
   trained and encoded on the card, and 1,024 queries served in batches of
   64 under the backends "auto" (fused hop kernel), "cuda" (hop loop with
   the rowwise kernel) and "ref" (plain PyTorch).  The three must agree,
   the launch counters must show the kernels ran, every returned distance
   must be the exact one of its id, and tombstoned ids must never come
   back;
9. the serving fleet: phase 4's corpus in 4 round-robin shards of
   250,000, each with its own exact kNN graph at R = 32 and phase 4's
   codec and codes, assembled by `ServeRuntime(shard_vids, engines,
   n_replicas=2)` -- 4 shards x 2 replicas on the one card -- and served
   in batches of 64 under "auto" and "ref": the two must agree, "auto"
   must equal the legacy per-shard scatter-gather bitwise, every distance
   must be exact, the clean run must leave every shard and replica up
   with no error and launch `pq_adc` and `beam_hops` once per shard and
   batch; with shard 1 marked down the answers must equal the oracle
   without it, every row degraded; a fault on shard 2's replica 0 must
   change no answer and mark that replica down; excluded ids must never
   come back.  A `Scheduler` load sweep (2,048 Poisson requests at 0.5x,
   1x and 1.5x the fleet's micro-batch throughput of B = 32, SLO 10x the
   micro-batch median, a shrunk tier of l = 16, 8 hops) logs p50, p99,
   achieved QPS, deadline hit, degraded and shrunk fractions; at 0.5x
   every full-beam completion must equal an unscheduled batch.  Then
   `ServeRuntime.build` builds a BAMG fleet at `--disk-n` (4 shards;
   reduced, a BAMG per 250,000-point shard does not fit the call) and
   serves it under "auto" and "ref";
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
8. the disk-resident index: phase 5's graph, codec, codes and nav graph
   wrapped in the port's `BAMGIndex` through its constructor and
   `_make_decoupled_store` (29 nodes a 4 KB graph block, vectors in their
   own region), nothing rebuilt; `search_batch` on 250 queries with
   exact top-10 at L = 64 and 128 under the default I/O (LRU, 256 graph
   and 256 vector blocks cached, qd 1, caches dropped before each query),
   then at qd = 4 with batched submissions, logging recall@10, mean NIO,
   graph and vector reads, hops, n_dist, n_pq, the cost model's QPS and
   pipelined QPS and host ms a query.  NIO must equal graph + vector reads
   on every query, qd = 4 must keep every query's ids, NIO and cache hits,
   a zero-rate fault plan must be bit-identical to the clean disk, and a
   1% transient-error plan must return the clean ids on >= 95% of the
   queries.  `save` then `load` on the card must keep ids and NIO on 64
   queries, and `BatchedANNEngine.from_index` must return phase 5's ids
   under "auto" (the pq_adc and beam-hop kernels) and "ref"'s under
   "cuda" (pq_adc_rowwise).  Then BAMG, DiskANN and Starling are built on
   the card at `--disk-n` (each build must launch the exact-L2 hop
   kernel) and searched at L = 64: build time, NIO and recall@10 each;
10. deployment, freshness and BMRNG: `DeploymentManager.deploy` at
   `--disk-n` (min_recall 0.2), a failing deploy (min_recall 1.01) that
   must leave ACTIVE, a tampered artifact that must raise
   `IntegrityError`, a second deploy that `BlueGreenEngine.refresh`
   must swap in and `rollback` must undo; a `FreshService` bootstrapped
   from phase 8's `--disk-n` BAMG takes `--inserts` (250, 5%) vectors
   of another seed and 1% deletes of the queries' true top-10, serves
   phase 8's 250 queries batched under "auto" and 100 on the host path,
   consolidates (validated, published, promoted, swapped) and serves
   again: no deleted id may come back, before consolidation every insert
   must come back first at distance 0 for its own vector on the batched
   path; after it the kernels must miss exactly the plain version's
   inserts, at the served budget and at l = 512, 1,024 hops; external
   ids must stay stable and the lineage must reach HISTORY and the
   manifest.  Last, the exact BMRNG on
   400 points in BNF blocks of 29, distances on the card, with Theorem
   1's monotonic I/O path on 200 sampled pairs;
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
   with max and mean |auto - oracle| and |ref - oracle|;
11. the four other LM archs at their full configs, one at a time, each
   from bf16 weights that `init_lm_params(..., dtype=torch.bfloat16)`
   draws on the card, freed before the next: B prompts from `lm_batch`
   and 8 greedy steps under "auto" and "ref" (fed auto's tokens), then
   decode_32k on a cache drawn N(0, 1), 8 steps at position 32,767 under
   both -- gemma-7b B = 8 x 1,024 tokens, the f32 teacher-forced check
   (4 steps, the bf16 weights cast up), decode_32k at B = 2 (the cell's
   128 would need 1.92 TB of cache); h2o-danube-3-4b B = 4 x 4,608
   tokens (past its 4,096 window: a rolled ring, every decode write
   wraps), the f32 check, decode_32k at the cell's B = 128 on its
   4,096-slot ring (48.3 GB) and long_500k at B = 1, position 524,287;
   qwen2-moe-a2.7b B = 8 x 1,024, decode_32k at B = 4; moonshot-v1-16b-
   a3b B = 8 x 1,024 and no decode_32k (one row is 12.9 GB of cache
   beside 57.8 GB of weights).  flash_decode must launch 2 x layers x
   steps under auto and never under ref; dense archs are held to phase
   7's rule, MoE archs to it on every row whose routes (each layer's
   experts and router logits, recorded in every run) have matched so far,
   and their routing to the same rule: router logits within 0.25 of ref's
   on those rows, and a row's top-k set may differ only where ref's margin
   between its k-th and (k+1)-th router logit is below 0.25; that row
   then leaves the comparison.  A third MoE run, "ref" fed auto's tokens
   and auto's experts, keeps every row: its router logits and then its
   logits are held to the same rule on all of them.  Each arch logs
   prefill ms and tokens/s, the step's median, min and max and tokens/s,
   the card's busy share, the peak memory and the launches;
12. training, through `train.ft.run_loop` / `run_with_recovery`,
   `train.trainer.make_train_step` and `train.checkpoint` (f32 masters,
   AdamW after 2 warmup steps, lr 1e-4 for the LMs and 1e-3 for DIN):
   OLMo-1B train_4k at its full
   config (bf16 compute, remat "full", 64 loss chunks) at B = 8 x 4,096
   (the cell's 256 cut to 8) in TRAIN_ACCUM 2 micro-batches, the first 4
   steps of an 8-step schedule, then an async checkpoint -- losses
   finite and falling, the step
   median, tokens/s, model FLOP share of the bf16 peak, busy share over
   one profiled step, peak memory -- and its last checkpoint restored
   bitwise onto the card; that checkpoint cast to bf16 and served: 4 x
   512-token prefill, 8 greedy steps under "auto" (flash_decode, 256
   launches) and "ref", held to phase 7's rule; restart equivalence at
   OLMo's width with 2 layers, B = 2 x 1,024, 6 steps uninterrupted
   against `run_with_recovery` failing after step 3 (bitwise, or within
   rtol 1e-6 where the run is not deterministic); the f32 gradients at
   that width and B = 2 x 512 equal with the caller's TF32 on and off;
   Qwen1.5-MoE-A2.7B at full width with 2 of its 24 layers, B = 4 x
   1,024, 4 steps (loss, ce and aux); DIN train_batch at its full config
   (B = 65,536), 8 steps; then `python -m repro_torch.launch.serve` (N =
   4,000) on the card.  Training itself launches no hand-written kernel;
13. the GNN family, last, trained through `train.trainer.make_train_step`
   (AdamW, lr 1e-3, 2 warmup steps), 8 steps each at the full configs:
   GraphCast (16 layers, d_hidden 512, bf16 activations over f32 masters)
   on full_graph_sm (`random_graph(2708, 10556, d_feat=1433)`, edges padded
   with -1 to 10,560, N(0, 1) targets) and on minibatch_lg (a base graph of
   232,965 nodes and a tenth of the cell's 114,615,892 edges, d_feat 602,
   then a new `padded_sample` of 1,024 seeds at fanout [15, 10] each step,
   padded to `expected_sizes`' 169,984 nodes x 168,960 edges, its sampling
   timed apart); NequIP (5 x 32), MACE (2 x 128, correlation 3) and
   DimeNet (6 x 128, triplets capped at 4 x E) on the molecule cell
   (`molecules_batch(128, 30, 64)`: 3,840 atoms, 8,192 edges).  Each run
   logs the first step, the median of the others, graphs/s or (seed) nodes
   a second, the model FLOP share (the reference's dry-run count) of the
   bf16 peak (GraphCast) or of 67 TFLOP/s f32, the busy share and kernel
   runs over one profiled step, and the peak memory; losses finite and
   falling.  Before training, one f32 loss-and-gradient evaluation on the
   card against the CPU (GraphCast in f32 with 2 of its 16 layers, the
   others at full config): losses within rtol 1e-5, every gradient leaf
   within 1e-4 x its CPU max + 1e-6; GraphCast's bf16 step-0 loss beside
   its f32 one; NequIP's energies invariant under a rotation and a
   translation (rtol 2e-4, atol 1e-4) and its forces rotating with the
   positions (rtol 1e-3, atol 1e-4).  Then `python -m
   repro_torch.launch.train --arch graphcast --steps 3` on the card.  No
   hand-written kernel lies on the GNN path: every counter must stay 0;
14. the sharded mesh, last: OLMo-1B's step 0 in f32 (TF32 off) on the
   card in this process at B = 4 x 512 (loss and gradient global norm;
   freed), then `launch.mesh.run_ranks` spawns 4 ranks on the card as a
   (2, 2) ("data", "model") mesh joined over gloo (NCCL refuses two ranks
   on one device; every collective takes the ranks' CUDA tensors).  They
   run OLMo-1B at its published widths, depth cut to MESH_LAYERS, with
   `lm_param_specs(..., fsdp_axis="data")` (FSDP over data x tensor
   parallelism over model): step 0 in f32, whose loss must be within
   rtol 1e-4 and gradient norm within rtol 1e-3 of the single card's,
   then MESH_STEPS (3) bf16 steps through `make_train_step` (lr 1e-4,
   losses finite),
   each logged with its ms over gloo (no figure of NCCL) and its
   collectives by kind, count and bytes; peak GiB by rank.  The model
   (step and f32 parameters) is saved from the mesh
   (`train.checkpoint.save`: every rank gathers, rank 0 writes), then 2
   new ranks restore it with `restore_sharded` into a (1, 2) mesh: each
   leaf's layout-free digest must be the saved leaf's (its bits), and
   the next batch's loss must be within rtol 1e-4 of the uninterrupted
   run's.  On the (2, 2) mesh, DIN at its full config with row-sharded
   tables: `sharded_lookup` of each rank's rows bitwise the single-card
   lookup, the sharded `loss_fn` within rtol 1e-5 / atol 1e-6 of the
   single-card loss, and the retrieval shortlist (`DIN.shortlist(mesh=)`:
   the history's lookup on the mesh, `l2_topk` under "auto" over the
   whole table) giving each rank's rows the single card's ids; and
   `make_manual_dp_step(..., compression="int8_ef")` on a (4,) data mesh
   at the reference test's config (`reduced`): after ten steps within
   0.05 of `make_train_step`'s loss.  Then mesh B, in the same spawn,
   each part at the published widths against a single-card reference
   computed here before the ranks start and freed: (1) OLMo-1B's
   long_500k, MESH_LAYERS layers (`reduced`), B = 1 at all 524,288
   positions under kv_mode "seq_all" (the cache's sequence over both
   axes: a 4.29 GB bf16 block a rank, 17.2 GB in all, synthetic, drawn
   131,072 positions a seed so that each rank draws its slice and the
   parent the same bits whole): an f32 step at position 524,287 (the
   last rank's last row) and one at 262,144 (the first row of rank 2's
   slice, rank 3 left empty), each rank's logits within rtol / atol 3e-4
   of `decode_step(kv_mode="local", backend="ref")` on the whole cache
   here, the new row written by its owner alone within one bf16 ulp of
   the row written here; then 8 bf16 steps timed; (2) decode_32k under
   "head" (16 kv heads over tp 2), B = 8 x 32,768 slots, 4 layers: a
   sharded `serve_prefill(ctx=)` of 512 tokens placed into the cache
   (the rest drawn N(0, 1) by row), its logits within 0.25 of the
   single card's, then 8 steps under "auto", `flash_decode` in each
   rank, each within phase 7's rule (0.25) of the single card's, fed
   its tokens; (3) Qwen1.5-MoE-A2.7B at full width with 2 of its 24
   layers (`reduced`), experts over model x FSDP over data, B = 4 x
   512, through `make_train_step`: step 0 in f32 at no-drop capacities
   (8.0 / 8.0, remat "none"; its lr is 0) within rtol 1e-4 (loss) and
   1e-3 (gradient norm) of the single card's with no slot dropped, then
   QWEN_STEPS (1, `reduced` from 4) bf16 step at the published
   capacities (a finite loss), each rank's dropped slots in each
   forward, the
   all_to_all bytes, and one "head" decode step of the trained model
   through the expert-parallel FFN on a 64-slot cache drawn N(0, 1).  Each part logs its
   steps' ms over gloo (no figure of NCCL), collectives by kind, count
   and bytes, and peak GiB by rank.  Then mesh C, in the same spawn: (4)
   `ring_gather` and `ring_scatter_add` over the 4 ranks at ogb_products'
   node count (RING_ROWS x RING_WIDTH f32, RING_IDS global ids, RING_PAD
   of them -1), forward and VJP: the gather bitwise one card's
   `index_select`, the scatter and both VJPs within rtol / atol 1e-5 of
   one card's `index_add_` / `index_select` on the whole arrays, each
   rank's block; ms a call, collective-permutes and bytes, peak GiB by
   rank; (5) one train step each of NequIP and DimeNet at their
   published widths, 1 layer / 1 block (`reduced`), on a synthetic graph
   of GNN_MESH_NODES x GNN_MESH_EDGES (`reduced`), through the GNN
   cells' rank program with the ring hooks (`launch.cells`): loss within
   rtol 1e-4 and gradient norm within rtol 1e-3 of one card's step here,
   collective-permutes counted.  The shortlist and "head" decode are
   the mesh path's kernels: each rank's `l2_topk` and `flash_decode`
   counters must be nonzero (the single-card comparisons' launches not
   counted), every other counter, in each rank and here, 0; mesh C
   launches none.

The last lines are the script's time, the card's nvidia-smi line, one JSON
object with every kernel's numbers, and `{"ok": true, "device": {...}}`.
The script exits
nonzero, printing no result, where no CUDA device is present or where it
stands outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
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


# ---------------------------------------------------------------------------
# LM serving (phases 7 and 11)
# ---------------------------------------------------------------------------
# bf16 logits (std about 1, the largest about 5): the kernel and the plain
# version differ in the f32 attention sums at about 1e-7, and bf16 layers
# of random weights spread that over most logits at a few bf16 ulps (2^-5
# at 4); a fault in the kernel moves them by O(1).  0.25 is a quarter of
# the logits' spread and 8 ulps at the largest
LM_TOL = 0.25
# MoE route flips are also logged by the `ref` run's gap between its
# k-th and (k+1)-th expert probability: how many came at a gap this large
ROUTE_TIE = 1e-3


def synced(fn):
    """fn() between two syncs of the card; returns (its result, host ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_decode(p, c, caches, logits, positions, n, backend, feed=()):
    """n greedy decode steps (kv_mode "local") from `logits`, step i at
    positions(i) and fed feed[i] where given (not None), else the last
    logits' argmax; returns (per-step logits (n, B, V) f32, tokens,
    per-step ms)."""
    import torch

    from repro_torch.models.transformer import decode_step
    steps, toks, times = [], [], []
    for i in range(n):
        tok = (feed[i] if i < len(feed) and feed[i] is not None
               else logits.argmax(-1)[:, None].int())
        pos = positions(i)
        (logits, caches), ms = synced(lambda: decode_step(
            p, c, tok, pos, caches, kv_mode="local", backend=backend))
        steps.append(logits.float())
        toks.append(tok)
        times.append(ms)
    return torch.stack(steps), toks, times


def lm_agree(name, got, want, tol=LM_TOL):
    """Logits within `tol`; argmax equal wherever `want`'s top-2 margin
    exceeds it.  Returns a log fragment: max and mean |diff|, the share of
    logits that differ, positions checked."""
    import torch
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


def lm_busy_log(name, step, med, n=8):
    """Log the card time per step that torch.profiler's CUDA activity sees
    over n calls of step(i), the part of it in flash_decode, kernel runs
    per step, and the busy time's share of the unprofiled median `med`."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    avgs = [a for a in prof.key_averages() if a.self_device_time_total > 0]
    dev_ms = sum(a.self_device_time_total for a in avgs) / 1e3 / n
    fd_ms = sum(a.self_device_time_total for a in avgs
                if "flash_decode" in a.key) / 1e3 / n
    runs = sum(a.count for a in avgs) / n
    log(f"  {name} auto: card busy {dev_ms:.4f} ms per step ({runs:.1f} "
        f"kernel runs; flash_decode {fd_ms:.4f} ms, "
        f"{fd_ms / dev_ms if dev_ms else 0:.2%} of busy) = "
        f"{dev_ms / med:.2%} of the per-step median")


def expect_launches(launches, n_fd):
    """Every kernel's launches 0 but flash_decode's, which must be n_fd."""
    want = {name: 0 for name in launches}
    want["flash_decode"] = n_fd
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")


def prefill_cache(params, cfg, prompt, n_new):
    """serve_prefill over `prompt`, its caches moved into ones with room
    for n_new more positions (a sliding window's ring keeps its size);
    returns (last logits, (ck, cv, lengths), prefill ms)."""
    from repro_torch.models.transformer import (cache_len_for, init_cache,
                                                serve_prefill)
    b, p_len = prompt.shape
    (logits, (ck, cv), lens), ms = synced(
        lambda: serve_prefill(params, cfg, prompt))
    if cache_len_for(cfg, p_len + n_new) > ck.shape[2]:
        ck0, cv0, _ = init_cache(cfg, b, p_len + n_new, dtype=ck.dtype,
                                 device=ck.device)
        ck0[:, :, :p_len], cv0[:, :, :p_len] = ck, cv
        ck, cv = ck0, cv0
    return logits, (ck, cv, lens), ms


def teacher_forced(params32, cfg32, prompt, reset_counts, read_counts,
                   n32=4) -> str:
    """The f32 path for n32 greedy steps under "auto": each token must be
    the argmax of a fresh teacher-forced prefill over the extended
    sequence wherever that prefill's top-2 margin exceeds 1e-3
    (tests/test_lm.py).  Returns a log fragment."""
    import torch

    from repro_torch.models.transformer import serve_prefill
    b, p_len = prompt.shape
    logits, caches, _ = prefill_cache(params32, cfg32, prompt, n32)
    reset_counts()
    steps, toks, _ = lm_decode(
        params32, cfg32, caches, logits,
        lambda i: torch.full((b,), p_len + i, device=prompt.device), n32,
        "auto")
    expect_launches(read_counts(), n32 * cfg32.n_layers * 2)
    del caches
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
    return (f"{n32} decode steps (auto) == teacher-forced prefill argmax at "
            f"{checked} of {n32 * b} positions with margin > 1e-3; decode vs "
            f"prefill logits max |diff| {worst:.3g}")


class RouteLog:
    """The MoE routes of decode runs: while `recording(run)` is open,
    `moe.route` is wrapped to keep, per call, the experts the run's own
    router chose and its logits (f32, dead experts at -1e30).  Under
    `recording(run, lead)` the run is fed the `lead` run's experts, call
    for call, with its own probabilities as their gates: the routes'
    counterpart of feeding a run another's tokens."""

    def __init__(self, moe):
        self.moe, self.calls, self.leads = moe, {}, {}

    def recording(self, run, lead=None):
        import torch

        route, calls = self.moe.route, self.calls.setdefault(run, [])
        led = self.calls[lead] if lead else None
        self.leads[run] = lead

        def recorded(x, w, cfg):
            gates, eids, aux = route(x, w, cfg)
            logits = torch.nn.functional.pad(
                x.float() @ w.float(), (0, cfg.n_experts_padded
                                        - cfg.n_experts), value=-1e30)
            calls.append((eids, logits))
            if led is not None:
                eids = led[len(calls) - 1][0]
                g = logits.softmax(-1).gather(1, eids.long())
                gates = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
            return gates, eids, aux

        @contextlib.contextmanager
        def patched():
            self.moe.route = recorded
            try:
                yield
            finally:
                self.moe.route = route
        return patched()

    def agree(self, name, got, want, run, n_layers, k, tol=LM_TOL):
        """Phase 7's rule on the routing decisions, then on the logits, of
        "auto" against `run` (a "ref" run).  A router is a linear readout of
        the residual stream, as the LM head is, and its top k a decision on
        its logits, as the greedy token is: on every row still compared,
        the router's logits must lie within `tol` of `run`'s at every layer,
        and its top-k set may differ from `run`'s own only where `run`'s
        margin between its k-th and (k+1)-th logit is below `tol`.  A run
        on its own routes diverges after such a flip, so the row leaves the
        comparison from that step on; a run fed auto's routes keeps every
        row.  The rows kept are held to `lm_agree`."""
        import torch
        n, b = got.shape[:2]
        fed = self.leads[run] is not None
        alive = torch.ones(b, dtype=torch.bool, device=got.device)
        keep = torch.zeros((n, b), dtype=torch.bool, device=got.device)
        flips, worst, over = [], 0.0, 0
        for i in range(n):
            for li in range(n_layers):
                (ea, la), (er, lr) = (self.calls[r][i * n_layers + li]
                                      for r in ("auto", run))
                d = (la - lr).abs().amax(-1)
                if bool((d[alive] > tol).any()):
                    raise AssertionError(
                        f"{name} ({run}): step {i} layer {li}: router "
                        f"logits differ by {float(d[alive].max())} > {tol}")
                worst = max(worst, float(d[alive].max()) if alive.any()
                            else 0.0)
                differ = ((ea.sort(-1).values != er.sort(-1).values).any(-1)
                          & alive)
                if not differ.any():
                    continue
                top = lr[differ].topk(k + 1, dim=-1).values
                margin = top[:, k - 1] - top[:, k]
                if bool((margin >= tol).any()):
                    raise AssertionError(
                        f"{name} ({run}): step {i} layer {li}: routes differ "
                        f"where the k-th / (k+1)-th logit margin is "
                        f"{float(margin.max())} >= {tol}")
                probs = lr[differ].softmax(-1).topk(k + 1, dim=-1).values
                gap = probs[:, k - 1] - probs[:, k]
                over += int((gap >= ROUTE_TIE).sum())
                flips.append((float(margin.max()), float(gap.max())))
                if not fed:
                    alive &= ~differ
            keep[i] = alive
        frag = (lm_agree(f"{name} ({run})", got[keep], want[keep], tol)
                if keep.any() else "no row kept its routes")
        big = max(flips, default=(0.0, 0.0))
        return (f"{frag}; routes: max |router logit auto - {run}| "
                f"{worst:.4g} (tol {tol}); {len(flips)} flips within the "
                f"margin (largest margin {big[0]:.3g}, its probability gap "
                f"{big[1]:.3g}; {over} at a gap >= {ROUTE_TIE})"
                + ("" if fed else f", {b - int(alive.sum())} of {b} rows "
                   f"flipped") + f"; {int(keep.sum())} of {n * b} step rows "
                f"compared")


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

    # requests: B = 8 prompts of 1,024 tokens, a cache of 1,024 + 32, then
    # 32 greedy steps under the kernel and under the plain version (which
    # is fed the kernel run's tokens)
    b, p_len, n_new = 8, 1024, 32
    prompt = torch.from_numpy(lm_batch(0, b, p_len, cfg.vocab,
                                       seed=SEED)[0]).to(dev)
    serve_prefill(params, cfg, prompt[:, :64])                   # warm-up
    logits0, (ck0, cv0, lens), ms_pre = prefill_cache(params, cfg, prompt,
                                                      n_new)
    runs, launches = {}, {}
    for backend in ("auto", "ref"):
        caches = (ck0.clone(), cv0.clone(), lens)
        reset_counts()
        runs[backend] = lm_decode(params, cfg, caches, logits0,
                                  lambda i: torch.full((b,), p_len + i,
                                                       device=dev),
                                  n_new, backend,
                                  () if backend == "auto" else runs["auto"][1])
        launches[backend] = read_counts()
        del caches
    expect_launches(launches["auto"], n_new * n_layers * 2)
    expect_launches(launches["ref"], 0)
    agreed = lm_agree("requests", runs["auto"][0], runs["ref"][0])
    med = {k: statistics.median(r[2]) for k, r in runs.items()}
    # the card's busy time per step over 8 more steps on a copy of the
    # prompt's cache; the share is taken of the unprofiled median
    caches = (ck0.clone(), cv0.clone(), lens)
    tok = runs["auto"][1][0]
    lm_busy_log("requests", lambda i: decode_step(
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

    # the same path in f32 for 4 steps, held to fresh teacher-forced
    # prefills
    log("LM f32: " + teacher_forced(
        params32, dataclasses.replace(cfg, dtype="float32"), prompt,
        reset_counts, read_counts))
    del params32
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
    lm_decode(params, cfg, (ck, cv, lens), logits, at_end, 2, "auto",
              [first] * 2)                                       # warm-up
    runs = {}
    for backend in ("auto", "ref"):
        reset_counts()
        runs[backend] = lm_decode(params, cfg, (ck, cv, lens), logits, at_end,
                                  n_steps, backend,
                                  [first] if backend == "auto"
                                  else runs["auto"][1])
        launches[backend] = read_counts()
    expect_launches(launches["auto"], n_steps * n_layers * 2)
    expect_launches(launches["ref"], 0)
    agreed = lm_agree("decode_32k", runs["auto"][0], runs["ref"][0])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {k: statistics.median(r[2]) for k, r in runs.items()}
    tok = runs["auto"][1][-1]
    lm_busy_log("decode_32k", lambda i: decode_step(
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
    oracle = lm_decode(oracle_p, dataclasses.replace(cfg, dtype="float32"),
                       (ck, cv, lens), logits, at_end, n_steps, "ref",
                       runs["auto"][1])[0]
    expect_launches(read_counts(), 0)
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


def lm_archs(dev, card, reset_counts, read_counts) -> dict:
    """Phase 11: gemma-7b, h2o-danube-3-4b, qwen2-moe-a2.7b and
    moonshot-v1-16b-a3b served one at a time at their full configs;
    returns the flash_decode kernel's launches on each arch's bf16 `auto`
    runs."""
    import torch

    from repro_torch.configs import (gemma_7b, h2o_danube3_4b,
                                     moonshot_v1_16b_a3b, qwen2_moe_a2_7b)

    t_phase = time.perf_counter()
    # (config, requests' batch and prompt length, the f32 check, decode_32k
    # batch, long_500k): decode_32k cut to what fits beside the weights
    # (gemma: 128 rows would need 1.92 TB of cache, 2 need 30.1 GB; qwen:
    # 4 rows 25.8 GB; moonshot: one row is 12.9 GB beside 57.8 GB of
    # weights, none); danube's 4,096-slot ring holds the cell's 128 rows in
    # 48.3 GB and its long_500k row in 0.38 GB
    plans = ((gemma_7b, 8, 1024, True, 2, False),
             (h2o_danube3_4b, 4, 4608, True, 128, True),
             (qwen2_moe_a2_7b, 8, 1024, False, 4, False),
             (moonshot_v1_16b_a3b, 8, 1024, False, None, False))
    out = {}
    for mod, *plan in plans:
        out[mod.ARCH_ID] = serve_arch(dev, card, mod.model_config(), *plan,
                                      reset_counts, read_counts)
        torch.cuda.empty_cache()
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return out


def serve_arch(dev, card, cfg, b, p_len, f32_check, b32, long_500k,
               reset_counts, read_counts) -> int:
    """One arch of phase 11 from bf16 weights drawn on the card: B = b
    prompts of p_len tokens and 8 greedy steps under "auto" and "ref"
    (fed auto's tokens); for dense archs the f32 teacher-forced check;
    decode_32k at B = b32 (None: not run) and, where asked, long_500k at
    B = 1, each on a cache drawn N(0, 1), 8 steps at the shape's last
    position under both backends.  MoE archs are held to the routing-aware
    rule (`RouteLog.agree`), against "ref" and against "ref" fed auto's
    routes.  Returns flash_decode's launches over the bf16 `auto` runs."""
    import dataclasses

    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import moe
    from repro_torch.models.transformer import (compute_cast, decode_step,
                                                init_cache, init_lm_params,
                                                serve_prefill)

    t_arch = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, ms_init = synced(lambda: init_lm_params(
        cfg, gen, device=dev, dtype=torch.bfloat16))
    stored = sum(t.numel() * t.element_size() for t in (
        *params["layers"].values(), *params.values()) if torch.is_tensor(t))
    ffn = (f"{cfg.moe.n_experts} experts (stored {cfg.moe.n_experts_padded})"
           f" top-{cfg.moe.top_k} x {cfg.moe.d_ff_expert} + shared "
           f"{cfg.moe.d_ff_shared}" if cfg.moe else f"ff={cfg.d_ff}")
    log(f"LM {cfg.name}: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads} "
        f"Hkv={cfg.n_kv_heads} Dh={cfg.d_head} {ffn} V={cfg.vocab} "
        f"window={cfg.sliding_window} {cfg.norm} {cfg.activation} | "
        f"{cfg.n_params()} parameters ({cfg.n_active_params()} active), "
        f"{stored / 1e9:.3f} GB stored in bf16 | init_lm_params on the card "
        f"{ms_init / 1e3:.2f} s")
    # 8 steps a run (16 until the smoke outgrew its time limit)
    n_layers, n_steps = cfg.n_layers, 8
    routes = RouteLog(moe) if cfg.moe else None
    total = 0

    def run_both(name, caches, logits, positions, feed, fresh=False):
        """n_steps under "auto" (fed `feed`) then "ref" (fed auto's tokens)
        and, for MoE archs, "ref" again fed auto's tokens and routes, on
        `caches` or, where `fresh`, each on its own copy (steps that write
        new slots); checks launches and agreement.  Returns (runs, log
        fragment)."""
        nonlocal total
        runs = {}
        for run in ("auto", "ref") + (("ref_routed",) if routes else ()):
            ck, cv, lens = caches
            copy = (ck.clone(), cv.clone(), lens) if fresh else caches
            reset_counts()
            with (routes.recording(run, "auto" if run == "ref_routed"
                                   else None) if routes
                  else contextlib.nullcontext()):
                runs[run] = lm_decode(
                    params, cfg, copy, logits, positions, n_steps,
                    "auto" if run == "auto" else "ref",
                    feed if run == "auto" else runs["auto"][1])
            expect_launches(read_counts(), n_steps * n_layers * 2
                            if run == "auto" else 0)
            del copy
        total += n_steps * n_layers * 2
        if not routes:
            return runs, lm_agree(name, runs["auto"][0], runs["ref"][0])
        agreed = " | ".join(
            routes.agree(name, runs["auto"][0], runs[run][0], run, n_layers,
                         cfg.moe.top_k) for run in ("ref", "ref_routed"))
        routes.calls.clear()
        return runs, agreed

    def step_log(runs, rows):
        t = runs["auto"][2]
        med = statistics.median(t)
        return (f"{n_steps} decode steps: auto median {med:.3f} ms, min "
                f"{min(t):.3f}, max {max(t):.3f} ({rows / med * 1e3:.1f} "
                f"tokens/s), ref {statistics.median(runs['ref'][2]):.3f} ms",
                med)

    # requests: b prompts of p_len tokens (lm_batch), n_steps greedy steps
    prompt = torch.from_numpy(lm_batch(0, b, p_len, cfg.vocab,
                                       seed=SEED)[0]).to(dev)
    serve_prefill(params, cfg, prompt[:, :64])                   # warm-up
    logits0, caches, ms_pre = prefill_cache(params, cfg, prompt, n_steps)
    runs, agreed = run_both(
        "requests", caches, logits0,
        lambda i: torch.full((b,), p_len + i, device=dev), (), fresh=True)
    steps, med = step_log(runs, b)
    tok = runs["auto"][1][0]
    busy_caches = (caches[0].clone(), caches[1].clone(), caches[2])
    lm_busy_log(f"{cfg.name} requests", lambda i: decode_step(
        params, cfg, tok, torch.full((b,), p_len + i, device=dev),
        busy_caches), med)
    log(f"{cfg.name} requests: B={b} prompt {p_len} (cache "
        f"{caches[0].shape[2]} slots) | prefill {ms_pre:.3f} ms "
        f"({b * p_len / ms_pre * 1e3:.1f} tokens/s) | {steps} | {agreed} | "
        f"launches auto {n_steps * n_layers * 2}, ref 0 | {card}")
    del runs, caches, busy_caches

    if f32_check:
        # the bf16 weights cast up (exact) stand in for the bf16 ones
        # while the f32 path runs, then are cast back
        params = compute_cast(params, torch.float32)
        log(f"{cfg.name} f32: " + teacher_forced(
            params, dataclasses.replace(cfg, dtype="float32"), prompt,
            reset_counts, read_counts))
        params = compute_cast(params, torch.bfloat16)
        torch.cuda.empty_cache()

    for shape, rows in ((LM_SHAPES["decode_32k"], b32),
                        (LM_SHAPES["long_500k"], 1 if long_500k else None)):
        if rows is None:
            continue
        # every slot of the cache (a ring under a window) drawn N(0, 1);
        # each step rewrites slot (S - 1) % slots of every layer, then
        # reads them all
        s = shape.seq_len
        t0 = time.perf_counter()
        ck, cv, _ = init_cache(cfg, rows, s, device=dev)
        for li in range(n_layers):
            ck[li].normal_(generator=gen)
            cv[li].normal_(generator=gen)
        torch.cuda.synchronize()
        t_fill = time.perf_counter() - t0
        caches = (ck, cv, torch.full((rows,), min(s - 1, ck.shape[2]),
                                     dtype=torch.int32, device=dev))
        first = torch.from_numpy(lm_batch(1, rows, 1, cfg.vocab,
                                          seed=SEED)[0]).to(dev)
        logits = torch.zeros((rows, cfg.vocab), device=dev)
        at_end = lambda i: torch.full((rows,), s - 1, device=dev)  # noqa
        lm_decode(params, cfg, caches, logits, at_end, 2, "auto",
                  [first] * 2)                                   # warm-up
        runs, agreed = run_both(shape.name, caches, logits, at_end, [first])
        steps, med = step_log(runs, rows)
        tok = runs["auto"][1][-1]
        lm_busy_log(f"{cfg.name} {shape.name}", lambda i: decode_step(
            params, cfg, tok, at_end(i), caches), med)
        log(f"{cfg.name} {shape.name}: B={rows} (cell {shape.global_batch}) "
            f"at position {s - 1}, cache {ck.shape[2]} slots, "
            f"{2 * ck.numel() * ck.element_size() / 1e9:.2f} GB (fill "
            f"{t_fill:.2f} s) | {steps} | {agreed} | launches auto "
            f"{n_steps * n_layers * 2}, ref 0 | {card}")
        del ck, cv, caches, runs
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{cfg.name}: peak device memory {peak:.2f} GiB | flash_decode "
        f"launches {total} on the bf16 auto runs | took "
        f"{time.perf_counter() - t_arch:.1f} s | {card}")
    del params
    return total


def disk_index(dev, card, built, served, cfg, batch, disk_n,
               reset_counts, read_counts) -> dict:
    """Phase 8: the paper's disk-resident index on the card.  `built` is
    phase 5's BAMG (dataset, graph, codec, codes, nav); `served` its ids
    under phase 5's engine (`cfg`, batches of `batch`).  Returns the
    launches of the kernels this phase ran, by kernel, and the `disk_n`
    corpus with the BAMG built on it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.core.engine import (BAMGIndex, BAMGParams, DiskANNIndex,
                                         DiskANNParams, StarlingIndex,
                                         StarlingParams,
                                         _make_decoupled_store)
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.serve import BatchedANNEngine
    from repro_torch.utils.faults import FaultSpec, RetryPolicy

    t_phase = time.perf_counter()
    ds, graph, codec, codes, nav = built
    # 250 queries: each is a host walk of 6 to 16 ms, six passes of them
    nq = 250
    queries, gt = ds.queries[:nq], ds.gt[:nq, :10]
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # 1. phase 5's graph, codec, codes and nav graph in the port's index,
    # through its constructor and `_make_decoupled_store`, as `load` does
    t0 = time.perf_counter()
    p = BAMGParams()
    if (graph.capacity, graph.alpha, graph.beta) != (29, p.alpha, p.beta):
        raise AssertionError(f"phase 5's BAMG is not BAMGParams' defaults: "
                             f"{graph.capacity}, {graph.alpha}, {graph.beta}")
    idx = BAMGIndex(ds.base, graph, codec, codes.cpu().numpy(),
                    _make_decoupled_store(ds.base, graph, nav, p), nav, p)
    st = idx.store
    log(f"disk index: N={len(ds.base)} d={ds.base.shape[1]} | "
        f"{st.m} graph blocks of {st.capacity} nodes ({st.record_bytes} B "
        f"records), {len(st.vector_dev)} vector blocks "
        f"({st.vecs_per_vblock} vectors a block) | index "
        f"{idx.index_bytes() / 2 ** 20:.1f} MiB on the simulated disk, "
        f"{idx.memory_bytes() / 2 ** 20:.2f} MiB in memory | layout "
        f"{time.perf_counter() - t0:.2f} s")

    def show(name, s, wall_ms):
        log(f"disk {name}: recall@10 {s.recall:.4f} | mean NIO "
            f"{s.mean_nio:.3f} (graph {s.mean_graph_reads:.3f}, vector "
            f"{s.mean_vector_reads:.3f}) | hops {s.mean_hops:.2f} | n_dist "
            f"{s.mean_n_dist:.2f} | n_pq {s.mean_n_pq:.1f} | cache hit rate "
            f"{s.cache_hit_rate:.4f} | cost model qps {s.qps:.1f}, "
            f"qps_pipelined {s.qps_pipelined:.1f} (service "
            f"{s.mean_service_us:.1f} us, serial {s.mean_serial_us:.1f} us "
            f"a query) | host {wall_ms:.3f} ms a query | {card}")

    def per_query(index, l, tables):
        return [index.search(q, 10, l, table=t)
                for q, t in zip(queries, tables)]

    # 2. the disk search, default I/O: LRU, 256 + 256 blocks cached, qd 1,
    # caches dropped before each query
    reset_counts()
    t0 = time.perf_counter()
    tables = engine._tables(idx.codec, queries)
    t_tables = time.perf_counter() - t0
    stats = {}
    for l in (64, 128):
        t0 = time.perf_counter()
        stats[l] = idx.search_batch(queries, 10, l, gt=gt)
        show(f"BAMG L={l}", stats[l],
             (time.perf_counter() - t0) * 1e3 / nq)
    log(f"  ADC tables of {nq} queries: one adc_tables call on "
        f"{idx.device}, {tables.nbytes / 2 ** 20:.2f} MiB to the host, "
        f"{t_tables * 1e3:.2f} ms")
    clean = per_query(idx, 64, tables)
    again = engine._aggregate(clean, gt, 10, idx.cost)
    if dataclasses.asdict(again) != dataclasses.asdict(stats[64]):
        raise AssertionError("search_batch differs from its queries' "
                             "search results")
    bad = [i for i, r in enumerate(clean)
           if r.nio != r.graph_reads + r.vector_reads]
    if bad:
        raise AssertionError(f"NIO != graph + vector reads on {len(bad)} "
                             f"queries")
    idx.configure_io(qd=4, batch_io=True)
    t0 = time.perf_counter()
    piped = per_query(idx, 64, tables)
    wall = (time.perf_counter() - t0) * 1e3 / nq
    show("BAMG L=64 qd=4 batch_io", engine._aggregate(piped, gt, 10,
                                                      idx.cost), wall)
    for i, (a, b) in enumerate(zip(piped, clean)):
        if (not np.array_equal(a.ids, b.ids) or a.nio != b.nio
                or a.cache_hits != b.cache_hits):
            raise AssertionError(f"qd=4 batch_io changed query {i}: ids, "
                                 f"NIO or cache hits")
        if a.service_us > a.serial_us + 1e-6:
            raise AssertionError(f"query {i}: pipelined service exceeds "
                                 f"the serial time")
    idx.configure_io(qd=1, batch_io=False)
    idx.configure_io(faults=FaultSpec(), retry=RetryPolicy(budget=4),
                     timeout_us=10_000.0, hedge_us=200.0)
    zero = per_query(idx, 64, tables)
    for i, (a, b) in enumerate(zip(zero, clean)):
        if not all(np.array_equal(u, v) for u, v in zip(
                dataclasses.astuple(a), dataclasses.astuple(b))):
            raise AssertionError(f"a zero-rate fault plan changed query {i}")
    idx.configure_io(faults=FaultSpec(read_error_rate=0.01), fault_seed=5,
                     retry=None, timeout_us=None, hedge_us=None)
    t0 = time.perf_counter()
    hurt = per_query(idx, 64, tables)
    wall = (time.perf_counter() - t0) * 1e3 / nq
    same = np.mean([np.array_equal(a.ids, b.ids)
                    for a, b in zip(hurt, clean)])
    hs = engine._aggregate(hurt, gt, 10, idx.cost)
    show("BAMG L=64 1% transient read errors", hs, wall)
    log(f"  faults: a zero-rate plan (retry, timeout and hedge armed) is "
        f"bit-identical to the clean disk on all {nq} queries | 1% read "
        f"errors (seed 5, default retry): {same:.2%} of queries return the "
        f"clean ids, degraded {hs.degraded_fraction:.4f}, retries "
        f"{hs.mean_retries:.3f} a query")
    if same < 0.95:
        raise AssertionError(f"1% read errors: only {same:.2%} of queries "
                             f"kept the clean ids")
    idx.configure_io(faults=None)
    add(read_counts())

    # 3. save, load on the card, serve the same index
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    idx.save(str(out / "bamg.npz"))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = BAMGIndex.load(str(out / "bamg.npz"))
    t_load = time.perf_counter() - t0
    if back.device != dev:
        raise AssertionError(f"load put the codebooks on {back.device}")
    for i, q in enumerate(queries[:64]):
        r = back.search(q, 10, 64, table=tables[i])
        if not np.array_equal(r.ids, clean[i].ids) or r.nio != clean[i].nio:
            raise AssertionError(f"the loaded index differs on query {i}")
    log(f"  save {t_save:.2f} s ({(out / 'bamg.npz').stat().st_size / 2 ** 20:.1f}"
        f" MiB npz), load on {back.device} {t_load:.2f} s: 64 queries give "
        f"the same ids and NIO")
    reset_counts()
    eng = BatchedANNEngine.from_index(back, cfg)
    ids = np.concatenate([eng.search_batch(ds.queries[s:s + batch], 10)[0]
                          for s in range(0, len(ds.queries), batch)])
    n_auto = read_counts()
    add(n_auto)
    np.testing.assert_array_equal(ids, served["bamg", "auto"][0])
    if n_auto["beam_hops"] < 1 or n_auto["pq_adc"] < 1:
        raise AssertionError(f"from_index under auto: launches {n_auto}")
    reset_counts()
    eng = BatchedANNEngine.from_index(
        back, dataclasses.replace(cfg, backend="cuda"))
    ids_cuda = np.concatenate([eng.search_batch(ds.queries[s:s + batch],
                                                10)[0]
                               for s in range(0, 4 * batch, batch)])
    n_cuda = read_counts()
    add(n_cuda)
    np.testing.assert_array_equal(ids_cuda, served["bamg", "ref"][0][:4 * batch])
    if n_cuda["pq_adc_rowwise"] < 1:
        raise AssertionError(f"from_index under cuda: launches {n_cuda}")
    log(f"  from_index: auto gives phase 5's ids on all {len(ids)} queries "
        f"(launches {n_auto}); cuda gives ref's on {4 * batch} (launches "
        f"{n_cuda})")
    del eng, back

    # 4. the paper's comparison at equal settings: BAMG, DiskANN and
    # Starling built on the card from one corpus, searched at L = 64
    t0 = time.perf_counter()
    dd = paper_dataset("sift-like", n=disk_n, nq=nq, seed=SEED, device=dev)
    log(f"comparison corpus: sift-like N={disk_n} d={dd.base.shape[1]}, "
        f"{nq} queries, exact top-10, {time.perf_counter() - t0:.2f} s")
    for name, cls, params in (("BAMG", BAMGIndex, BAMGParams()),
                              ("DiskANN", DiskANNIndex, DiskANNParams()),
                              ("Starling", StarlingIndex, StarlingParams())):
        reset_counts()
        t0 = time.perf_counter()
        built_idx = cls.build(dd.base, params)
        t_build = time.perf_counter() - t0
        n_build = read_counts()
        add(n_build)
        if n_build["beam_hops_l2"] < 1:
            raise AssertionError(f"{name}'s build did not run beam_hops_l2: "
                                 f"{n_build}")
        t0 = time.perf_counter()
        s = built_idx.search_batch(dd.queries, 10, 64, gt=dd.gt[:, :10])
        show(f"{name} N={disk_n} L=64", s,
             (time.perf_counter() - t0) * 1e3 / nq)
        if cls is BAMGIndex:
            small = (dd, built_idx)
        log(f"  {name} build: {t_build:.2f} s on {built_idx.device} "
            f"(build_backend {params.build_backend}), beam_hops_l2 launches "
            f"{n_build['beam_hops_l2']}, mean degree "
            f"{built_idx.degree_stats()['total']:.3f}, index "
            f"{built_idx.index_bytes() / 2 ** 20:.1f} MiB")
    log(f"phase 8 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches, small


def fleet_serving(dev, card, main, cfg, batch, r, n_cands, disk_n,
                  reset_counts, read_counts) -> dict:
    """Phase 9: the serving fleet at SIFT1M scale.  `main` is phase 4's
    (dataset, vectors on the card, codec, codes); `cfg` and `batch` its
    engine and batch, `r` and `n_cands` its graph width and entry
    candidates.  Returns the launches of the kernels this phase ran, by
    kernel."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.distances import knn_graph, recall_at_k
    from repro_torch.core.engine import BAMGParams
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.serve import (BatchedANNEngine, BeamTier, Scheduler,
                                   SchedulerConfig, ServeRuntime,
                                   make_requests, summarize)
    from repro_torch.serve.runtime import merge_topk, pad_cols

    t_phase = time.perf_counter()
    ds, x, codec, codes = main
    n, k, n_shards, n_rep = len(ds.base), 10, 4, 2
    queries = ds.queries
    n_batches = -(-len(queries) // batch)
    launches = {}

    def add(counts):
        for name, v in counts.items():
            launches[name] = launches.get(name, 0) + v

    # 1. round-robin shards, each with its own exact kNN graph at phase
    # 4's width and phase 4's codec and codes sliced to the shard
    t0 = time.perf_counter()
    vids = [np.arange(s, n, n_shards) for s in range(n_shards)]
    shard_arrays = []
    for v in vids:
        rows = torch.as_tensor(v, device=dev)
        xs = x[rows].contiguous()
        shard_arrays.append(dict(
            x=xs, adj=knn_graph(xs, r), codes=codes[rows].contiguous(),
            codebooks=codec.codebooks,
            entry_cands=np.linspace(0, len(v) - 1, n_cands, dtype=np.int64)))
    torch.cuda.synchronize()
    log(f"fleet: N={n} in {n_shards} round-robin shards of "
        f"{[len(v) for v in vids]} x {n_rep} replicas on one card | exact "
        f"kNN graph R={r} per shard, phase 4's codec and codes sliced | "
        f"set-up {time.perf_counter() - t0:.2f} s | {card}")

    def runtime(backend):
        engines = [BatchedANNEngine(a, dataclasses.replace(cfg,
                                                           backend=backend),
                                    device=dev) for a in shard_arrays]
        return ServeRuntime(vids, engines, n_replicas=n_rep)

    def serve(rt, qs, b=batch, **kw):
        """Serve `qs` in batches of `b`: ids, dists, statuses, ms a batch."""
        ids, dists, stats, times = [], [], [], []
        for s in range(0, len(qs), b):
            t0 = time.perf_counter()
            i, d, st = rt.serve_batch(qs[s:s + b], k, with_status=True, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
            ids.append(i)
            dists.append(d)
            stats.append(st)
        return np.concatenate(ids), np.concatenate(dists), stats, times

    def oracle(rt, skip=()):
        """tests/test_runtime.py's legacy scatter-gather loop over the
        replica-0 engines, batch by batch."""
        out_i, out_d = [], []
        for s in range(0, len(queries), batch):
            q = queries[s:s + batch]
            all_i, all_d = [], []
            for sh, eng in enumerate(rt.engines):
                if sh in skip:
                    continue
                i, d = eng.search_batch(q, k)
                all_i.append(rt._lut[sh][i])
                all_d.append(d)
            gd, gi = merge_topk(np.concatenate(all_d, 1), k)
            gids = np.take_along_axis(pad_cols(np.concatenate(all_i, 1), k,
                                               -1), gi, axis=1)
            out_i.append(np.where(np.isfinite(gd), gids, -1))
            out_d.append(gd)
        return np.concatenate(out_i), np.concatenate(out_d)

    def healthy(rt, what, errors=0):
        """Every shard and replica up, and no more shard errors in all
        than the `errors` a deliberate fault left (on a clean run none,
        and no error message anywhere)."""
        h = rt.health()
        n_err = sum(p["errors"] for p in h["per_shard"])
        down = [(s, i) for s, g in enumerate(h["replicas"])
                for i, up in enumerate(g) if not up]
        msgs = ([p["last_error"] for p in h["per_shard"] if p["last_error"]]
                + [rep.last_error for g in rt.placement.shard_replicas
                   for rep in g if rep.last_error])
        if (h["shards_down"] or down or n_err > errors
                or (msgs and not errors)):
            raise AssertionError(f"{what}: shards down {h['shards_down']}, "
                                 f"replicas down {down}, errors {n_err}, "
                                 f"{msgs}")

    # 2. the clean run under auto, then ref
    rts = {b: runtime(b) for b in ("auto", "ref")}
    rt = rts["auto"]
    res, cnt = {}, {}
    for backend, r_ in rts.items():
        reset_counts()
        res[backend] = serve(r_, queries)
        cnt[backend] = read_counts()
        healthy(r_, f"clean fleet under {backend}")
        if any(st.degraded.any() for st in res[backend][2]):
            raise AssertionError(f"{backend}: a clean batch was degraded")
    add(cnt["auto"])
    want = n_shards * n_batches
    if (cnt["auto"]["beam_hops"] != want or cnt["auto"]["pq_adc"] != want
            or cnt["auto"]["pq_adc_rowwise"] or cnt["auto"]["beam_hops_l2"]):
        raise AssertionError(f"clean fleet under auto: launches "
                             f"{cnt['auto']}, expected beam_hops = pq_adc "
                             f"= {n_shards} shards x {n_batches} batches")
    if any(cnt["ref"].values()):
        raise AssertionError(f"ref launched kernels: {cnt['ref']}")
    ids, dists = res["auto"][:2]
    np.testing.assert_array_equal(ids, res["ref"][0])
    np.testing.assert_allclose(dists, res["ref"][1], rtol=1e-5, atol=1e-5)
    oi, od = oracle(rt)
    np.testing.assert_array_equal(ids, oi)
    np.testing.assert_array_equal(dists, od)
    if (ids < 0).any():
        raise AssertionError("a query returned fewer than 10 ids")
    exact = ((x[torch.as_tensor(ids, device=dev)]
              - torch.as_tensor(queries, device=dev)[:, None, :]) ** 2).sum(-1)
    torch.testing.assert_close(torch.as_tensor(dists, device=dev), exact,
                               rtol=1e-4, atol=0.0)
    times = res["auto"][3]
    med = statistics.median(times)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(rt, queries)
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    busy = sum(a.self_device_time_total for a in avgs) / 1e3 / n_batches
    mem = sum(e.memory_bytes() for e in rt.engines)
    log(f"fleet auto: recall@10 {recall_at_k(ids, ds.gt, 10):.4f} (global "
        f"truth) | per-batch median {med:.3f} ms (B={batch}, {n_shards} "
        f"shard calls) | QPS {batch / med * 1e3:.1f} (median), "
        f"{len(queries) / (sum(times) / 1e3):.1f} (all {n_batches} batches) "
        f"| card busy {busy:.4f} ms per batch = {busy / med:.2%} of the "
        f"median ({sum(a.count for a in avgs) / n_batches:.1f} kernel runs "
        f"a batch; profiled wall {wall * 1e3 / n_batches:.3f} ms a batch) | "
        f"launches {cnt['auto']} | resident {mem / 2 ** 30:.3f} GiB for "
        f"{n_shards * n_rep} replicas | {card}")
    log(f"fleet ref: per-batch median {statistics.median(res['ref'][3]):.3f}"
        f" ms | auto == ref (ids equal, dists within 1e-5) == the legacy "
        f"scatter-gather (bitwise); dists exact to 1e-4 relative")

    # 3. shard 1 down, a failing replica, tombstones
    rt.mark_down(1)
    i1, d1, st1, _ = serve(rt, queries)
    oi, od = oracle(rt, skip={1})
    np.testing.assert_array_equal(i1, oi)
    np.testing.assert_array_equal(d1, od)
    if not all(st.degraded.all() and st.shards_down == (1,) for st in st1):
        raise AssertionError("shard 1 down: a batch was not flagged degraded")
    rt.mark_up(1)
    rt.engines[2].inject_fault()           # replica 0 of shard 2
    i2, d2, st2, _ = serve(rt, queries)
    np.testing.assert_array_equal(i2, ids)
    np.testing.assert_array_equal(d2, dists)
    h = rt.health()
    if h["replicas"][2] != [False, True] or h["shards_up"] != n_shards:
        raise AssertionError(f"failover: replicas {h['replicas']}, "
                             f"shards up {h['shards_up']}")
    errors = h["per_shard"][2]["errors"]
    rt.engines[2].heal()
    rt.mark_up(2)
    h = rt.health()
    if h["shards_up"] != n_shards or not all(all(g) for g in h["replicas"]):
        raise AssertionError(f"after mark_up: {h}")
    dead = set(ids[:batch, :3].ravel().tolist())
    i3, _, _, _ = serve(rt, queries, exclude=dead)
    if set(i3.ravel().tolist()) & dead:
        raise AssertionError("an excluded id came back")
    healthy(rt, "after the fault checks", errors)
    log(f"fleet faults: shard 1 down == the oracle without it (bitwise), "
        f"every row degraded | shard 2 replica 0 faulted: answers "
        f"unchanged, replica marked down ({errors} error(s)), all up after "
        f"mark_up | {len(dead)} excluded ids never returned")

    # 4. the scheduler: a load sweep at 0.5x, 1x and 1.5x the fleet's
    # micro-batch throughput
    mb = 32
    mb_i, mb_d, _, mb_t = serve(rt, queries, b=mb)
    med_mb = statistics.median(mb_t) / 1e3
    rate = mb / med_mb
    scfg = SchedulerConfig(k=k, max_batch=mb, slo=10 * med_mb,
                           tiers=(BeamTier(), BeamTier(l=16, max_hops=8)))
    log(f"scheduler: micro-batch B={mb} median {med_mb * 1e3:.3f} ms = "
        f"{rate:.1f} QPS | slo {scfg.slo * 1e3:.3f} ms (10x) | tiers "
        f"{scfg.tiers}")
    for f in (0.5, 1.0, 1.5):
        reqs = make_requests(queries, qps=f * rate, slo=scfg.slo, n=2048,
                             seed=SEED)
        reset_counts()
        done = Scheduler(rt, scfg).run(reqs)
        add(read_counts())
        s = summarize(done)
        log(f"scheduler {f}x ({f * rate:.1f} QPS offered, 2048 Poisson "
            f"requests): p50 {s['p50_ms']:.3f} ms | p99 {s['p99_ms']:.3f} ms"
            f" | achieved {s['achieved_qps']:.1f} QPS | deadline hit "
            f"{s['deadline_hit']:.4f} | degraded {s['degraded_frac']:.4f} | "
            f"shrunk {s['shrunk_frac']:.4f} | {card}")
        if f == 0.5:
            full = [c for c in done if c.tier == 0]
            for c in full:
                j = c.rid % len(queries)
                if (not np.array_equal(c.ids, mb_i[j])
                        or not np.array_equal(c.dists, mb_d[j])):
                    raise AssertionError(f"0.5x: request {c.rid} differs "
                                         f"from an unscheduled batch")
            log(f"  0.5x: all {len(full)} tier-0 completions equal the "
                f"unscheduled serve_batch of their query (bitwise)")
    healthy(rt, "after the load sweep", errors)
    del rts, rt, shard_arrays

    # 5. the BAMG fleet: `ServeRuntime.build` at --disk-n (a BAMG per
    # 250,000-point shard does not fit the call)
    dd = paper_dataset("sift-like", n=disk_n, nq=len(queries), seed=SEED,
                       device=dev)
    reset_counts()
    t0 = time.perf_counter()
    brt = ServeRuntime.build(dd.base, n_shards, params=BAMGParams(),
                             config=cfg, n_replicas=n_rep)
    t_build = time.perf_counter() - t0
    n_build = read_counts()
    add(n_build)
    if n_build["beam_hops_l2"] < n_shards:
        raise AssertionError(f"fleet build launches {n_build}")
    reset_counts()
    bi, bd, _, bt = serve(brt, dd.queries)
    n_serve = read_counts()
    add(n_serve)
    if n_serve["beam_hops"] != n_shards * n_batches:
        raise AssertionError(f"BAMG fleet launches {n_serve}")
    healthy(brt, "BAMG fleet")
    ref_rt = ServeRuntime(brt.shard_vids, [
        BatchedANNEngine.from_index(i, dataclasses.replace(cfg,
                                                           backend="ref"))
        for i in brt.host_indexes])
    ri, rd, _, _ = serve(ref_rt, dd.queries)
    np.testing.assert_array_equal(bi, ri)
    np.testing.assert_allclose(bd, rd, rtol=1e-5, atol=1e-5)
    log(f"BAMG fleet (reduced: N={disk_n}, {n_shards} shards of "
        f"{disk_n // n_shards}; a BAMG per 250,000-point shard does not fit "
        f"the call): ServeRuntime.build {t_build:.2f} s, beam_hops_l2 "
        f"launches {n_build['beam_hops_l2']} | recall@10 "
        f"{recall_at_k(bi, dd.gt, 10):.4f} | per-batch median "
        f"{statistics.median(bt):.3f} ms | auto == ref (ids equal, dists "
        f"within 1e-5) | {card}")
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches


def deploy_fresh(dev, card, index, ds, cfg, batch, disk_n, n_insert,
                 reset_counts, read_counts) -> dict:
    """Phase 10: deployment at `disk_n`, freshness on `index` (phase 8's
    BAMG at `disk_n` over `ds`, served by `cfg` in batches of `batch`)
    with `n_insert` inserts, and the exact BMRNG.  Returns the launches of the
    kernels this phase ran, by kernel."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.block_assign import bnf_blocks
    from repro_torch.core.bmrng import (build_bmrng, io_length,
                                        monotonic_io_path)
    from repro_torch.core.distances import exact_knn, knn_graph, recall_at_k
    from repro_torch.core.engine import BAMGParams
    from repro_torch.data.synthetic import (PAPER_REGIMES, clustered_vectors,
                                            paper_dataset)
    from repro_torch.index.delta import FreshService
    from repro_torch.serve import (BatchedANNEngine, BlueGreenEngine,
                                   DeploymentManager)
    from repro_torch.utils.faults import IntegrityError

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "deploy"
    shutil.rmtree(root, ignore_errors=True)
    launches = {}

    def add(counts):
        for name, v in counts.items():
            launches[name] = launches.get(name, 0) + v

    def serve(engine, qs):
        return np.concatenate([engine.search_batch(qs[s:s + batch], 10)[0]
                               for s in range(0, len(qs), batch)])

    def must_raise(exc, fn, *args, **kwargs):
        try:
            fn(*args, **kwargs)
        except exc as e:
            return e
        raise AssertionError(f"{fn.__name__}{args} did not raise "
                             f"{exc.__name__}")

    # 1. blue/green deployment at --disk-n
    dd = paper_dataset("sift-like", n=disk_n, nq=1000, seed=SEED, device=dev)
    gt = dd.gt[:, :10]
    dm = DeploymentManager(str(root / "blue_green"))

    def deploy(build_id, seed, min_recall):
        reset_counts()
        t0 = time.perf_counter()
        try:
            return dm.deploy(dd.base, build_id, dd.queries, gt,
                             params=BAMGParams(seed=seed), k=10,
                             min_recall=min_recall, config=cfg)
        finally:
            n = read_counts()
            add(n)
            log(f"  deploy {build_id}: {time.perf_counter() - t0:.2f} s "
                f"(build, publish, verify, validate, promote when it "
                f"passes) | launches {n}")
            if n["beam_hops_l2"] < 1 or n["beam_hops"] < 1 or n["pq_adc"] < 1:
                raise AssertionError(f"deploy {build_id}: launches {n}")

    man1 = deploy("v1", SEED, 0.2)
    bg = BlueGreenEngine(dm, cfg)
    ids1 = serve(bg, dd.queries)
    err = must_raise(ValueError, deploy, "bad", SEED + 1, 1.01)
    if "failed validation" not in str(err) or dm.active() != "v1" \
            or "bad" not in dm.builds():
        raise AssertionError(f"a failed deploy changed ACTIVE: {err}")
    with open(root / "blue_green" / "builds" / "bad" / "index.npz",
              "r+b") as f:
        f.seek(64)
        f.write(b"\x00\x01\x02\x03")
    must_raise(IntegrityError, dm.verify, "bad")
    must_raise(IntegrityError, dm.load, "bad")
    man2 = deploy("v2", SEED + 2, 0.2)
    if not np.array_equal(serve(bg, dd.queries), ids1):
        raise AssertionError("the blue engine changed before refresh")
    if not bg.refresh() or bg.build_id != "v2" or bg.refresh():
        raise AssertionError("refresh did not swap to v2 once")
    ids2 = serve(bg, dd.queries)
    np.testing.assert_array_equal(
        ids2, serve(BatchedANNEngine.from_index(dm.load("v2"), cfg),
                    dd.queries))
    if dm.rollback() != "v1" or not bg.refresh() or bg.build_id != "v1":
        raise AssertionError("rollback did not return to v1")
    np.testing.assert_array_equal(serve(bg, dd.queries), ids1)
    changed = np.mean((ids2 != ids1).any(1))
    log(f"deploy (N={disk_n}): v1 validated recall@10 "
        f"{man1.meta['validated_recall']:.4f}, v2 "
        f"{man2.meta['validated_recall']:.4f} (min_recall 0.2) | a build "
        f"at min_recall 1.01 raised and left ACTIVE v1 | a tampered "
        f"artifact raised IntegrityError on verify and load | refresh "
        f"swapped to v2, whose ids it serves ({changed:.2%} of rows differ "
        f"from v1) | rollback to v1 serves v1's ids | "
        f"history {dm.history()} | {card}")

    # 2. freshness on phase 8's --disk-n BAMG: bootstrap, inserts, deletes,
    # serve, consolidate, serve again
    queries = ds.queries
    nq = len(queries)
    n0, d = ds.base.shape
    svc = FreshService(str(root / "fresh"), params=BAMGParams(), config=cfg)
    t0 = time.perf_counter()
    svc.bootstrap(index=index)
    t_boot = time.perf_counter() - t0
    ins = clustered_vectors(n_insert, d, PAPER_REGIMES["sift-like"][
        "n_clusters"], seed=SEED + 1)
    rng = np.random.default_rng(SEED)
    top = np.unique(ds.gt[:nq, :10])
    n_dead = min(n0 // 100, len(top))
    dead = rng.choice(top, size=n_dead, replace=False)
    t0 = time.perf_counter()
    ext = svc.insert_batch(ins)
    t_ins = time.perf_counter() - t0
    t0 = time.perf_counter()
    for e in dead.tolist():
        svc.delete(e)
    t_del = time.perf_counter() - t0
    st = svc.stats()
    log(f"fresh: bootstrap from phase 8's --disk-n BAMG (N={n0}, nothing "
        f"rebuilt; reduced from 100,000 so that the smoke fits its call) "
        f"{t_boot:.2f} s | {n_insert} inserts (another seed of the "
        f"generator) {t_ins:.2f} s = {n_insert / t_ins:.1f} inserts/s "
        f"(host) | {n_dead} deletes of the queries' true top-10 "
        f"{t_del * 1e3:.1f} ms | overlay {st['overlay_fraction']:.4f} of the "
        f"base, {st['overlay_memory_bytes'] / 2 ** 20:.1f} MiB | {card}")
    dead_set = set(dead.tolist())
    wide = dict(l=512, max_hops=1024)  # a wide budget for the misses

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def first_hits(find, vecs, rows, **kw):
        """Each of `vecs` queried by itself through `find` (batched, by
        `batch`): whether its own id `rows` comes back first at distance
        0."""
        if not len(vecs):
            return np.zeros(0, bool)
        got = [find(vecs[s:s + batch], 10, **kw) for s in range(0, len(vecs),
                                                                batch)]
        ids = np.concatenate([i[:, 0] for i, _ in got])
        return (ids == rows) & (np.concatenate([d[:, 0] for _, d in got]) == 0)

    def check(stage, overlay):
        """Serve the live corpus and check it.  While the overlay holds
        the inserts (`overlay`), the exact delta scan must return every
        one first at distance 0 for its own vector at the served budget.
        The host path walks the overlay's graph, and what it finds at the
        served and the wide `l` is logged.  After consolidation the approximate search serves
        the inserts, and in the reference too the inserts from clusters
        the base lacks can lie beyond the served budget
        (tests/test_torch_deploy_fresh.py::
        test_consolidated_inserts_missed_only_where_reference_misses,
        which ties the plain version to the reference's engine): the
        kernels must then miss exactly the inserts the plain version
        misses, at the served budget and at a wide one (`wide`, an engine
        whose exact re-rank covers its pool; what it still misses is
        logged)."""
        live_x, live_ext = svc.live_corpus()
        gt_ext = live_ext[exact_knn(on_card(live_x), on_card(queries),
                                    10)[1].cpu().numpy()]
        reset_counts()
        t0 = time.perf_counter()
        b_ids = np.concatenate([svc.search_batch(queries[s:s + batch], 10)[0]
                                for s in range(0, nq, batch)])
        t_b = (time.perf_counter() - t0) * 1e3 / nq
        n = read_counts()
        add(n)
        if n["beam_hops"] != -(-nq // batch) or n["pq_adc"] < 1:
            raise AssertionError(f"fresh {stage}: launches {n}")
        t0 = time.perf_counter()
        h_ids = np.stack([svc.search(q, 10, l=cfg.l)[0]
                          for q in queries[:100]])
        t_h = (time.perf_counter() - t0) * 1e3 / 100
        for ids in (b_ids, h_ids):
            if set(ids.ravel().tolist()) & dead_set:
                raise AssertionError(f"fresh {stage}: a deleted id came back")
        found = first_hits(svc.search_batch, ins, ext)
        probe = np.linspace(0, n_insert - 1, min(200, n_insert), dtype=int)

        def host_hits(js, l):
            hits = []
            for j in js.tolist():
                i, dist = svc.search(ins[j], 10, l=l)
                hits.append(bool(i[0] == ext[j] and dist[0] == 0))
            return np.asarray(hits, bool)

        h_found = host_hits(probe, cfg.l)
        h_miss = probe[~h_found]
        h_wide = int(host_hits(h_miss, wide["l"]).sum())
        if overlay and not found.all():
            raise AssertionError(
                f"fresh {stage}: {int((~found).sum())} of {n_insert} "
                f"inserts not first at distance 0 when queried by "
                f"themselves")
        held = "all found (batched)"
        if not overlay:
            ints = np.asarray([svc._int_of_ext[int(e)] for e in ext])
            miss = np.flatnonzero(~found)

            def engine(**kw):
                return BatchedANNEngine.from_index(
                    svc.bg.index, dataclasses.replace(cfg, **kw)).search_batch

            if not np.array_equal(found, first_hits(engine(backend="ref"),
                                                    ins, ints)):
                raise AssertionError(f"fresh {stage}: the kernels' misses "
                                     f"are not the plain version's")
            found_w = {b: first_hits(engine(backend=b, **wide), ins[miss],
                                     ints[miss]) for b in ("auto", "ref")}
            if not np.array_equal(found_w["auto"], found_w["ref"]):
                raise AssertionError(f"fresh {stage}: at l={wide['l']}, "
                                     f"max_hops={wide['max_hops']} the "
                                     f"kernels' misses are not the plain "
                                     f"version's")
            held = (f"the {len(miss)} (batched) missed are the plain "
                    f"version's misses; an engine at l={wide['l']}, "
                    f"max_hops={wide['max_hops']} finds "
                    f"{int(found_w['auto'].sum())} of them, the plain "
                    f"version the same ones")
        first = svc.delta.n_total - n_insert   # inserts: the last rows
        n_ent = int((svc.bg.engine.entry_cands >= first).sum())
        log(f"fresh {stage}: recall@10 on the live corpus "
            f"{recall_at_k(b_ids, gt_ext, 10):.4f} (batched, auto), "
            f"{recall_at_k(h_ids, gt_ext[:100], 10):.4f} (host, 100 "
            f"queries) | batched {t_b:.3f} ms a query, host {t_h:.3f} ms | "
            f"no deleted id returned | inserts first at distance 0 by "
            f"themselves at l={cfg.l}, max_hops={cfg.max_hops}: "
            f"{int(found.sum())} of {n_insert} (batched), "
            f"{int(h_found.sum())} of {len(probe)} (host); {held}; of the "
            f"host's {len(h_miss)}, {h_wide} come back at l={wide['l']} | "
            f"entry candidates among the inserts {n_ent} of "
            f"{len(svc.bg.engine.entry_cands)} | launches {n} | {card}")

    check("before consolidation", overlay=True)
    n_live = svc.n_live
    t0 = time.perf_counter()
    svc.consolidate("gen-1", queries=queries, k=10, min_recall=0.2)
    t_cons = time.perf_counter() - t0
    man = svc.manager.manifest("gen-1")
    if (svc.manager.active() != "gen-1"
            or svc.manager.history() != ["gen-0", "gen-1"]
            or man.meta != {"generation": 1, "n_delta": n_insert,
                            "n_deleted": n_dead}
            or man.n != n_live or svc.n_live != n_live):
        raise AssertionError(f"consolidation lineage: {man}, "
                             f"{svc.manager.history()}")
    ints = np.asarray([svc._int_of_ext[int(e)] for e in ext])
    np.testing.assert_array_equal(svc.delta.vectors(ints), ins)
    keep = np.setdiff1d(np.arange(n0), dead)
    ints = np.asarray([svc._int_of_ext[int(e)] for e in keep])
    np.testing.assert_array_equal(svc.delta.vectors(ints), ds.base[keep])
    if dead_set & set(svc._int_of_ext):
        raise AssertionError("a deleted external id is still mapped")
    log(f"fresh consolidate: {t_cons:.2f} s | stages (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in svc.timings.items())
        + f" | validated recall@10 {svc.last_validation_recall:.4f} (min "
        f"0.2) | promoted gen-1 (history {svc.manager.history()}, meta "
        f"{man.meta}) | external ids stable for all {n_live} live points | "
        f"{card}")
    check("after consolidation", overlay=False)
    shutil.rmtree(root, ignore_errors=True)

    # 3. the exact BMRNG on 400 points of the same generator
    xb = clustered_vectors(400, d, PAPER_REGIMES["sift-like"]["n_clusters"],
                           seed=SEED)
    blocks = bnf_blocks(knn_graph(on_card(xb), 32).cpu().numpy(), 29,
                        seed=SEED)
    t0 = time.perf_counter()
    g = build_bmrng(xb, blocks)
    t_b = time.perf_counter() - t0
    pairs = [rng.choice(400, 2, replace=False).tolist() for _ in range(200)]
    ios = []
    for u, q in pairs:
        path = monotonic_io_path(g.adj, g.dist, g.blocks, u, q)
        if path is None or path[-1] != q:
            raise AssertionError(f"BMRNG: no monotonic I/O path {u} -> {q}")
        dq, seg_end = g.dist[:, q], np.inf
        for a, b in zip(path, path[1:]):
            if not g.adj[a, b]:
                raise AssertionError(f"BMRNG path {u} -> {q}: no edge "
                                     f"{a} -> {b}")
            if g.blocks[a] == g.blocks[b] and not dq[b] < dq[a]:
                raise AssertionError(f"BMRNG path {u} -> {q}: an intra-"
                                     f"block step does not decrease")
            if g.blocks[a] != g.blocks[b]:
                if not dq[a] < seg_end:
                    raise AssertionError(f"BMRNG path {u} -> {q}: a "
                                         f"segment end does not decrease")
                seg_end = dq[a]
        ios.append(io_length(path, g.blocks))
    log(f"BMRNG: n=400 d={d}, BNF blocks of 29 ({len(np.unique(blocks))} "
        f"blocks), distances on {dev} | {int(g.adj.sum())} edges (mean "
        f"out-degree {g.adj.sum() / 400:.2f}) in {t_b:.2f} s | Theorem 1: a "
        f"monotonic I/O path on all {len(pairs)} sampled pairs, mean I/O "
        f"length {np.mean(ios):.2f} blocks | {card}")
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches


# ---------------------------------------------------------------------------
# Training (phase 12)
# ---------------------------------------------------------------------------
# OLMo-1B's model FLOPs a token (forward and backward, remat's recompute
# not counted): 6 x the parameters of its products (all but the input
# embedding, a gather) + 6 x L x S x d of causal attention
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 dense, data sheet


def _timed(step_fn, times, profile_at=None, busy=None):
    """step_fn between two syncs of the card, its host ms appended to
    `times`; the call numbered `profile_at` (0-based) runs under the
    profiler instead, its CUDA time stored in busy["ms"], its kernel runs
    in busy["runs"] and its wall in busy["wall"] (not in `times`)."""
    import torch

    calls = [0]

    def run(state, batch):
        i = calls[0]
        calls[0] += 1
        prof = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
            if i == profile_at else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof:
            out = step_fn(state, batch)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i == profile_at:
            avgs = prof.key_averages()
            busy["ms"] = sum(a.self_device_time_total for a in avgs) / 1e3
            busy["runs"] = sum(a.count for a in avgs)
            busy["wall"] = ms
        else:
            times.append(ms)
        return out
    return run


def _finite_falling(name, losses):
    """Every loss finite and the last below the first."""
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")


def _lm_setup(dev, cfg, b, s, n_steps):
    """(seeded generator on dev, batch_fn, loss_fn, AdamW config) for
    `lm_batch` batches of b x s tokens and n_steps steps."""
    import torch

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.optimizer import AdamWConfig

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def batch_fn(step):
        t, l = lm_batch(step, b, s, cfg.vocab, seed=SEED)
        return {"tokens": torch.from_numpy(t).to(dev),
                "labels": torch.from_numpy(l).to(dev)}

    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"])

    # lr 1e-4: Adam's first steps move every weight by about lr, and at
    # 1e-3 OLMo's loss rose from 11.3 to 19.8 after one step (PERF §6)
    return gen, batch_fn, loss_fn, AdamWConfig(lr=1e-4, warmup_steps=2,
                                               total_steps=n_steps)


def _train_olmo(dev, card, ckpt_dir, reset_counts, no_launches):
    """Phase 12.1: OLMo-1B train_4k at full width and depth, B = 8 x 4,096
    (the cell's 256 cut to 8) in TRAIN_ACCUM 2 micro-batches of 4 x 4,096,
    f32 masters, bf16 compute, remat "full", 64 loss chunks; the first 4
    steps of an 8-step schedule through run_loop, then an async
    checkpoint (8 steps and two checkpoints until the smoke outgrew its
    time limit; the schedule is kept, so the losses are the same).
    Returns the
    parameters of the last checkpoint, restored onto the card (held
    bitwise to the live state)."""
    import torch

    from repro_torch.configs import olmo_1b
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.ft import FTConfig, run_loop
    from repro_torch.train.trainer import init_train_state, make_train_step
    from repro_torch.utils.tree import flatten_with_path, leaves

    cfg = olmo_1b.model_config()
    b, s, n, schedule = 8, 4096, 4, 8
    torch.cuda.reset_peak_memory_stats()
    gen, batch_fn, loss_fn, opt = _lm_setup(dev, cfg, b, s, schedule)
    state, ms_init = synced(lambda: init_train_state(
        init_lm_params(cfg, gen, device=dev), opt))
    times, busy = [], {}
    step = _timed(make_train_step(loss_fn, opt, accum=olmo_1b.TRAIN_ACCUM),
                  times, profile_at=n - 2, busy=busy)
    reset_counts()
    t0 = time.perf_counter()
    state, logged = run_loop(state, step, batch_fn, n,
                             FTConfig(ckpt_dir=str(ckpt_dir), ckpt_every=n,
                                      keep=1), log_every=1)
    t_loop = time.perf_counter() - t0
    no_launches("olmo-1b train_4k")
    losses = [m["loss"] for _, m in logged]
    _finite_falling("olmo-1b train_4k", losses)
    med = statistics.median(times)
    tokens = b * s
    n_mm = cfg.n_params() - cfg.vocab * cfg.d_model
    flop = (6 * n_mm + 6 * cfg.n_layers * s * cfg.d_model) * tokens
    log(f"train olmo-1b train_4k: B={b} x S={s} (accum "
        f"{olmo_1b.TRAIN_ACCUM}), {cfg.n_params()} parameters, f32 masters, "
        f"bf16 compute, remat {cfg.remat}, {cfg.loss_chunks} loss chunks | "
        f"init {ms_init:.1f} ms | losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f" | step median {med:.1f} ms (min {min(times):.1f}, max "
        f"{max(times):.1f}; {len(times)} unprofiled steps) | "
        f"{tokens / med * 1e3:.1f} tokens/s | model FLOPs {flop:.4e} a step "
        f"(6 x {n_mm} x tokens + 6 x L x S x d x tokens) = "
        f"{flop / (med * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{flop / (med * 1e-3) / BF16_FLOP_PER_S:.2%} of 989 TFLOP/s bf16 | "
        f"card busy {busy['ms']:.1f} ms over profiled step {n - 1} "
        f"({busy['runs']} kernel runs; wall {busy['wall']:.1f} ms) = "
        f"{busy['ms'] / med:.2%} of the unprofiled median | loop "
        f"{t_loop:.1f} s, of it outside the steps (the checkpoint at {n}: "
        f"its host copy and write) "
        f"{t_loop - (sum(times) + busy['wall']) / 1e3:.1f} s | peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {card}")
    t0 = time.perf_counter()
    restored, at = ckpt.restore(str(ckpt_dir), state)
    t_restore = time.perf_counter() - t0
    if at != n:
        raise AssertionError(f"latest checkpoint is step {at}, not {n}")
    for (k, a), c in zip(flatten_with_path(state), leaves(restored)):
        if not torch.equal(a, c):
            raise AssertionError(f"restored {k} differs from the live state")
    gb = sum(x.numel() * x.element_size() for x in leaves(restored)) / 1e9
    log(f"  checkpoint: step {at} ({gb:.2f} GB) restored onto the card in "
        f"{t_restore:.1f} s, bitwise the live state")
    return cfg, restored["params"], at


def _serve_trained(dev, card, cfg, params32, at, reset_counts, read_counts):
    """Phase 12.3: the trained parameters cast to bf16, 4 prompts of 512
    tokens prefilled, 8 greedy steps under auto (flash_decode) and ref
    (fed auto's tokens), held to phase 7's rule.  Returns auto's
    launches."""
    import torch

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.transformer import compute_cast

    params = compute_cast(params32, torch.bfloat16)
    pb, p_len, n_new = 4, 512, 8
    prompt = torch.from_numpy(lm_batch(10_000, pb, p_len, cfg.vocab,
                                       seed=SEED)[0]).to(dev)
    logits0, (ck0, cv0, lens), ms_pre = prefill_cache(params, cfg, prompt,
                                                      n_new)
    runs, dec = {}, {}
    for backend in ("auto", "ref"):
        caches = (ck0.clone(), cv0.clone(), lens)
        reset_counts()
        runs[backend] = lm_decode(params, cfg, caches, logits0,
                                  lambda i: torch.full((pb,), p_len + i,
                                                       device=dev),
                                  n_new, backend,
                                  () if backend == "auto" else runs["auto"][1])
        dec[backend] = read_counts()
    expect_launches(dec["auto"], 2 * cfg.n_layers * n_new)
    expect_launches(dec["ref"], 0)
    agreed = lm_agree("trained requests", runs["auto"][0], runs["ref"][0])
    log(f"train -> serve: the step-{at} checkpoint in bf16, B={pb} x "
        f"{p_len} prefill {ms_pre:.1f} ms, {n_new} steps auto median "
        f"{statistics.median(runs['auto'][2]):.3f} ms, ref "
        f"{statistics.median(runs['ref'][2]):.3f} ms | {agreed} | "
        f"flash_decode launches auto {dec['auto']['flash_decode']}, ref 0 "
        f"| {card}")
    return dec["auto"]


def _restart(dev, card, cfg, root, reset_counts, no_launches):
    """Phase 12.2: restart equivalence at OLMo's width with 2 layers, B =
    2 x 1,024: 6 steps uninterrupted (no checkpoint) against
    run_with_recovery failing after step 3 (checkpoints every 2: it
    resumes from step 2); bitwise, else within rtol 1e-6."""
    import dataclasses

    import torch

    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train.ft import FTConfig, run_with_recovery
    from repro_torch.train.trainer import init_train_state, make_train_step
    from repro_torch.utils.tree import flatten_with_path, leaves

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    n2 = 6
    _, batch_fn, loss_fn, opt = _lm_setup(dev, cfg2, 2, 1024, n2)

    def init_fn():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        return init_train_state(init_lm_params(cfg2, g, device=dev), opt)

    step = make_train_step(loss_fn, opt)
    reset_counts()
    t0 = time.perf_counter()
    s_a, _ = _train_steps(step, init_fn(), [batch_fn(i) for i in range(n2)])
    s_b, _, attempts = run_with_recovery(
        init_fn, step, batch_fn, n2,
        FTConfig(ckpt_dir=str(root / "b"), ckpt_every=2, keep=1), fail_at=3)
    t_restart = time.perf_counter() - t0
    no_launches("restart")
    if attempts != 1:
        raise AssertionError(f"restart: {attempts} restarts, expected 1")
    pairs = list(zip(flatten_with_path(s_a), leaves(s_b)))
    differ = [k for (k, a), c in pairs if not torch.equal(a, c)]
    for (k, a), c in pairs:
        torch.testing.assert_close(c, a, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"restart {k}: {m}")
    log(f"restart: {cfg2.n_layers} layers at OLMo's width, B=2 x 1024, "
        f"{n2} steps uninterrupted vs failed after step 3 and resumed from "
        f"step 2 ({attempts} restart): final states "
        + ("bitwise equal" if not differ else
           f"within rtol 1e-6, not bitwise ({len(differ)} of {len(pairs)} "
           f"leaves differ: {differ[:4]})")
        + f" | both runs {t_restart:.1f} s with checkpoints | {card}")


def _tf32(dev, card, cfg, reset_counts, no_launches):
    """Phase 12.4: the f32 loss and gradients at OLMo's width, 2 layers,
    B = 2 x 512, with the caller's TF32 off, on, off: equal bitwise
    wherever the two off runs are; the caller's setting restored."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.utils.tree import flatten_with_path

    cfg4 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_lm_params(cfg4, gen, device=dev)
    t, l = (torch.from_numpy(a).to(dev)
            for a in lm_batch(0, 2, 512, cfg4.vocab, seed=SEED))
    prev = torch.backends.cuda.matmul.allow_tf32
    runs = {}
    reset_counts()
    try:
        for name, tf32 in (("off", False), ("on", True), ("off again", False)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            loss, _, g = loss_and_grads(
                lambda p, bt: lm_loss(p, cfg4, *bt), params, (t, l))
            runs[name] = (loss, dict(flatten_with_path(g)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    no_launches("tf32")
    (l_off, off), (l_on, on), (_, again) = (runs[k] for k in
                                            ("off", "on", "off again"))
    steady = [k for k in off if torch.equal(off[k], again[k])]
    if not torch.equal(l_on, l_off):
        raise AssertionError("TF32: the f32 loss moved with allow_tf32")
    for k in steady:
        if not torch.equal(on[k], off[k]):
            raise AssertionError(f"TF32: gradient {k} moved with allow_tf32")
    for k in set(off) - set(steady):
        torch.testing.assert_close(on[k], off[k], rtol=1e-5,
                                   atol=1e-6 * float(off[k].abs().max()))
    log(f"tf32: f32 loss {float(l_off):.6f} and gradients with allow_tf32 "
        f"on equal to off: {len(steady)} of {len(off)} leaves bitwise "
        f"(deterministic across two off runs); "
        + (f"{sorted(set(off) - set(steady))} differ between the two off "
           f"runs and are held within rtol 1e-5" if len(steady) < len(off)
           else "every leaf deterministic")
        + " | the caller's setting restored: allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32} | {card}")


def _train_steps(step, state, batches):
    """Run step over `batches`; returns (state, [(step, metrics as
    floats)])."""
    logged = []
    for i, b in enumerate(batches):
        state, m = step(state, b)
        logged.append((i + 1, {k: float(v) for k, v in m.items()}))
    return state, logged


def _train_qwen(dev, card, reset_counts, no_launches):
    """Phase 12.5: Qwen1.5-MoE-A2.7B at full width with 2 of its 24 layers
    (the full model's state is 229 GB), B = 4 x 1,024 in TRAIN_ACCUM 2
    micro-batches, 4 steps, no checkpoint."""
    import dataclasses

    import torch

    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train.trainer import init_train_state, make_train_step

    full = qwen2_moe_a2_7b.model_config()
    cfg = dataclasses.replace(full, n_layers=2)
    n, b, s = 4, 4, 1024
    torch.cuda.reset_peak_memory_stats()
    gen, batch_fn, loss_fn, opt = _lm_setup(dev, cfg, b, s, n)
    state, ms_init = synced(lambda: init_train_state(
        init_lm_params(cfg, gen, device=dev), opt))
    times = []
    step = _timed(make_train_step(loss_fn, opt,
                                  accum=qwen2_moe_a2_7b.TRAIN_ACCUM), times)
    batches = [batch_fn(i) for i in range(n)]
    reset_counts()
    _, logged = _train_steps(step, state, batches)
    no_launches("qwen2-moe-a2.7b train")
    _finite_falling("qwen2-moe-a2.7b train", [m["loss"] for _, m in logged])
    med = statistics.median(times)
    log(f"train qwen2-moe-a2.7b: {cfg.n_layers} of {full.n_layers} layers "
        f"at full width ({cfg.n_params()} parameters), B={b} x {s} (accum "
        f"{qwen2_moe_a2_7b.TRAIN_ACCUM}) | init {ms_init:.1f} ms | "
        + " | ".join(f"step {i}: loss {m['loss']:.4f} ce {m['ce']:.4f} aux "
                     f"{m['aux']:.5f}" for i, m in logged)
        + f" | step median {med:.1f} ms ("
        + ", ".join(f"{v:.1f}" for v in times)
        + f") | {b * s / med * 1e3:.1f} tokens/s | peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {card}")


def _train_din(dev, card, reset_counts, no_launches):
    """Phase 12.6: DIN train_batch at its full config, B = 65,536, 8
    steps (lr 1e-3)."""
    import torch

    from repro_torch.configs import din_cfg
    from repro_torch.data.synthetic import din_batch
    from repro_torch.models.recsys import din
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = din_cfg.model_config()
    n, b = 8, 65_536
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = din.init_params(cfg, gen, device=dev, trainable=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=n)
    times = []
    step = _timed(make_train_step(
        lambda p, bt: (din.loss_fn(p, cfg, bt), {}), opt), times)
    keys = ("hist_items", "hist_cates", "hist_len", "target_item",
            "target_cate", "label")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in zip(
        keys, din_batch(i, b, cfg.seq_len, cfg.n_items, cfg.n_cates,
                        seed=SEED))} for i in range(n)]
    reset_counts()
    _, logged = _train_steps(step, init_train_state(model.param_tree(), opt),
                             batches)
    no_launches("din train_batch")
    losses = [m["loss"] for _, m in logged]
    _finite_falling("din train_batch", losses)
    med = statistics.median(times)
    log(f"train din train_batch: B={b}, full config | losses "
        + ", ".join(f"{v:.5f}" for v in losses)
        + f" | step median {med:.2f} ms (min {min(times):.2f}, max "
        f"{max(times):.2f}) | {b / med * 1e3:.1f} rows/s | peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {card}")


def training(dev, card, reset_counts, read_counts) -> dict:
    """Phase 12: training on the card through `train.ft.run_loop` /
    `run_with_recovery`, `train.trainer.make_train_step` and
    `train.checkpoint`, the trained OLMo-1B served by decode, then the
    paper's serve CLI.  Returns the launches of the kernels this phase
    ran, by part; each part's tensors are freed before the next."""
    import shutil

    import torch

    from repro_torch.launch import serve as serve_launch

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "train"
    shutil.rmtree(root, ignore_errors=True)
    launches = {}

    def no_launches(part):
        """Training itself launches no hand-written kernel."""
        launches[part] = read_counts()
        if any(launches[part].values()):
            raise AssertionError(f"{part}: hand-written kernels launched "
                                 f"while training: {launches[part]}")

    torch.cuda.empty_cache()
    cfg, params32, at = _train_olmo(dev, card, root / "olmo", reset_counts,
                                    no_launches)
    torch.cuda.empty_cache()
    launches["olmo-1b serve auto"] = _serve_trained(
        dev, card, cfg, params32, at, reset_counts, read_counts)
    del params32
    torch.cuda.empty_cache()
    _restart(dev, card, cfg, root, reset_counts, no_launches)
    torch.cuda.empty_cache()
    _tf32(dev, card, cfg, reset_counts, no_launches)
    torch.cuda.empty_cache()
    _train_qwen(dev, card, reset_counts, no_launches)
    torch.cuda.empty_cache()
    _train_din(dev, card, reset_counts, no_launches)
    torch.cuda.empty_cache()

    # 12.7: the paper's serve CLI on the card, a BAMG built (the NSG
    # frontier on the exact-L2 hop kernel) and served on the simulated disk
    reset_counts()
    t0 = time.perf_counter()
    serve_launch.main(["--n", "4000", "--queries", "50"])
    launches["launch.serve"] = read_counts()
    if launches["launch.serve"]["beam_hops_l2"] < 1:
        raise AssertionError("launch.serve: the exact-L2 hop kernel did not "
                             "launch")
    log(f"launch.serve: N=4000 built and served on the card in "
        f"{time.perf_counter() - t0:.1f} s | launches "
        f"{launches['launch.serve']}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches


# ---------------------------------------------------------------------------
# Training the GNN family (phase 13)
# ---------------------------------------------------------------------------
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
GNN_STEPS = 8


def gnn_flops(arch_id: str, cfg, n: int, e: int, t: int = 0) -> float:
    """A step's model FLOPs from the config dims (x2 MACs, x3 train): a
    copy of the reference's dry-run count (`launch/cells.py`'s
    `_gnn_flops`)."""
    if arch_id == "graphcast":
        h = cfg.d_hidden
        per_edge = 3 * h * h + h * h        # edge MLP (2 layers) approx
        per_node = 2 * h * h + h * h
        enc = n * (cfg.d_feat * h + h * h) + e * (cfg.d_edge * h + h * h)
        dec = n * (h * h + h * cfg.n_vars)
        return 6.0 * (cfg.n_layers * (e * per_edge + n * per_node) + enc + dec)
    if arch_id in ("nequip", "mace"):
        # per path (l1,l2,l3): radial MLP MACs + CG contraction ~27 mults/C
        c = cfg.channels
        paths = 15  # l<=2 CG paths
        per_edge = 2 * paths * (cfg.n_rbf * cfg.radial_hidden
                                + cfg.radial_hidden * c + 27 * c)
        n_mix = 3 if arch_id == "nequip" else (1 + 2 * paths)
        per_node = 2 * n_mix * 9 * c * c
        return 6.0 * cfg.n_layers * (e * per_edge + n * per_node)
    if arch_id == "dimenet":
        h = cfg.d_hidden
        per_tri = h * cfg.n_bilinear * (1 + h)
        per_edge = 2 * h * h
        return 6.0 * cfg.n_blocks * (t * per_tri + e * per_edge)
    raise ValueError(arch_id)


def _gnn_loss(mod, cfg):
    return lambda p, b: (mod.loss_fn(p, cfg, b), {})


def _to(batch, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _card_equals_cpu(name, mod, cfg, params, batch, dev):
    """One f32 loss-and-gradient evaluation at `params` on the card and
    on the CPU: the losses within rtol 1e-5, every gradient leaf within
    1e-4 x its CPU max + 1e-6.  Returns (card loss, the largest share of
    that bound a leaf's max |card - cpu| reached, leaves)."""
    import torch

    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.utils.tree import flatten_with_path, tree_map

    loss, _, g = loss_and_grads(_gnn_loss(mod, cfg), params, _to(batch, dev))
    cpu = torch.device("cpu")
    c_loss, _, c_g = loss_and_grads(
        _gnn_loss(mod, cfg), tree_map(lambda t: t.detach().cpu(), params),
        _to(batch, cpu))
    torch.testing.assert_close(loss.cpu(), c_loss, rtol=1e-5, atol=0.0,
                               msg=lambda m: f"{name} card vs CPU loss: {m}")
    worst = 0.0
    leaves = flatten_with_path(c_g)
    for (k, a), (_, c) in zip(flatten_with_path(g), leaves):
        err = float((a.cpu() - c).abs().max())
        top = float(c.abs().max())
        if err > 1e-4 * top + 1e-6:
            raise AssertionError(f"{name} card vs CPU gradient {k}: max "
                                 f"|card - cpu| {err} > 1e-4 x {top} + 1e-6")
        worst = max(worst, err / (1e-4 * top + 1e-6))
    return float(loss), worst, len(leaves)


def _gnn_train(name, card, dev, mod, cfg, params, batch_fn, flops, peak,
               per_step, unit, reset_counts, no_launches):
    """GNN_STEPS steps of `make_train_step` (AdamW lr 1e-3, 2 warmup
    steps) from `params`, batch_fn(step) made before each step (its time
    logged apart); losses finite and falling.  Logs the first step, the
    median of the unprofiled others, `per_step` `unit` a second, the
    model FLOP share of `peak`, the busy share and kernel runs over one
    profiled step, and the peak memory."""
    import torch

    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=GNN_STEPS)
    times, busy, t_batch, losses = [], {}, [], []
    step = _timed(make_train_step(_gnn_loss(mod, cfg), opt), times,
                  profile_at=GNN_STEPS - 2, busy=busy)
    state = init_train_state(params, opt)
    reset_counts()
    for s in range(GNN_STEPS):
        t0 = time.perf_counter()
        batch = batch_fn(s)
        t_batch.append(time.perf_counter() - t0)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    no_launches(name)
    _finite_falling(name, losses)
    first, rest = times[0], times[1:]
    med = statistics.median(rest)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train {name}: {GNN_STEPS} steps | losses "
        + ", ".join(f"{v:.5f}" for v in losses)
        + f" | first step {first:.1f} ms | step median {med:.2f} ms (min "
        f"{min(rest):.2f}, max {max(rest):.2f}; {len(rest)} unprofiled "
        f"steps) | {per_step / med * 1e3:.1f} {unit}/s | model FLOPs "
        f"{flops:.4e} a step = {flops / (med * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{flops / (med * 1e-3) / peak:.3%} of {peak / 1e12:.0f} TFLOP/s | "
        f"card busy {busy['ms']:.2f} ms over profiled step {GNN_STEPS - 1} "
        f"({busy['runs']} kernel runs; wall {busy['wall']:.2f} ms) = "
        f"{busy['ms'] / med:.2%} of the median | batches "
        f"{sum(t_batch):.2f} s on the host apart from the steps (max "
        f"{max(t_batch):.2f} s) | peak {peak_gib:.2f} GiB | {card}")
    return losses


def _graph_cells(dev, card, reset_counts, no_launches):
    """Phase 13.1-13.2: graphcast at its full config (bf16 activations,
    f32 masters) on full_graph_sm and on minibatch_lg's fanout samples."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import graphcast_cfg
    from repro_torch.configs.base import GNN_SHAPES, pad_to_multiple
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models.gnn import graphcast
    from repro_torch.models.gnn.sampler import (csr_from_edges,
                                                expected_sizes, padded_sample)

    # --- 13.1 full_graph_sm ------------------------------------------------
    shape = GNN_SHAPES["full_graph_sm"]
    cfg = graphcast_cfg.model_config(d_feat=shape.d_feat)
    g = random_graph(shape.n_nodes, shape.n_edges, d_feat=shape.d_feat,
                     seed=SEED)
    e_pad = pad_to_multiple(shape.n_edges, 16) - shape.n_edges
    pad = -np.ones(e_pad, np.int32)
    batch = {"node_feat": g.node_feat,
             "edge_src": np.concatenate([g.edge_src, pad]),
             "edge_dst": np.concatenate([g.edge_dst, pad]),
             "edge_feat": np.concatenate(
                 [g.edge_feat, np.zeros((e_pad, cfg.d_edge), np.float32)]),
             "targets": np.random.default_rng(SEED).normal(
                 size=(shape.n_nodes, cfg.n_vars)).astype(np.float32)}
    n, e = len(g.node_feat), len(batch["edge_src"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    reset_counts()
    l32, worst, n_leaves = _card_equals_cpu(
        "graphcast full_graph_sm f32, 2 layers", graphcast, cfg2,
        graphcast.init_params(cfg2, gen, device=dev), batch, dev)
    no_launches("graphcast card vs CPU")
    log(f"graphcast card vs CPU: f32, {cfg2.n_layers} of {cfg.n_layers} "
        f"layers at full width on full_graph_sm: loss {l32:.7f} within rtol "
        f"1e-5 of the CPU's; {n_leaves} gradient leaves, each within its "
        f"bound (the worst at {worst:.2%} of 1e-4 x max |cpu| + 1e-6) | "
        f"{card}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = graphcast.init_params(cfg, gen, device=dev)
    on_card = _to(batch, dev)
    with torch.no_grad():
        f32_0 = float(graphcast.loss_fn(
            params, dataclasses.replace(cfg, dtype="float32"), on_card))
    log(f"graphcast full_graph_sm: N={n}, E={e} ({e_pad} -1 pads), d_feat "
        f"{cfg.d_feat}, {cfg.n_layers} layers, d_hidden {cfg.d_hidden}, "
        f"{cfg.dtype} activations over f32 masters; the step-0 parameters' "
        f"loss in float32 {f32_0:.5f}")
    losses = _gnn_train(
        "graphcast full_graph_sm", card, dev, graphcast, cfg, params,
        lambda s: on_card, gnn_flops("graphcast", cfg, n, e), BF16_FLOP_PER_S,
        n, "nodes", reset_counts, no_launches)
    log(f"  graphcast full_graph_sm step-0 loss: {cfg.dtype} {losses[0]:.5f}, "
        f"float32 {f32_0:.5f} (|diff| / f32 {abs(losses[0] - f32_0) / f32_0:.3e})")
    del params, on_card
    torch.cuda.empty_cache()

    # --- 13.2 minibatch_lg: fanout samples of a tenth of the cell's edges --
    shape = GNN_SHAPES["minibatch_lg"]
    cfg = graphcast_cfg.model_config(d_feat=shape.d_feat)
    t0 = time.perf_counter()
    g = random_graph(shape.n_nodes, shape.n_edges // 10, d_feat=shape.d_feat,
                     seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = csr_from_edges(shape.n_nodes, g.edge_src, g.edge_dst)
    t_csr = time.perf_counter() - t0
    fan = list(shape.fanout)
    mn, me = expected_sizes(shape.batch_nodes, fan)
    log(f"graphcast minibatch_lg: base graph N={shape.n_nodes}, "
        f"E={len(g.edge_src)} (the cell's {shape.n_edges} cut to a tenth), "
        f"d_feat {shape.d_feat}: generated in {t_gen:.1f} s, CSR in "
        f"{t_csr:.1f} s | fanout {fan} from {shape.batch_nodes} seeds, padded "
        f"to {mn} nodes x {me} edges")
    sampled = []

    def batch_fn(s):
        b = padded_sample(csr, g.node_feat, g.labels, shape.batch_nodes, fan,
                          step=s, max_nodes=mn, max_edges=me, seed=SEED)
        sampled.append((int((b["edge_src"] >= 0).sum()),
                        int(b["node_feat"].any(1).sum())))
        rng = np.random.default_rng(np.random.SeedSequence([SEED, s, 13]))
        b["edge_feat"] = rng.normal(size=(me, cfg.d_edge)).astype(np.float32)
        b["targets"] = rng.normal(size=(mn, cfg.n_vars)).astype(np.float32)
        del b["labels"], b["seed_mask"]
        return _to(b, dev)

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    _gnn_train("graphcast minibatch_lg", card, dev, graphcast, cfg,
               graphcast.init_params(cfg, gen, device=dev), batch_fn,
               gnn_flops("graphcast", cfg, mn, me), BF16_FLOP_PER_S,
               shape.batch_nodes, "seed nodes", reset_counts, no_launches)
    log("  minibatch_lg samples (real edges, nodes with features): "
        + ", ".join(f"{a}/{b}" for a, b in sampled))
    del g, csr
    torch.cuda.empty_cache()


def _molecule_batch(arch):
    """The molecule cell: molecules_batch(128, 30, 64) (3,840 atoms, 8,192
    edges), species abs(labels) % 8, N(0, 1) energies; dimenet's triplets
    capped at 4 x E."""
    import numpy as np

    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.synthetic import molecules_batch
    from repro_torch.models.gnn.dimenet import build_triplets

    shape = GNN_SHAPES["molecule"]
    mol, gid = molecules_batch(shape.batch_graphs, shape.n_nodes,
                               shape.n_edges, seed=SEED)
    b = {"species": (np.abs(mol.labels) % 8).astype(np.int32),
         "pos": mol.pos, "edge_src": mol.edge_src, "edge_dst": mol.edge_dst,
         "graph_ids": gid,
         "energy": np.random.default_rng(SEED).normal(
             size=shape.batch_graphs).astype(np.float32)}
    if arch == "dimenet":
        b["tri_in"], b["tri_out"] = build_triplets(
            mol.edge_src, mol.edge_dst, max_triplets=4 * len(mol.edge_src))
    return b


def _nequip_equivariance(card, dev, params, cfg, batch):
    """NequIP at its full config on the molecule batch: energies invariant
    under a rotation plus a translation (rtol 2e-4, atol 1e-4), forces
    rotating with the positions (rtol 1e-3, atol 1e-4)."""
    import torch

    from repro_torch.models.gnn import nequip
    from repro_torch.models.gnn.so3 import _random_rotations

    b = _to(batch, dev)
    r = torch.from_numpy(_random_rotations(1, seed=9)[0]).float().to(dev)
    shift = torch.tensor([1.7, -0.3, 2.2], device=dev)
    with torch.no_grad():
        e0 = nequip.forward_energy(params, cfg, b)
        e1 = nequip.forward_energy(params, cfg,
                                   dict(b, pos=b["pos"] @ r.T + shift))
    torch.testing.assert_close(e1, e0, rtol=2e-4, atol=1e-4)
    f = nequip.forces_fn(params, cfg, b)
    f_rot = nequip.forces_fn(params, cfg, dict(b, pos=b["pos"] @ r.T))
    torch.testing.assert_close(f_rot, f @ r.T, rtol=1e-3, atol=1e-4)
    log(f"nequip equivariance at full config on the molecule batch: "
        f"energies max |E(R x + t) - E(x)| {float((e1 - e0).abs().max()):.3e} "
        f"(|E| max {float(e0.abs().max()):.4f}); forces max |F(R x) - R F(x)| "
        f"{float((f_rot - f @ r.T).abs().max()):.3e} (|F| max "
        f"{float(f.abs().max()):.4f}) | {card}")


def _molecule_cells(dev, card, reset_counts, no_launches):
    """Phase 13.3: nequip, mace and dimenet at their full configs on the
    molecule cell: card against CPU in f32, NequIP's equivariance, then
    GNN_STEPS train steps."""
    import torch

    from repro_torch.configs import dimenet_cfg, mace_cfg, nequip_cfg
    from repro_torch.models.gnn import dimenet, mace, nequip

    for arch, cfg_mod, mod in (("nequip", nequip_cfg, nequip),
                               ("mace", mace_cfg, mace),
                               ("dimenet", dimenet_cfg, dimenet)):
        cfg = cfg_mod.model_config()
        batch = _molecule_batch(arch)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = mod.init_params(cfg, gen, device=dev)
        reset_counts()
        l32, worst, n_leaves = _card_equals_cpu(f"{arch} molecule", mod, cfg,
                                                params, batch, dev)
        if arch == "nequip":
            _nequip_equivariance(card, dev, params, cfg, batch)
        no_launches(f"{arch} checks")
        n, e = len(batch["species"]), len(batch["edge_src"])
        t = len(batch.get("tri_in", ()))
        n_graphs = len(batch["energy"])
        log(f"{arch} molecule: {n_graphs} graphs, N={n}, E={e}"
            + (f", T={t} triplet slots ({int((batch['tri_in'] >= 0).sum())} "
               f"real)" if t else "")
            + f" | card vs CPU in f32: loss {l32:.6f} within rtol 1e-5; "
            f"{n_leaves} gradient leaves, each within its bound (the worst at "
            f"{worst:.2%} of 1e-4 x max |cpu| + 1e-6) | {card}")
        on_card = _to(batch, dev)
        _gnn_train(f"{arch} molecule", card, dev, mod, cfg, params,
                   lambda s: on_card, gnn_flops(arch, cfg, n, e, t),
                   F32_FLOP_PER_S, n_graphs, "graphs", reset_counts,
                   no_launches)
        del params, on_card
        torch.cuda.empty_cache()


def gnn_training(dev, card, reset_counts, read_counts) -> dict:
    """Phase 13: the GNN family trained on the card through
    `train.trainer.make_train_step` at full width, each run's numbers
    logged, then the GNN launcher on the card.  Returns the launches of
    the hand-written kernels by part: none may launch."""
    import os

    import torch

    t_phase = time.perf_counter()
    launches = {}

    def no_launches(part):
        launches[part] = read_counts()
        if any(launches[part].values()):
            raise AssertionError(f"{part}: hand-written kernels launched "
                                 f"in the GNN family: {launches[part]}")

    torch.cuda.empty_cache()
    _graph_cells(dev, card, reset_counts, no_launches)
    _molecule_cells(dev, card, reset_counts, no_launches)

    # 13.4: the GNN launcher on the card (graphcast's reduced config)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "graphcast", "--steps", "3", "--log-every", "1"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if out.returncode != 0 or "device=cuda" not in out.stdout \
            or not out.stdout.rstrip().endswith("done"):
        raise AssertionError(f"launch.train --arch graphcast failed "
                             f"({out.returncode}): {out.stdout[-2000:]}"
                             f"{out.stderr[-2000:]}")
    steps = [l for l in out.stdout.splitlines() if l.startswith("step ")]
    log(f"launch.train --arch graphcast --steps 3 on the card: "
        f"{time.perf_counter() - t0:.1f} s | " + " | ".join(steps))
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches


# ---------------------------------------------------------------------------
# The sharded mesh (phase 14): ranks spawned on the card, joined over gloo
# ---------------------------------------------------------------------------
# 3 bf16 steps, not 4: phase 14 took 166.3 s with mesh C on a slow host
# (PERF §6), past its 150 s; and each ring op timed over 2 calls, not 3
MESH_B, MESH_S, MESH_STEPS = 4, 512, 3
# OLMo-1B's depth on the mesh: its 16 layers took phase 14 to 159.5 s on
# the card, and 8 to 122.6 s on a slower host (PERF §6), past the phase's
# 120 s, so the depth is cut; the width is the published one
MESH_LAYERS = 4


def kernel_counters() -> dict:
    """Each hand-written kernel's launch counter: {name: (wrapper,
    attribute)}."""
    from repro_torch.kernels.beam_fused import beam_hops
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.l2_topk import l2_topk
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_rowwise

    return {"pq_adc": (pq_adc, "launches"),
            "pq_adc_rowwise": (pq_adc_rowwise, "launches"),
            "beam_hops": (beam_hops, "launches"),
            "beam_hops_l2": (beam_hops, "l2_launches"),
            "l2_topk": (l2_topk, "launches"),
            "flash_decode": (flash_decode, "launches")}


def _olmo_mesh_setup(dev):
    """(bf16 config, f32 config, batch_fn, AdamW config) of phase 14's
    OLMo-1B: full width, MESH_LAYERS layers, B = MESH_B x MESH_S, lr
    1e-4 as phase 12."""
    import dataclasses

    from repro_torch.configs import olmo_1b

    cfg = dataclasses.replace(olmo_1b.model_config(), n_layers=MESH_LAYERS)
    _, batch_fn, _, opt = _lm_setup(dev, cfg, MESH_B, MESH_S, MESH_STEPS)
    return cfg, dataclasses.replace(cfg, dtype="float32"), batch_fn, opt


def _lm_params(cfg, dev):
    """f32 parameters of `cfg` (any LM) drawn on dev from SEED: the same
    bits on every rank and in the parent."""
    import torch

    from repro_torch.models.transformer import init_lm_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return init_lm_params(cfg, gen, device=dev)


def _digests(tree) -> dict:
    """{path: a checksum of the leaf's bits that does not depend on its
    layout}: the sum, mod 2^64, of each element's 32 bits times a hash of
    its flat index in the full tensor, each rank over its block, summed
    over the axes that shard the leaf (every rank of its mesh calls).
    Two layouts of the same bits give the same digest."""
    import torch

    from repro_torch.utils.sharding import (all_reduce, coordinate, local,
                                            sharded_dims)
    from repro_torch.utils.tree import flatten_with_path

    out = {}
    for k, x in flatten_with_path(tree):
        block = local(x).detach().contiguous()
        shape = tuple(x.shape)
        off = [0] * len(shape)
        for d in range(len(shape)):
            axes = [a for a, dd in sharded_dims(x) if dd == d]
            i, n = coordinate(x.device_mesh, tuple(axes)) if axes else (0, 1)
            off[d] = i * (shape[d] // n)
        idx = torch.zeros(block.shape, dtype=torch.int64, device=block.device)
        stride = 1
        for d in reversed(range(len(shape))):
            ar = (torch.arange(block.shape[d], device=block.device) + off[d])
            view = [1] * len(shape)
            view[d] = -1
            idx = idx + (ar * stride).view(view)
            stride *= shape[d]
        bits = block.view(torch.int32).long() & 0xFFFFFFFF
        dig = (bits * (((idx * 2654435761 + 97) % 4294967291) | 1)).sum()
        axes = tuple(a for a, _ in sharded_dims(x))
        if axes:
            dig = all_reduce(dig, x.device_mesh, axes)
        out[k] = int(dig)
        del idx, bits, block
    return out


def _rank_device(mesh):
    """This rank's device: its card (run_ranks set it), or the CPU."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_ranks(mesh, values) -> list:
    """[values of each rank, in rank order] (every rank calls)."""
    import torch

    from repro_torch.utils import sharding

    x = torch.tensor([float(v) for v in values],
                     device="cuda" if mesh.device_type == "cuda" else "cpu")
    x = x[None]
    for axis in reversed(sharding.axis_names(mesh)):
        x = sharding.all_gather(x, mesh, axis, 0)
    return x.tolist()


def _mesh4_rank(mesh, ckpt_dir: str, t_spawn: float, refs_b: dict) -> dict:
    """Phase 14 on each of the 4 ranks of a (2, 2) mesh: OLMo-1B (step 0
    in f32, then MESH_STEPS bf16 steps, a save), DIN's lookup, loss and
    retrieval shortlist, the compressed DP step on a (4,) mesh, then mesh
    B (`_mesh_b_rank`) against the parent's `refs_b`, then mesh C: the
    ring ops (`_ring_rank`) and the GNN cells' ring steps
    (`_gnn_mesh_rank`), checked against one card by the parent."""
    import torch

    from repro_torch.configs import din_cfg
    from repro_torch.data.synthetic import din_batch
    from repro_torch.models.recsys import din
    from repro_torch.models.recsys.embedding import sharded_lookup
    from repro_torch.models.transformer import (ShardCtx, lm_loss,
                                                lm_param_specs)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           make_train_step)
    from repro_torch.utils import sharding
    from repro_torch.utils.sharding import P, local, shard_leaf, shard_tree
    from repro_torch.utils.tree import global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _rank_device(mesh)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = kernel_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)

    def counts():
        return [getattr(fn, attr) for fn, attr in counters.values()]

    out = {"rank": mesh.get_rank(), "start_s": time.time() - t_spawn}

    # 14.1: OLMo-1B, FSDP x TP
    cfg, cfg32, batch_fn, opt = _olmo_mesh_setup(dev)
    ctx = ShardCtx(mesh=mesh)
    specs = lm_param_specs(cfg, ctx, fsdp_axis="data")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = shard_tree(_lm_params(cfg, dev), specs, mesh)
    if cuda:
        torch.cuda.empty_cache()
    sync()
    out["init_s"] = time.perf_counter() - t0
    b0 = batch_fn(0)

    sharding.comm_log.reset()
    t0 = time.perf_counter()
    loss, _, g = loss_and_grads(
        lambda p, b: lm_loss(p, cfg32, b["tokens"], b["labels"], ctx),
        params, b0)
    gn = global_norm(g)
    sync()
    out["f32"] = {"loss": float(loss), "grad_norm": float(gn),
                  "ms": (time.perf_counter() - t0) * 1e3,
                  "comm": sharding.comm_log.snapshot()}
    del g

    def loss_fn(p, b):
        return lm_loss(p, cfg, b["tokens"], b["labels"], ctx)

    state = init_train_state(params, opt)
    step = make_train_step(loss_fn, opt)
    out["steps"] = []
    for i in range(MESH_STEPS):
        b = batch_fn(i)
        sharding.comm_log.reset()
        sync()
        t0 = time.perf_counter()
        state, m = step(state, b)
        sync()
        out["steps"].append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "comm": sharding.comm_log.snapshot()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    out["peak_gib"] = [r[0] for r in _all_ranks(mesh, [peak])]

    # 14.2: save the model from this mesh (every rank gathers, rank 0
    # writes); the next batch's loss, uninterrupted
    model = {"step": state["step"], "params": state["params"]}
    sync()
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, MESH_STEPS, model)
    out["save_s"] = time.perf_counter() - t0
    out["digests"] = _digests(model)
    with torch.no_grad():
        out["next_loss"] = float(loss_fn(state["params"],
                                         batch_fn(MESH_STEPS))[0])
    del state, params, model, step
    if cuda:
        torch.cuda.empty_cache()

    # 14.3: DIN at its full config, tables row-sharded over "model"
    t0 = time.perf_counter()
    dcfg = din_cfg.model_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = din.init_params(dcfg, gen, device=dev)
    tree = model.param_tree()
    sharded = shard_tree(tree, din.param_specs(dcfg, mesh), mesh)
    keys = ("hist_items", "hist_cates", "hist_len", "target_item",
            "target_cate", "label")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in zip(
        keys, din_batch(0, 512, dcfg.seq_len, dcfg.n_items, dcfg.n_cates,
                        seed=SEED))}
    rows = sharded_lookup(sharded["item_emb"], batch["hist_items"], mesh,
                          "model", ("data",))
    mine = local(shard_leaf(mesh, P(("data",)), batch["hist_items"]))
    same = torch.equal(rows, sharded_lookup(tree["item_emb"], mine))
    with torch.no_grad():
        l_mesh = float(din.loss_fn(sharded, dcfg, batch, mesh, "model",
                                   ("data",)))
        l_one = float(din.loss_fn(tree, dcfg, batch))
    # the retrieval shortlist on the mesh (the history's lookup on the
    # row-sharded table, `l2_topk` over the whole table on this rank's
    # rows), against the single card's on the whole batch; the comparison's
    # launches are taken off this rank's counts
    smod = din.DIN(dcfg, sharded["item_emb"], sharded["cate_emb"],
                   model.attn_w, model.attn_b, model.mlp_w, model.mlp_b)
    with torch.no_grad():
        sync()
        t1 = time.perf_counter()
        short = smod.shortlist(batch, dcfg.n_items, "auto", mesh, "model",
                               ("data",))
        sync()
        t_short = time.perf_counter() - t1
        c0 = counts()
        one = local(shard_leaf(mesh, P(("data",)), model.shortlist(
            batch, dcfg.n_items, "auto")))
        compared = [b - a for a, b in zip(c0, counts())]
    out["din"] = {"lookup_bitwise": bool(all(
        r[0] for r in _all_ranks(mesh, [same]))), "loss_mesh": l_mesh,
        "loss_one": l_one, "rows": tuple(rows.shape),
        "shortlist_equal": bool(all(r[0] for r in _all_ranks(
            mesh, [torch.equal(short, one)]))),
        "shortlist": tuple(short.shape), "shortlist_ms": t_short * 1e3,
        "items": dcfg.n_items,
        "s": time.perf_counter() - t0}
    del model, tree, sharded, smod

    # 14.4: the compressed DP step on a (4,) data mesh of the same ranks
    t0 = time.perf_counter()
    out["dp"] = dict(_dp_compressed(dev), s=time.perf_counter() - t0)

    # 14.5-14.7: mesh B
    out["b"] = _mesh_b_rank(mesh, dev, refs_b)

    # 14.8-14.9: mesh C, the ring ops and the GNN cells' ring step (no
    # kernel lies on either: every count stays where it was)
    before = counts()
    t0 = time.perf_counter()
    ring = _ring_rank(mesh, dev)
    t_ring = time.perf_counter() - t0
    t0 = time.perf_counter()
    gnn = _gnn_mesh_rank(mesh, dev)
    t_gnn = time.perf_counter() - t0
    launched = sum(b - a for a, b in zip(before, counts()))
    rows = _all_ranks(mesh, [ring["gather_bitwise"], *ring["close"],
                             *ring["err"], ring["peak_gib"],
                             ring["held_gib"], launched])
    ring.update(gather_bitwise=[bool(r[0]) for r in rows],
                close=[[bool(x) for x in r[1:4]] for r in rows],
                err=[r[4:8] for r in rows], peak_gib=[r[8] for r in rows],
                held_gib=[r[9] for r in rows])
    out["c"] = {"ring": ring, "gnn": gnn, "ring_s": t_ring, "gnn_s": t_gnn,
                "launched": [int(r[10]) for r in rows if r[10]]}
    out["launches"] = _all_ranks(mesh, [n - c for n, c in
                                        zip(counts(), compared)])
    return out


def _dp_compressed(dev) -> dict:
    """make_manual_dp_step(int8_ef) on a (world,) data mesh against
    make_train_step on the whole batch: ten steps at the reference test's
    config (named "c"; `reduced`), lr 1e-2."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.transformer import (LMConfig, ShardCtx,
                                                init_lm_params, lm_loss)
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import (init_train_state,
                                           make_manual_dp_step,
                                           make_train_step)
    from repro_torch.utils.tree import tree_map

    dmesh = device_mesh((dist.get_world_size(),), ("data",), dev.type)
    cfg = LMConfig(name="c", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                   d_head=8, d_ff=64, vocab=64, remat="none", loss_chunks=2,
                   dtype="float32")
    opt = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_lm_params(cfg, gen, device=dev)

    def loss_fn(p, b):
        return lm_loss(p, cfg, b["tokens"], b["labels"], ShardCtx())

    def batch(s):
        t, l = lm_batch(s, 16, 8, cfg.vocab, seed=SEED)
        return {"tokens": torch.from_numpy(t).to(dev),
                "labels": torch.from_numpy(l).to(dev)}

    ref, dp = make_train_step(loss_fn, opt, donate=False), \
        make_manual_dp_step(loss_fn, opt, dmesh, compression="int8_ef")
    s_ref = init_train_state(tree_map(torch.clone, params), opt)
    s_dp = init_train_state(params, opt, ef=True)
    for i in range(10):
        s_ref, m_ref = ref(s_ref, batch(i))
        s_dp, m_dp = dp(s_dp, batch(i))
    return {"loss_ref": float(m_ref["loss"]), "loss_dp": float(m_dp["loss"])}


def _mesh2_rank(mesh, ckpt_dir: str, t_spawn: float) -> dict:
    """Phase 14.2 on each of the 2 ranks of a (1, 2) mesh: the (2, 2)
    run's checkpoint restored with `restore_sharded` into this mesh's
    layout, each leaf's digest (`_digests`) and the next batch's loss."""
    import torch

    from repro_torch.models.transformer import (ShardCtx, lm_loss,
                                                lm_param_shapes,
                                                lm_param_specs)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.utils import sharding
    from repro_torch.utils.sharding import ns
    from repro_torch.utils.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    start_s = time.time() - t_spawn
    dev = _rank_device(mesh)
    cfg, _, batch_fn, _ = _olmo_mesh_setup(dev)
    ctx = ShardCtx(mesh=mesh)
    specs = lm_param_specs(cfg, ctx, fsdp_axis="data")
    shapes = lm_param_shapes(cfg)
    like = {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "params": sharding.map_specs(
                lambda s, shape: torch.empty((), device=dev), shapes,
                shapes)}
    shardings = {"step": None, "params": sharding.map_specs(
        lambda s, _: ns(mesh, s), specs, shapes)}
    t0 = time.perf_counter()
    model, at = ckpt.restore_sharded(ckpt_dir, like, shardings)
    t_restore = time.perf_counter() - t0
    b = batch_fn(MESH_STEPS)
    with torch.no_grad():
        nxt = float(lm_loss(model["params"], cfg, b["tokens"], b["labels"],
                            ctx)[0])
    return {"step": at, "restore_s": t_restore, "start_s": start_s,
            "digests": _digests(model),
            "leaves": len(flatten_with_path(model)), "next_loss": nxt,
            "wq_block": tuple(sharding.local(
                model["params"]["layers"]["wq"]).shape)}


# Mesh B (phase 14.5-14.7): sharded serving and expert parallelism, in
# the same 4-rank spawn.  OLMo-1B's long_500k cell at its full 524,288
# positions, MESH_LAYERS layers: a synthetic bf16 cache drawn chunk by
# chunk, LONG_CHUNK positions a seed, so that each rank draws its slice
# and the parent the same bits whole
LONG_S = 524288
LONG_CHUNK = LONG_S // 4
# OLMo-1B decode_32k under "head": phase 7's rows, a sharded prefill of
# D32_PROMPT tokens placed into D32_S slots, the rest drawn N(0, 1)
D32_B, D32_S, D32_PROMPT = 8, 32768, 512
MESH_DECODE_STEPS = 8
# Qwen1.5-MoE-A2.7B expert-parallel: phase 12's 2 of its 24 layers,
# B = QWEN_B x QWEN_S; the f32 step 0, then QWEN_STEPS bf16 steps: 1,
# not 4, since a step is 10.0-12.8 s over gloo (FSDP's layer
# broadcasts, 2.4 GB a step) and phase 14 took 168.1 s with 4 and 151.4
# s with 2, past its 150 s (PERF §6).  At 1 layer (drawn anew) the f32
# step 0 dropped 12 slots at the no-drop capacities, so 2 it stays
QWEN_LAYERS, QWEN_B, QWEN_S, QWEN_STEPS = 2, 4, 512, 1
# f32 logits of the mesh against one card (the reference test's bar)
SEQ_TOL = 3e-4


def _drawn(shape, seed: int, dev, dtype):
    """N(0, 1) of `shape` from a generator seeded with `seed` on dev, in
    dtype (drawn in f32)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _long_chunk(cfg, layer: int, chunk: int, dev):
    """(k, v) of long_500k's synthetic cache: layer `layer`, positions
    [chunk * LONG_CHUNK, (chunk + 1) * LONG_CHUNK), (1, LONG_CHUNK, Hkv,
    Dh) bf16."""
    import torch

    shape = (1, LONG_CHUNK, cfg.n_kv_heads, cfg.d_head)
    seed = 1_000_003 * (layer + 1) + 2 * chunk
    return (_drawn(shape, seed, dev, torch.bfloat16),
            _drawn(shape, seed + 1, dev, torch.bfloat16))


def _d32_fill(cfg, layer: int, row: int, dev):
    """(k, v) of decode_32k's cache past the prompt for one layer and
    global batch row: (D32_S - D32_PROMPT, Hkv, Dh) bf16, all heads."""
    import torch

    shape = (D32_S - D32_PROMPT, cfg.n_kv_heads, cfg.d_head)
    seed = 2_000_003 * (layer + 1) + 2 * row
    return (_drawn(shape, seed, dev, torch.bfloat16),
            _drawn(shape, seed + 1, dev, torch.bfloat16))


def _long_tokens(vocab: int):
    """The two tokens long_500k decodes (one row each), from lm_batch."""
    from repro_torch.data.synthetic import lm_batch

    return lm_batch(7, 1, 2, vocab, seed=SEED)[0]


def _qwen_mesh_setup(dev):
    """(bf16 config at the published capacities, f32 config at no-drop
    capacities 8.0 / 8.0, batch_fn, AdamW config) of phase 14.7.  The
    f32 step runs without remat (the same values; a recompute would
    broadcast every f32 layer over gloo again)."""
    import dataclasses

    from repro_torch.configs import qwen2_moe_a2_7b

    cfg = dataclasses.replace(qwen2_moe_a2_7b.model_config(),
                              n_layers=QWEN_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32", remat="none",
                                moe=dataclasses.replace(
                                    cfg.moe, capacity_factor=8.0,
                                    expert_capacity_factor=8.0))
    _, batch_fn, _, opt = _lm_setup(dev, cfg, QWEN_B, QWEN_S,
                                    1 + QWEN_STEPS)
    return cfg, cfg32, batch_fn, opt


def _lm_rule(got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, whether the argmax agrees wherever want's top-2
    margin exceeds tol): phase 7's rule, for a rank to report."""
    import torch

    d = float((got.float() - want.float()).abs().max())
    top2 = want.float().topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol
    return d, bool(torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]))


def _mesh_b_refs(dev) -> dict:
    """Phase 14.5-14.7's single-card references, computed here before the
    ranks start and freed (moved to the host): long_500k's two f32 steps
    (`decode_step(kv_mode="local", backend="ref")` on the whole cache)
    and the rows they wrote; decode_32k's prefill logits and 8 greedy
    steps under "auto" with their tokens; Qwen's f32 step 0 loss and
    gradient norm at no-drop capacities."""
    import dataclasses

    import torch

    from repro_torch.models.transformer import (decode_step, lm_loss,
                                                serve_prefill)
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.utils.tree import global_norm

    out = {}
    t0 = time.perf_counter()
    cfg, cfg32, _, _ = _olmo_mesh_setup(dev)
    params = _lm_params(cfg32, dev)
    n_chunk = LONG_S // LONG_CHUNK
    shape = (cfg.n_layers, 1, LONG_S, cfg.n_kv_heads, cfg.d_head)
    ck = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    cv = torch.empty_like(ck)
    for li in range(cfg.n_layers):
        for c in range(n_chunk):
            sl = slice(c * LONG_CHUNK, (c + 1) * LONG_CHUNK)
            ck[li, :, sl], cv[li, :, sl] = _long_chunk(cfg, li, c, dev)
    toks = _long_tokens(cfg.vocab)
    long = []
    for i, pos in enumerate((LONG_S - 1, LONG_S // 2)):
        with torch.no_grad():
            logits, _ = decode_step(
                params, cfg32, torch.from_numpy(toks[:, i:i + 1]).to(dev),
                torch.tensor([pos], device=dev),
                (ck, cv, torch.zeros(1, dtype=torch.int32, device=dev)),
                kv_mode="local", backend="ref")
        long.append({"pos": pos, "logits": logits.cpu(),
                     "k": ck[:, 0, pos].cpu(), "v": cv[:, 0, pos].cpu()})
    out["long"] = long
    del ck, cv, params
    torch.cuda.empty_cache()
    out["long_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params = _lm_params(cfg, dev)
    prompt = _d32_prompt(cfg.vocab, dev)
    with torch.no_grad():
        logits, (pk, pv), _ = serve_prefill(params, cfg, prompt)
        shape = (cfg.n_layers, D32_B, D32_S, cfg.n_kv_heads, cfg.d_head)
        ck = torch.empty(shape, dtype=cfg.compute_dtype, device=dev)
        cv = torch.empty_like(ck)
        ck[:, :, :D32_PROMPT], cv[:, :, :D32_PROMPT] = pk, pv
        del pk, pv
        for li in range(cfg.n_layers):
            for r in range(D32_B):
                ck[li, r, D32_PROMPT:], cv[li, r, D32_PROMPT:] = _d32_fill(
                    cfg, li, r, dev)
        caches = (ck, cv, torch.zeros(D32_B, dtype=torch.int32, device=dev))
        d32 = {"prefill": logits.float().cpu(), "tokens": [], "steps": []}
        for i in range(MESH_DECODE_STEPS):
            tok = logits.argmax(-1)[:, None].int()
            pos = torch.full((D32_B,), D32_S - MESH_DECODE_STEPS + i,
                             device=dev)
            logits, caches = decode_step(params, cfg, tok, pos, caches,
                                         kv_mode="local", backend="auto")
            d32["tokens"].append(tok.cpu())
            d32["steps"].append(logits.float().cpu())
    out["d32"] = d32
    del ck, cv, caches, params
    torch.cuda.empty_cache()
    out["d32_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, q32, batch_fn, _ = _qwen_mesh_setup(dev)
    params = _lm_params(q32, dev)
    loss, _, g = loss_and_grads(
        lambda p, b: lm_loss(p, q32, b["tokens"], b["labels"]), params,
        batch_fn(0))
    out["qwen"] = {"loss": float(loss), "grad_norm": float(global_norm(g))}
    del params, g
    torch.cuda.empty_cache()
    out["qwen_s"] = time.perf_counter() - t0
    return out


def _d32_prompt(vocab: int, dev):
    import torch

    return torch.from_numpy(_lm_batch_tokens(11, D32_B, D32_PROMPT,
                                             vocab)).to(dev)


def _mesh_b_rank(mesh, dev, refs: dict) -> dict:
    """Phase 14.5-14.7 on each rank of the (2, 2) mesh: OLMo-1B long_500k
    under "seq_all", decode_32k under "head" (flash_decode in each rank),
    Qwen1.5-MoE-A2.7B expert-parallel; numbers a rank, checked by the
    parent."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.transformer import (ShardCtx, cache_specs,
                                                decode_step, lm_loss,
                                                lm_param_specs, serve_prefill)
    from repro_torch.train.trainer import init_train_state, make_train_step
    from repro_torch.utils import sharding
    from repro_torch.utils.sharding import coordinate, shard_tree

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def peak():
        gib = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        return [r[0] for r in _all_ranks(mesh, [gib])]

    def reset_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t0) * 1e3

    ctx = ShardCtx(mesh=mesh)
    out = {}

    # 14.5: long_500k, the cache's sequence over every mesh axis
    t_part = time.perf_counter()
    reset_peak()
    cfg, cfg32, _, _ = _olmo_mesh_setup(dev)
    params = shard_tree(_lm_params(cfg32, dev), lm_param_specs(cfg32, ctx),
                        mesh)
    idx, n = coordinate(mesh, ("data", "model"))
    s_l = LONG_S // n
    shape = (cfg.n_layers, 1, s_l, cfg.n_kv_heads, cfg.d_head)
    ck = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    cv = torch.empty_like(ck)
    per = s_l // LONG_CHUNK
    for li in range(cfg.n_layers):
        for c in range(per):
            sl = slice(c * LONG_CHUNK, (c + 1) * LONG_CHUNK)
            ck[li, :, sl], cv[li, :, sl] = _long_chunk(cfg, li, idx * per + c,
                                                       dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    toks = _long_tokens(cfg.vocab)
    long = []
    for i, ref in enumerate(refs["long"]):
        pos = ref["pos"]
        loc = pos - idx * s_l
        mine = 0 <= loc < s_l
        here = min(max(loc, 0), s_l - 1)
        before = (ck[:, 0, here].clone(), cv[:, 0, here].clone())
        sharding.comm_log.reset()
        with torch.no_grad():
            (logits, _), ms = timed(lambda: decode_step(
                params, cfg32, torch.from_numpy(toks[:, i:i + 1]).to(dev),
                torch.tensor([pos], device=dev), (ck, cv, lens),
                kv_mode="seq_all", ctx=ctx))
        want = ref["logits"].to(dev)
        row = {"pos": pos, "mine": mine, "ms": ms,
               "err": float((logits - want).abs().max()),
               "close": bool(torch.allclose(logits, want, rtol=SEQ_TOL,
                                            atol=SEQ_TOL)),
               "local_len": int(min(max(pos + 1 - idx * s_l, 0), s_l)),
               "comm": sharding.comm_log.snapshot()}
        if mine:
            # the written row against the parent's: within one bf16 ulp
            # (2^-7 relative; the f32 sums run in another order on the
            # mesh), and the share of its values with the same bits
            got = torch.stack([ck[:, 0, here], cv[:, 0, here]]).float()
            want = torch.stack([ref["k"], ref["v"]]).to(dev).float()
            row["row_ulps"] = float(((got - want).abs()
                                     / (2 ** -7 * want.abs() + 1e-6)).max())
            row["row_bits_equal"] = float((got == want).float().mean())
        else:
            row["untouched"] = bool(torch.equal(ck[:, 0, here], before[0])
                                    and torch.equal(cv[:, 0, here],
                                                    before[1]))
        long.append(row)
    keys = ("close", "err", "mine", "row_ulps", "untouched", "local_len",
            "row_bits_equal")
    fill = {"row_ulps": 0.0, "untouched": True, "row_bits_equal": 0.0}
    out["long_checks"] = []
    for row in long:
        by_rank = _all_ranks(mesh, [row.get(k, fill.get(k)) for k in keys])
        out["long_checks"].append(
            {"pos": row["pos"], "ms": row["ms"], "comm": row["comm"],
             **{k: [r[j] for r in by_rank] for j, k in enumerate(keys)}})
    # timing: bf16 steps at the last positions, each the last one's argmax
    tok = torch.from_numpy(toks[:, :1]).to(dev)
    steps = []
    for i in range(MESH_DECODE_STEPS):
        sharding.comm_log.reset()
        pos = torch.tensor([LONG_S - MESH_DECODE_STEPS + i], device=dev)
        with torch.no_grad():
            (logits, _), ms = timed(lambda: decode_step(
                params, cfg, tok, pos, (ck, cv, lens), kv_mode="seq_all",
                ctx=ctx))
        tok = logits.argmax(-1)[:, None].int()
        steps.append({"ms": ms, "finite": bool(torch.isfinite(logits).all()),
                      "comm": sharding.comm_log.snapshot()})
    out["long_steps"] = steps
    out["long_block"] = tuple(ck.shape)
    out["long_cache_gb"] = 2 * ck.numel() * ck.element_size() / 1e9
    del ck, cv, params
    out["long_peak"] = peak()
    out["long_s"] = time.perf_counter() - t_part

    # 14.6: decode_32k, kv heads over "model", the prompt from a sharded
    # prefill; flash_decode in each rank
    t_part = time.perf_counter()
    reset_peak()
    params = shard_tree(_lm_params(cfg, dev), lm_param_specs(cfg, ctx),
                        mesh)
    d32 = refs["d32"]
    prompt = _d32_prompt(cfg.vocab, dev)
    with torch.no_grad():
        (logits, (pk, pv), _), ms_pre = timed(lambda: serve_prefill(
            params, cfg, prompt, ctx=ctx))
    pre = _lm_rule(logits, d32["prefill"].to(dev), LM_TOL)
    spec = cache_specs(cfg, ctx, "head")[0]
    rows, _ = coordinate(mesh, "data")
    b_l, h_l = pk.shape[1], pk.shape[3]
    h0 = mesh.get_local_rank("model") * h_l
    ck = torch.empty((cfg.n_layers, b_l, D32_S, h_l, cfg.d_head),
                     dtype=cfg.compute_dtype, device=dev)
    cv = torch.empty_like(ck)
    ck[:, :, :D32_PROMPT], cv[:, :, :D32_PROMPT] = pk, pv
    del pk, pv
    for li in range(cfg.n_layers):
        for r in range(b_l):
            k, v = _d32_fill(cfg, li, rows * b_l + r, dev)
            ck[li, r, D32_PROMPT:] = k[:, h0:h0 + h_l]
            cv[li, r, D32_PROMPT:] = v[:, h0:h0 + h_l]
            del k, v
    caches = (ck, cv, torch.zeros(b_l, dtype=torch.int32, device=dev))
    steps = []
    for i in range(MESH_DECODE_STEPS):
        sharding.comm_log.reset()
        pos = torch.full((D32_B,), D32_S - MESH_DECODE_STEPS + i, device=dev)
        with torch.no_grad():
            (logits, caches), ms = timed(lambda: decode_step(
                params, cfg, d32["tokens"][i].to(dev), pos, caches,
                kv_mode="head", backend="auto", ctx=ctx))
        err, agree = _lm_rule(logits, d32["steps"][i].to(dev), LM_TOL)
        steps.append({"ms": ms, "err": err, "agree": agree,
                      "comm": sharding.comm_log.snapshot()})
    by_rank = _all_ranks(mesh, [pre[0], pre[1],
                                max(s["err"] for s in steps),
                                all(s["agree"] for s in steps)])
    out["d32_checks"] = {k: [r[j] for r in by_rank] for j, k in enumerate(
        ("prefill_err", "prefill_agree", "err", "agree"))}
    out["d32"] = {"prefill_ms": ms_pre, "steps": steps,
                  "block": tuple(ck.shape), "spec": str(spec),
                  "cache_gb": 2 * ck.numel() * ck.element_size() / 1e9}
    del ck, cv, caches, params
    out["d32_peak"] = peak()
    out["d32_s"] = time.perf_counter() - t_part

    # 14.7: Qwen1.5-MoE expert-parallel, FSDP over data x experts over model
    t_part = time.perf_counter()
    reset_peak()
    qcfg, q32, batch_fn, opt = _qwen_mesh_setup(dev)
    specs = lm_param_specs(qcfg, ctx, fsdp_axis="data")
    params = shard_tree(_lm_params(qcfg, dev), specs, mesh)
    if cuda:
        torch.cuda.empty_cache()
    # step 0 in f32 at no-drop capacities: a train step whose loss and
    # gradient norm are held against one card's (the lr is 0 at step 0,
    # so the parameters stay as drawn), then the bf16 steps
    state = init_train_state(params, opt)
    moe.drop_log.on = True
    q = {"steps": []}
    for i in range(1 + QWEN_STEPS):
        sharding.comm_log.reset()
        moe.drop_log.reset()
        c = q32 if i == 0 else qcfg
        step = make_train_step(
            lambda p, b, c=c: lm_loss(p, c, b["tokens"], b["labels"], ctx),
            opt)
        (state, m), ms = timed(lambda: step(state, batch_fn(i)))
        # each rank's dropped slots in the step's forward
        q["steps"].append({"loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"]), "ms": ms,
                           "comm": sharding.comm_log.snapshot(),
                           "dropped": [dict(zip(("slots", "send", "expert"),
                                                map(int, r)))
                                       for r in _all_ranks(mesh, list(
                                           moe.drop_log.snapshot().values()))]
                           })
    q["f32"] = q["steps"].pop(0)
    moe.drop_log.on = False
    # one decode step of the trained model under "head", through the
    # expert-parallel FFN, on a 64-slot cache drawn N(0, 1)
    s_c = 64
    b_l = QWEN_B // mesh.size(0)
    h_l = qcfg.n_kv_heads // mesh.size(1)
    shape = (qcfg.n_layers, b_l, s_c, h_l, qcfg.d_head)
    ck = _drawn(shape, 3_000_017 + mesh.get_rank(), dev, torch.bfloat16)
    cv = _drawn(shape, 4_000_037 + mesh.get_rank(), dev, torch.bfloat16)
    tok = torch.from_numpy(_lm_batch_tokens(13, QWEN_B, 1, qcfg.vocab)).to(
        dev)
    with torch.no_grad():
        (logits, _), ms = timed(lambda: decode_step(
            state["params"], qcfg, tok, torch.full((QWEN_B,), s_c - 1,
                                                   device=dev),
            (ck, cv, torch.zeros(b_l, dtype=torch.int32, device=dev)),
            kv_mode="head", backend="auto", ctx=ctx))
    q["decode"] = {"shape": tuple(logits.shape), "ms": ms,
                   "finite": bool(torch.isfinite(logits).all()),
                   "block": tuple(ck.shape)}
    del state, params, step, ck, cv
    q["peak"] = peak()
    q["s"] = time.perf_counter() - t_part
    out["qwen"] = q
    if cuda:
        torch.cuda.empty_cache()
    return out


# Mesh C (14.8-14.9): the ring primitives at ogb_products' node count,
# 2,449,029 padded as the cells pad it (a multiple of 2 x 256), 8 f32
# wide, with RING_IDS global ids of which RING_PAD are -1; then one step
# of NequIP and one of DimeNet at their published widths and 1 layer / 1
# block (`reduced` depth) on a synthetic graph of GNN_MESH_NODES x
# GNN_MESH_EDGES (`reduced` from ogb_products: gloo moves about 0.5 GB/s
# a rank, and the ring moves the whole table once a call).  At 65,536 x
# 524,288 the two steps took 4.2 s of a phase 14 of 148.7 s run alone
# (PERF §6), too near its 150 s on a slower host: half that graph
RING_ROWS, RING_WIDTH, RING_IDS, RING_PAD = 2_449_408, 8, 4_194_304, 0.05
RING_CALLS = 2
GNN_MESH_NODES, GNN_MESH_EDGES, GNN_MESH_GRAPHS = 32_768, 262_144, 32
RING_TOL = 1e-5


def _ring_inputs(dev) -> dict:
    """The ring check's whole arrays, drawn from SEED on dev (the same bits
    on every rank): table, ids (RING_PAD of them -1), values, and the
    cotangents of the gather's output and of the scatter's."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    n, d, t = RING_ROWS, RING_WIDTH, RING_IDS

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ids = torch.randint(0, n, (t,), generator=gen, device=dev)
    pad = torch.rand((t,), generator=gen, device=dev) < RING_PAD
    return {"table": normal(n, d), "ids": torch.where(pad, -1, ids),
            "vals": normal(t, d), "c_gather": normal(t, d),
            "c_scatter": normal(n, d)}


def _ring_rank(mesh, dev) -> dict:
    """14.8 on each rank: ring_gather and ring_scatter_add over the 4 ranks,
    forward and VJP, against one card's index_select / index_add_ on the
    whole arrays (every rank draws them), this rank's block of each."""
    import torch

    from repro_torch.models.gnn.ring_gather import ring_gather, ring_scatter_add
    from repro_torch.utils import sharding

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    axes = sharding.axis_names(mesh)
    me, p = sharding.coordinate(mesh, axes)
    a = _ring_inputs(dev)
    n, t = RING_ROWS // p, RING_IDS // p
    ids = a["ids"]
    mine = ids[me * t:(me + 1) * t]
    rows = slice(me * n, (me + 1) * n)
    ok = (ids >= 0)[:, None]
    # one card's answers on the whole arrays, this rank's block of each
    want_g = torch.where(ok[me * t:(me + 1) * t], a["table"].index_select(
        0, mine.clamp(0, RING_ROWS - 1)), 0.0)
    dump = torch.where(ids >= 0, ids, RING_ROWS)

    def one_card_sum(v):
        return torch.zeros(RING_ROWS + 1, RING_WIDTH, device=dev).index_add_(
            0, dump, torch.where(ok, v, 0.0))[rows]

    want_s = one_card_sum(a["vals"])
    want_gt = one_card_sum(a["c_gather"])
    want_gv = torch.where(ok[me * t:(me + 1) * t], a["c_scatter"].index_select(
        0, mine.clamp(0, RING_ROWS - 1)), 0.0)
    table = a["table"][rows].clone()
    vals = a["vals"][me * t:(me + 1) * t].clone()
    c_g = a["c_gather"][me * t:(me + 1) * t].clone()
    c_s = a["c_scatter"][rows].clone()
    del a, dump, ok
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30 if cuda else 0.0

    def timed(fn):
        ms = []
        for _ in range(RING_CALLS):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    def err(got, want):
        return float((got - want).abs().max()) if got.numel() else 0.0

    def close(got, want):
        return bool(torch.allclose(got, want, rtol=RING_TOL, atol=RING_TOL))

    out = {}
    sharding.comm_log.reset()
    g, out["gather_ms"] = timed(lambda: ring_gather(table, mine, mesh, axes))
    out["gather_comm"] = sharding.comm_log.snapshot()
    sharding.comm_log.reset()
    s, out["scatter_ms"] = timed(lambda: ring_scatter_add(
        vals, mine, mesh, axes, n))
    out["scatter_comm"] = sharding.comm_log.snapshot()

    def vjp(fn, x, cot):
        x = x.detach().requires_grad_(True)
        (gx,) = torch.autograd.grad(fn(x), x, cot)
        return gx

    gt, out["gather_vjp_ms"] = timed(lambda: vjp(
        lambda x: ring_gather(x, mine, mesh, axes), table, c_g))
    gv, out["scatter_vjp_ms"] = timed(lambda: vjp(
        lambda x: ring_scatter_add(x, mine, mesh, axes, n), vals, c_s))
    out["gather_bitwise"] = bool(torch.equal(g, want_g))
    out["close"] = [close(s, want_s), close(gt, want_gt), close(gv, want_gv)]
    out["err"] = [err(g, want_g), err(s, want_s), err(gt, want_gt),
                  err(gv, want_gv)]
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if cuda else 0.0)
    out["held_gib"] = held
    return out


def _mesh_triplets(src, dst, max_t: int):
    """`models.gnn.dimenet.build_triplets`' pairs in its order (ji, then
    kj in edge order), built with numpy array ops: every edge kj into
    node j = src[ji], except the backtrack k == i; cut to max_t, padded
    with -1."""
    import numpy as np

    e = len(src)
    order = np.argsort(dst, kind="stable")
    by_dst = dst[order]
    lo = np.searchsorted(by_dst, src, "left")
    cnt = np.where(src >= 0, np.searchsorted(by_dst, src, "right") - lo, 0)
    ji = np.repeat(np.arange(e), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    kj = order[np.repeat(lo, cnt) + np.arange(len(ji)) - first]
    keep = src[kj] != dst[ji]
    ti, to = kj[keep][:max_t], ji[keep][:max_t]
    pad = -np.ones(max_t - len(ti), np.int64)
    return (np.concatenate([ti, pad]).astype(np.int32),
            np.concatenate([to, pad]).astype(np.int32))


def _mesh_graph() -> dict:
    """14.9's synthetic graph (numpy, from SEED): GNN_MESH_NODES atoms of
    8 species at N(0, 2^2) positions in GNN_MESH_GRAPHS graphs,
    GNN_MESH_EDGES random edges (no self loops), N(0, 1) energies, and
    DimeNet's triplets cut to 4 a edge (the cells' count)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    n, e = GNN_MESH_NODES, GNN_MESH_EDGES
    src = rng.integers(0, n, e).astype(np.int32)
    dst = ((src + rng.integers(1, n, e)) % n).astype(np.int32)
    g = {"species": rng.integers(0, 8, n).astype(np.int32),
         "pos": (rng.normal(size=(n, 3)) * 2.0).astype(np.float32),
         "edge_src": src, "edge_dst": dst,
         "graph_ids": (np.arange(n) * GNN_MESH_GRAPHS // n).astype(np.int32),
         "energy": rng.normal(size=GNN_MESH_GRAPHS).astype(np.float32)}
    g["tri_in"], g["tri_out"] = _mesh_triplets(src, dst, 4 * e)
    return g


def _gnn_mesh_models():
    """[(arch, module, config)]: NequIP (32 channels, l_max 2) and DimeNet
    (d_hidden 128, 8 bilinear) at their published widths, 1 layer and 1
    block."""
    import dataclasses

    from repro_torch.configs import dimenet_cfg, nequip_cfg
    from repro_torch.models.gnn import dimenet, nequip

    return [("nequip", nequip,
             dataclasses.replace(nequip_cfg.model_config(), n_layers=1)),
            ("dimenet", dimenet,
             dataclasses.replace(dimenet_cfg.model_config(), n_blocks=1))]


def _gnn_mesh_batch(arch, g, dev) -> dict:
    keys = ["species", "pos", "edge_src", "edge_dst", "graph_ids", "energy"]
    if arch == "dimenet":
        keys += ["tri_in", "tri_out"]
    return _to({k: g[k] for k in keys}, dev)


def _gnn_mesh_state(mod, cfg, dev):
    import torch

    from repro_torch.train.trainer import init_train_state
    from repro_torch.train.optimizer import AdamWConfig

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return init_train_state(mod.init_params(cfg, gen, device=dev),
                            AdamWConfig())


def _gnn_mesh_refs(dev) -> dict:
    """14.9's references: each model's step 0 on the whole graph, one
    card, one process."""
    import torch

    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import make_train_step

    g = _mesh_graph()
    out = {}
    for arch, mod, cfg in _gnn_mesh_models():
        t0 = time.perf_counter()
        step = make_train_step(_gnn_loss(mod, cfg), AdamWConfig())
        _, m = step(_gnn_mesh_state(mod, cfg, dev),
                    _gnn_mesh_batch(arch, g, dev))
        out[arch] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "s": time.perf_counter() - t0}
        del step, m
        torch.cuda.empty_cache()
    return out


def _gnn_mesh_rank(mesh, dev) -> dict:
    """14.9 on each rank: one train step of each model through the GNN
    cells' rank program with the ring hooks (`launch.cells`): the batch
    laid out by the cells' specs, the ring under every gather and sum at
    global ids, the gradient shares summed, AdamW."""
    import torch

    from repro_torch.launch import cells
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.utils import sharding
    from repro_torch.utils.sharding import shard_tree

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    g = _mesh_graph()
    out = {}
    for arch, mod, cfg in _gnn_mesh_models():
        whole = _gnn_mesh_batch(arch, g, dev)
        batch = shard_tree(whole, cells._gnn_batch_specs(whole, mesh), mesh)
        del whole
        state = _gnn_mesh_state(mod, cfg, dev)
        step = cells.gnn_train_step(cells.gnn_rank_loss(
            arch, mod, cfg, mesh, cells.ring_hooks(mesh)), AdamWConfig(),
            mesh)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30 if cuda else 0.0
        sharding.comm_log.reset()
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        out[arch] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "comm": sharding.comm_log.snapshot(),
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                  if cuda else 0.0), "held_gib": held}
        del state, step, batch, m
    return out


def _mesh_c_checks(c: dict, refs: dict) -> None:
    """14.8-14.9's checks on rank 0's report (the ring's per-rank answers
    gathered)."""
    r = c["ring"]
    if not all(r["gather_bitwise"]) or not all(all(x) for x in r["close"]):
        raise AssertionError(f"ring ops at {RING_ROWS:,} rows: gather "
                             f"bitwise by rank {r['gather_bitwise']}, "
                             f"scatter / gather VJP / scatter VJP within "
                             f"{RING_TOL} by rank {r['close']} (max errors "
                             f"{r['err']})")
    for arch, ref in refs.items():
        got = c["gnn"][arch]
        if abs(got["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"]) \
                or abs(got["grad_norm"] - ref["grad_norm"]) \
                > 1e-3 * ref["grad_norm"]:
            raise AssertionError(f"{arch} ring step 0: loss {got['loss']} vs "
                                 f"{ref['loss']} (rtol 1e-4), grad norm "
                                 f"{got['grad_norm']} vs {ref['grad_norm']} "
                                 f"(rtol 1e-3)")
        if not got["comm"]["calls"].get("collective-permute"):
            raise AssertionError(f"{arch} ring step: no collective-permute "
                                 f"counted: {got['comm']['calls']}")
    if c["launched"]:
        raise AssertionError(f"mesh C launched kernels (by rank: "
                             f"{c['launched']}); the ring and the GNN step "
                             f"have none")


def _mesh_c_log(c: dict, refs: dict, card: str) -> None:
    r = c["ring"]

    def med(ms):
        return statistics.median(ms)

    def permutes(comm):
        calls = comm["calls"].get("collective-permute", 0) // RING_CALLS
        mb = comm["bytes"].get("collective-permute", 0) / RING_CALLS / 1e6
        return f"{calls} collective-permutes ({mb:.1f} MB)"

    log(f"mesh ring ops: {RING_ROWS:,} x {RING_WIDTH} f32 table (ogb_products"
        f"' 2,449,029 nodes padded), {RING_IDS:,} global ids ({RING_PAD:.0%}"
        f" -1), a ring of 4 ranks over gloo on one card: ring_gather "
        f"{med(r['gather_ms']):.1f} ms a call on rank 0 "
        f"({permutes(r['gather_comm'])} a call), its VJP "
        f"{med(r['gather_vjp_ms']):.1f} ms; ring_scatter_add "
        f"{med(r['scatter_ms']):.1f} ms ({permutes(r['scatter_comm'])}"
        f" a call), its VJP {med(r['scatter_vjp_ms']):.1f} ms | gather "
        f"bitwise one card's index_select on every rank; scatter, gather "
        f"VJP, scatter VJP within {RING_TOL} of one card's index_add_ / "
        f"index_select (max errors over ranks "
        + ", ".join(f"{max(e[i] for e in r['err']):.3g}" for i in (1, 2, 3))
        + f") | peak GiB by rank: "
        + ", ".join(f"{v:.2f}" for v in r["peak_gib"])
        + " (of it held from earlier parts: "
        + ", ".join(f"{v:.2f}" for v in r["held_gib"]) + f") | {card}")
    for arch, ref in refs.items():
        got = c["gnn"][arch]
        log(f"mesh {arch} ring step: published width, 1 layer/block "
            f"(reduced), {GNN_MESH_NODES:,} nodes x {GNN_MESH_EDGES:,} edges "
            f"(reduced from ogb_products), rows and edges over 4 ranks, "
            f"every gather and sum at global ids on the ring | loss "
            f"{got['loss']:.6f} vs one card {ref['loss']:.6f} (rel "
            f"{abs(got['loss'] - ref['loss']) / abs(ref['loss']):.2e}), grad "
            f"norm {got['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
            f"{abs(got['grad_norm'] - ref['grad_norm']) / ref['grad_norm']:.2e}"
            f") | step {got['ms']:.1f} ms on rank 0 (gloo on one card), "
            f"collectives {_comm(got['comm'])} | peak {got['peak_gib']:.2f} "
            f"GiB on rank 0 ({got['held_gib']:.2f} held from earlier parts) "
            f"| one card {ref['s']:.1f} s | {card}")


def _lm_batch_tokens(step: int, b: int, s: int, vocab: int):
    from repro_torch.data.synthetic import lm_batch

    return lm_batch(step, b, s, vocab, seed=SEED)[0]


def mesh_training(dev, card, reset_counts, read_counts) -> dict:
    """Phase 14: the sharded mesh on one card.  Single-card f32 runs of
    OLMo-1B's step 0 and mesh B's and mesh C's references first (freed
    before the ranks start), then 4 ranks spawned as a (2, 2) mesh on the card,
    joined over gloo (NCCL refuses two ranks on one device), then 2 ranks
    as a (1, 2) mesh that restore the 4-rank checkpoint.  Returns the six
    kernels' launches in the ranks (`l2_topk`'s on the sharded shortlist,
    `flash_decode`'s on "head" decode, the others 0) and in this process
    (all 0)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.utils.tree import global_norm

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    reset_counts()

    # 14.1's reference: OLMo-1B's step 0 in f32 on the card, one process
    _, cfg32, batch_fn, _ = _olmo_mesh_setup(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = _lm_params(cfg32, dev)
    loss, _, g = loss_and_grads(
        lambda p, b: lm_loss(p, cfg32, b["tokens"], b["labels"]), params,
        batch_fn(0))
    ref = {"loss": float(loss), "grad_norm": float(global_norm(g))}
    del params, g
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    # mesh B's and mesh C's references (their launches are not the mesh
    # path's)
    refs_b = _mesh_b_refs(dev)
    refs_c = _gnn_mesh_refs(dev)
    reset_counts()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as rdv:
        r4 = run_ranks(_mesh4_rank, (2, 2), device=dev.type,
                       init_method=f"file://{rdv}/init", args=(
                           str(root / "ckpt"), time.time(), refs_b),
                       timeout=400, threads=2)
    t4 = time.perf_counter() - t0
    gb = (root / "ckpt" / f"ckpt_{MESH_STEPS:08d}.npz").stat().st_size / 1e9
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as rdv:
        r2 = run_ranks(_mesh2_rank, (1, 2), device=dev.type,
                       init_method=f"file://{rdv}/init", args=(
                           str(root / "ckpt"), time.time()), timeout=240,
                       threads=2)
    t2 = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    parent = read_counts()

    # the checks
    f32 = r4["f32"]
    if abs(f32["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"]):
        raise AssertionError(f"mesh step 0 loss {f32['loss']} vs the single "
                             f"card's {ref['loss']}: beyond rtol 1e-4")
    if abs(f32["grad_norm"] - ref["grad_norm"]) > 1e-3 * ref["grad_norm"]:
        raise AssertionError(f"mesh step 0 gradient norm {f32['grad_norm']} "
                             f"vs the single card's {ref['grad_norm']}: "
                             f"beyond rtol 1e-3")
    losses = [s["loss"] for s in r4["steps"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh bf16 losses not finite: {losses}")
    differ = sorted(k for k in r4["digests"]
                    if r2["digests"].get(k) != r4["digests"][k])
    if differ or set(r2["digests"]) != set(r4["digests"]) \
            or r2["step"] != MESH_STEPS:
        raise AssertionError(f"restore: step {r2['step']}, leaves whose "
                             f"bits differ from the saved ones: {differ}")
    if abs(r2["next_loss"] - r4["next_loss"]) > 1e-4 * abs(r4["next_loss"]):
        raise AssertionError(f"restored next loss {r2['next_loss']} vs the "
                             f"uninterrupted run's {r4['next_loss']}: beyond "
                             f"rtol 1e-4")
    d = r4["din"]
    if not d["lookup_bitwise"]:
        raise AssertionError("DIN's sharded lookup differs from the single-"
                             "card lookup")
    if abs(d["loss_mesh"] - d["loss_one"]) > 1e-6 + 1e-5 * abs(d["loss_one"]):
        raise AssertionError(f"DIN sharded loss {d['loss_mesh']} vs "
                             f"{d['loss_one']}: beyond rtol 1e-5 / atol 1e-6")
    if not d["shortlist_equal"]:
        raise AssertionError("DIN's sharded shortlist differs from the "
                             "single card's")
    dp = r4["dp"]
    if not abs(dp["loss_dp"] - dp["loss_ref"]) < 0.05:
        raise AssertionError(f"compressed DP loss {dp['loss_dp']} vs "
                             f"{dp['loss_ref']}: not within 0.05")
    _mesh_b_checks(r4["b"], refs_b)
    _mesh_c_checks(r4["c"], refs_c)
    ranks = [dict(zip(kernel_counters(), map(int, row)))
             for row in r4["launches"]]
    # the mesh paths that reach a kernel: the sharded shortlist (l2_topk)
    # and "head" decode (flash_decode)
    on_path = ("l2_topk", "flash_decode")
    if (any(v for r in ranks for k, v in r.items() if k not in on_path)
            or not all(r[k] for r in ranks for k in on_path)
            or any(parent.values())):
        raise AssertionError(f"phase 14's launches: ranks {ranks} (l2_topk "
                             f"on the sharded shortlist, flash_decode on "
                             f"\"head\" decode, nothing else), parent "
                             f"{parent} (none)")
    kinds = sorted({k for s in [f32, *r4["steps"]]
                    for k in s["comm"]["calls"]})

    def comm(c):
        return ", ".join(f"{k} {c['calls'][k]} ({c['bytes'][k] / 1e6:.1f} "
                         f"MB)" for k in sorted(c["calls"]))

    log(f"mesh: {dev.type} ranks over gloo, torch {torch.__version__}: "
        f"{', '.join(kinds)} ran on the ranks' {dev.type} tensors (nothing "
        f"moves through the host) | {card}")
    log(f"mesh olmo-1b: (2, 2) mesh (data, model) of 4 ranks on one card, "
        f"full width (d {cfg32.d_model}, ff {cfg32.d_ff}, vocab "
        f"{cfg32.vocab}), {cfg32.n_layers} of 16 layers (depth cut: the "
        f"phase took 159.5 s at 16, 122.6 s at 8 on a slower host, past "
        f"its 120 s), FSDP over data x TP over model, B={MESH_B} x "
        f"{MESH_S} | single-card f32 step 0 ({t_ref:.1f} s): loss "
        f"{ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f} | mesh f32 "
        f"step 0: loss {f32['loss']:.6f} (rel "
        f"{abs(f32['loss'] - ref['loss']) / abs(ref['loss']):.2e}), "
        f"grad norm {f32['grad_norm']:.6f} (rel "
        f"{abs(f32['grad_norm'] - ref['grad_norm']) / ref['grad_norm']:.2e}), "
        f"{f32['ms']:.1f} ms over gloo | rank init {r4['init_s']:.1f} s | "
        f"{card}")
    for i, s in enumerate(r4["steps"]):
        log(f"  mesh bf16 step {i}: loss {s['loss']:.4f}, grad norm "
            f"{s['grad_norm']:.4f}, {s['ms']:.1f} ms on rank 0 (gloo on one "
            f"card, not a figure of NCCL) | collectives on rank 0: "
            f"{comm(s['comm'])}")
    log(f"  mesh f32 step 0 collectives on rank 0: {comm(f32['comm'])} | "
        f"peak GiB by rank: "
        + ", ".join(f"{v:.2f}" for v in r4["peak_gib"]) + f" | {card}")
    log(f"mesh elastic: saved step {MESH_STEPS}'s model ({gb:.2f} GB npz) "
        f"from the (2, 2) mesh in {r4['save_s']:.1f} s, restored into a "
        f"(1, 2) mesh of 2 ranks in {r2['restore_s']:.1f} s: {r2['leaves']} "
        f"leaves, each leaf's bits the saved ones (layout-free digests "
        f"equal), wq block {r2['wq_block']} | next loss "
        f"{r2['next_loss']:.6f} vs "
        f"uninterrupted {r4['next_loss']:.6f} (rel "
        f"{abs(r2['next_loss'] - r4['next_loss']) / abs(r4['next_loss']):.2e})"
        f" | spawns: 4 ranks {t4:.1f} s (rank 0 started its work "
        f"{r4['start_s']:.1f} s in), 2 ranks {t2:.1f} s (at "
        f"{r2['start_s']:.1f} s)")
    log(f"mesh din: full config, tables row-sharded over model: lookup of "
        f"each rank's rows {d['rows']} bitwise the single-card lookup; loss "
        f"{d['loss_mesh']:.7f} vs {d['loss_one']:.7f}; retrieval shortlist "
        f"over all {d['items']:,} items, each rank's {d['shortlist']} ids "
        f"the single card's, {d['shortlist_ms']:.1f} ms on rank 0, l2_topk "
        f"launches by rank {[r['l2_topk'] for r in ranks]} ({d['s']:.1f} s) "
        f"| "
        f"compressed DP ({dp['s']:.1f} s) "
        f"(int8_ef, (4,) data mesh, config c, reduced): loss after 10 steps "
        f"{dp['loss_dp']:.5f} vs make_train_step {dp['loss_ref']:.5f} "
        f"(|diff| {abs(dp['loss_dp'] - dp['loss_ref']):.5f} < 0.05)")
    _mesh_b_log(r4["b"], refs_b, ranks, card)
    _mesh_c_log(r4["c"], refs_c, card)
    log(f"mesh C: ring ops {r4['c']['ring_s']:.1f} s, GNN ring steps "
        f"{r4['c']['gnn_s']:.1f} s on rank 0, one-card references "
        + ", ".join(f"{a} {v['s']:.1f} s" for a, v in refs_c.items())
        + f"; kernel launches over both: none | {card}")
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s | {card}")
    return {"ranks": ranks, "parent": parent}


def _mesh_b_checks(b: dict, refs: dict) -> None:
    """Phase 14.5-14.7's checks on rank 0's report (each number in it
    gathered from every rank where it differs by rank)."""
    for row in b["long_checks"]:
        if not all(row["close"]):
            raise AssertionError(f"long_500k at {row['pos']}: logits by rank "
                                 f"{row['err']} beyond rtol / atol "
                                 f"{SEQ_TOL} of the single card's")
        if sum(row["mine"]) != 1 or max(row["row_ulps"]) > 1.0 \
                or not all(row["untouched"]):
            raise AssertionError(f"long_500k at {row['pos']}: the row is "
                                 f"written by ranks {row['mine']}, "
                                 f"{max(row['row_ulps'])} bf16 ulps from "
                                 f"the parent's; others untouched "
                                 f"{row['untouched']}")
    if not all(s["finite"] for s in b["long_steps"]):
        raise AssertionError("long_500k bf16 steps: logits not finite")
    d = b["d32_checks"]
    if max(d["prefill_err"]) > LM_TOL or not all(d["prefill_agree"]) \
            or max(d["err"]) > LM_TOL or not all(d["agree"]):
        raise AssertionError(f"decode_32k under head: prefill logits by rank "
                             f"{d['prefill_err']}, steps {d['err']}, beyond "
                             f"{LM_TOL} of the single card's (or greedy "
                             f"tokens differ: {d['prefill_agree']}, "
                             f"{d['agree']})")
    q, ref = b["qwen"], refs["qwen"]
    f32 = q["f32"]
    if abs(f32["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"]) \
            or abs(f32["grad_norm"] - ref["grad_norm"]) \
            > 1e-3 * ref["grad_norm"]:
        raise AssertionError(f"qwen expert-parallel f32 step 0: loss "
                             f"{f32['loss']} vs {ref['loss']} (rtol 1e-4), "
                             f"grad norm {f32['grad_norm']} vs "
                             f"{ref['grad_norm']} (rtol 1e-3)")
    if any(r["send"] or r["expert"] for r in f32["dropped"]):
        raise AssertionError(f"qwen f32 step 0 dropped slots at the no-drop "
                             f"capacities: {f32['dropped']}")
    losses = [s["loss"] for s in q["steps"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"qwen expert-parallel bf16 losses: {losses}")
    if not q["decode"]["finite"]:
        raise AssertionError("qwen head decode: logits not finite")


def _comm(c) -> str:
    return ", ".join(f"{k} {c['calls'][k]} ({c['bytes'][k] / 1e6:.3f} MB)"
                     for k in sorted(c["calls"]))


def _mesh_b_log(b: dict, refs: dict, ranks, card) -> None:
    lc = b["long_checks"]
    med = statistics.median(s["ms"] for s in b["long_steps"])
    log(f"mesh long_500k: olmo-1b full width, {MESH_LAYERS} of 16 layers "
        f"(reduced), B=1, {LONG_S:,} positions, kv_mode seq_all over the "
        f"(2, 2) mesh: bf16 cache {b['long_cache_gb'] * 4:.2f} GB, each "
        f"rank's block {b['long_block']} ({b['long_cache_gb']:.2f} GB; "
        f"synthetic, drawn {LONG_CHUNK:,} positions a seed) | single-card "
        f"f32 reference {refs['long_s']:.1f} s | "
        + " | ".join(
            f"f32 step at {r['pos']:,}: written by rank {r['mine'].index(1)} "
            f"(local lengths {r['local_len']}), row within "
            f"{max(r['row_ulps']):.3f} bf16 ulp of the single card's "
            f"({max(r['row_bits_equal']):.4f} of its values bitwise), "
            f"logits max |mesh - card| by rank "
            + ", ".join(f"{e:.3g}" for e in r["err"])
            + f" (rtol / atol {SEQ_TOL}), {r['ms']:.1f} ms"
            for r in lc)
        + f" | {card}")
    log(f"  long_500k bf16 steps (rank 0, gloo on one card, not a figure "
        f"of NCCL): median {med:.1f} ms ("
        + ", ".join(f"{s['ms']:.1f}" for s in b["long_steps"])
        + f") | collectives a step on rank 0: "
        f"{_comm(b['long_steps'][-1]['comm'])} | peak GiB by rank: "
        + ", ".join(f"{v:.2f}" for v in b["long_peak"])
        + f" | {b['long_s']:.1f} s | {card}")
    d = b["d32"]
    dc = b["d32_checks"]
    med = statistics.median(s["ms"] for s in d["steps"])
    log(f"mesh decode_32k: olmo-1b full width, {MESH_LAYERS} of 16 layers "
        f"(reduced), B={D32_B} x {D32_S:,} slots, kv_mode head over the (2, "
        f"2) mesh (each rank's block {d['block']}, {d['cache_gb']:.2f} GB, "
        f"{d['cache_gb'] * 4:.2f} GB in all): sharded prefill of "
        f"{D32_PROMPT} tokens {d['prefill_ms']:.1f} ms, logits max |mesh - "
        f"card| by rank " + ", ".join(f"{e:.3g}" for e in dc["prefill_err"])
        + f" (tol {LM_TOL}); {MESH_DECODE_STEPS} steps under auto at "
        f"{D32_S - MESH_DECODE_STEPS:,}+: max |mesh - card| by rank "
        + ", ".join(f"{e:.3g}" for e in dc["err"])
        + f", greedy tokens agree; step median {med:.1f} ms on rank 0 ("
        + ", ".join(f"{s['ms']:.1f}" for s in d["steps"])
        + f"), collectives a step {_comm(d['steps'][-1]['comm'])}; "
        f"flash_decode launches by rank "
        f"{[r['flash_decode'] for r in ranks]} | peak GiB by rank: "
        + ", ".join(f"{v:.2f}" for v in b["d32_peak"])
        + f" | single-card reference {refs['d32_s']:.1f} s, mesh "
        f"{b['d32_s']:.1f} s | {card}")
    q, ref = b["qwen"], refs["qwen"]
    f32 = q["f32"]
    a2a = [s["comm"]["bytes"].get("all_to_all", 0) / 1e6 for s in q["steps"]]
    log(f"mesh qwen2-moe-a2.7b: full width, {QWEN_LAYERS} of 24 layers "
        f"(reduced), expert-parallel over model x FSDP over data, "
        f"B={QWEN_B} x {QWEN_S}, {QWEN_STEPS} bf16 step(s) (reduced from 4) "
        f"| "
        f"f32 step 0 (remat none) at no-drop capacities 8.0 / 8.0: loss {f32['loss']:.6f} vs single card {ref['loss']:.6f} (rel "
        f"{abs(f32['loss'] - ref['loss']) / abs(ref['loss']):.2e}), grad "
        f"norm {f32['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
        f"{abs(f32['grad_norm'] - ref['grad_norm']) / ref['grad_norm']:.2e})"
        f", {f32['ms']:.1f} ms, no slot dropped | bf16 steps at 1.25 / 1.5: "
        + ", ".join(f"loss {s['loss']:.4f} ({s['ms']:.1f} ms)"
                    for s in q["steps"])
        + f"; all_to_all MB a step on rank 0: "
        + ", ".join(f"{v:.1f}" for v in a2a)
        + f"; collectives of the last step on rank 0: "
        f"{_comm(q['steps'][-1]['comm'])} | dropped slots by rank in each "
        f"step's forward: "
        + "; ".join(", ".join(f"{r['send'] + r['expert']} of {r['slots']} "
                              f"(send {r['send']}, expert {r['expert']})"
                              for r in s["dropped"]) for s in q["steps"])
        + f" | head decode step: logits {q['decode']['shape']}, block "
        f"{q['decode']['block']}, {q['decode']['ms']:.1f} ms | peak GiB by "
        f"rank: " + ", ".join(f"{v:.2f}" for v in q["peak"])
        + f" | single-card reference {refs['qwen_s']:.1f} s, mesh "
        f"{q['s']:.1f} s | {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size of the query path (default: SIFT1M)")
    ap.add_argument("--build-n", type=int, default=25_000,
                    help="corpus size of the construction path (default: "
                         "a fortieth of SIFT1M; the host-Python refine and "
                         "nav graph grow faster than N)")
    ap.add_argument("--disk-n", type=int, default=5_000,
                    help="corpus size of phase 8's comparison of BAMG, "
                         "DiskANN and Starling built on the card, of phase "
                         "9's BAMG fleet and of phase 10's deployment")
    ap.add_argument("--inserts", type=int, default=250,
                    help="vectors phase 10 inserts into the fresh index "
                         "(5%% of --disk-n's BAMG)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    from repro_torch.kernels.pq_adc.ops import FORMS as ADC_FORMS
    from repro_torch.kernels.pq_adc.ops import plan as adc_plan
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

    counters = kernel_counters()

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
    t_phase = time.perf_counter()

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

    # ADC, bitwise: odd B, N and R, integer tables, >48 KB tables (M = 64);
    # both of `plan`'s forms on either side of its cut (B = 3, K = 256:
    # staged from N = 45,056); M = 8, 12 (rows never 16-byte aligned), 48
    # and 64; codes one byte into their storage; B = N = 1; K = 16
    def adc_codes(shape, k, offset):
        flat = rng.integers(0, k, int(np.prod(shape)) + offset)
        return on_dev(flat.astype(np.uint8))[offset:].view(shape)
    adc_forms = {"pq_adc": set(), "pq_adc_rowwise": set()}
    for name, fn, ref, cases in (
            ("pq_adc", pq_adc, pq_adc_ref, (
                (37, 1000, 8, 64, True, 0), (5, 333, 64, 256, False, 0),
                (3, 70000, 16, 256, False, 0), (3, 45056, 16, 256, True, 0),
                (3, 44968, 16, 256, True, 0), (9, 500, 12, 256, False, 1),
                (3, 70000, 12, 256, False, 1), (2, 70000, 64, 256, False, 0),
                (4, 2000, 48, 256, False, 0), (1, 1, 16, 256, False, 0),
                (1, 1, 12, 256, False, 1), (64, 256, 16, 16, True, 0),
                (300, 31, 16, 16, True, 0), (64, 256, 16, 256, False, 1))),
            ("pq_adc_rowwise", pq_adc_rowwise, pq_adc_rowwise_ref, (
                (37, 5, 32, 256, True, 0), (3, 257, 64, 256, False, 0),
                (64, 32, 8, 256, False, 0), (13, 33, 12, 256, True, 1),
                (1, 1, 16, 256, False, 0), (64, 32, 16, 16, True, 0),
                (64, 20, 16, 16, True, 0), (2, 70000, 16, 256, False, 0),
                (64, 32, 16, 256, False, 1)))):
        for b, n, m, k, integer, offset in cases:
            t = tables_for(b, m, k, integer)
            c = adc_codes((n, m) if name == "pq_adc" else (b, n, m), k,
                          offset)
            p = adc_plan(b, n, m, k, c.data_ptr())
            adc_forms[name].add(p.form)
            errs[name] = max(errs[name], same(
                f"{name} B={b} N={n} M={m} K={k} offset={offset} {p.form} "
                f"vec={p.vec}", [fn(t, c)], [ref(t, c)], exact=True))
    if any(seen != set(ADC_FORMS) for seen in adc_forms.values()):
        raise AssertionError(f"the ADC checks reached forms {adc_forms}")
    log("kernel checks pq_adc, pq_adc_rowwise: bitwise in both forms")
    # beam: padded graphs with dead ends, rows without seeds, hop budgets
    # past exhaustion, L not a warp multiple, and the limits L=1024, R=256;
    # then a duplicate-heavy graph (each row holds its ids twice, across
    # two warps of candidates, and a self-loop; each pool also holds its
    # best seed's neighbours under dists that are not their ADC scores)
    for b, n, r, m, k, l, hops, integer, dup in (
            (37, 5000, 24, 8, 64, 48, 40, True, False),
            (19, 300, 16, 8, 16, 300, 400, True, False),
            (8, 20000, 256, 64, 256, 1024, 8, False, False),
            (37, 5000, 64, 16, 256, 64, 40, True, True)):
        adj = random_graph(n, r, pad=0.2, dead=0.05)
        codes = on_dev(rng.integers(0, k, (n, m)).astype(np.uint8))
        t = tables_for(b, m, k, integer)
        cands = torch.arange(0, n, max(1, n // 64), device=dev)
        pool = seeded_pool(t, codes, cands, 4, l)
        pool[0][::5] = -1                        # rows with no seed at all
        pool[1][::5] = torch.inf
        if dup:
            adj[:, r // 2:] = adj[:, :r // 2]
            adj[:, -1] = adj[:, 0]
            nodes = torch.arange(n, device=dev)
            adj[nodes, nodes % r] = nodes.to(torch.int32)
            nb = torch.where(pool[0][:, :1] >= 0,
                             adj[pool[0][:, 0].clamp_min(0).long()], -1)
            pool = pool_merge(*pool, nb, on_dev(
                (rng.random(nb.shape) * m).astype(np.float32)), l)
        got = beam_hops(adj, *pool, hops, tables=t, codes=codes)
        want = beam_hops_ref(adj, *pool, hops, tables=t, codes=codes)
        errs["beam_hops"] = max(errs["beam_hops"], same(
            f"beam_hops B={b} N={n} R={r} L={l} hops={hops} dup={dup}", got,
            want, exact=True))
        log(f"kernel check beam_hops B={b} R={r} L={l} M={m} hops={hops} "
            f"dup={dup}: ok (done rows {int(got[7].sum())}/{b}, hops "
            f"{got[3].min().item()}..{got[3].max().item()})")
    # exact-L2 beam: the same ragged shapes, integer vectors (ties), a
    # GIST-wide D = 960 query row, and the limits L=1024, R=256; then a
    # duplicate-heavy graph (as for ADC, pools holding their best seed's
    # neighbours under dists that are not their L2 scores), and D = 7 rows
    # one float into their storage (4-byte copies, misaligned rows)
    for b, n, r, d, l, hops, integer, case in (
            (37, 5001, 23, 8, 48, 40, True, "plain"),
            (19, 301, 15, 8, 301, 400, True, "plain"),
            (7, 3000, 32, 960, 96, 30, False, "plain"),
            (8, 20000, 256, 16, 1024, 8, False, "plain"),
            (37, 5000, 64, 16, 64, 40, True, "dup"),
            (13, 3000, 32, 7, 40, 30, True, "offset")):
        adj = random_graph(n, r, pad=0.2, dead=0.05)
        if integer:
            x = torch.randint(-3, 4, (n + b, d), device=dev, generator=gen)
        else:
            x = torch.randn((n + b, d), device=dev, generator=gen)
        x, q = x[:n].float().contiguous(), x[n:].float().contiguous()
        if case == "offset":
            buf = torch.empty(n * d + 1, device=dev)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(n, d)
        seeds = torch.arange(0, n, max(1, n // 64), device=dev,
                             dtype=torch.int32)[None, :].expand(b, -1)
        pool = l2_pool(x, q, seeds, l)
        pool[0][::5] = -1                        # rows with no seed at all
        pool[1][::5] = torch.inf
        if case == "dup":
            adj[:, r // 2:] = adj[:, :r // 2]
            adj[:, -1] = adj[:, 0]
            nodes = torch.arange(n, device=dev)
            adj[nodes, nodes % r] = nodes.to(torch.int32)
            nb = torch.where(pool[0][:, :1] >= 0,
                             adj[pool[0][:, 0].clamp_min(0).long()], -1)
            pool = pool_merge(*pool, nb, on_dev(
                (rng.random(nb.shape) * 8 * d).astype(np.float32)), l)
        kw = dict(x=x, n2=sq_norms(x), queries=q)
        got = beam_hops(adj, *pool, hops, **kw)
        want = beam_hops_ref(adj, *pool, hops, **kw)
        errs["beam_hops_l2"] = max(errs["beam_hops_l2"], same(
            f"beam_hops_l2 B={b} N={n} R={r} D={d} L={l} hops={hops} "
            f"case={case}", got, want, exact=True))
        log(f"kernel check beam_hops_l2 B={b} R={r} L={l} D={d} hops={hops} "
            f"case={case}: ok (done rows {int(got[7].sum())}/{b}, hops "
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

    def adc_floor(p):
        """An empty kernel at plan p's geometry: the design floor."""
        return lambda: _build.launch("pq_adc floor", "pq_adc_floor_launch",
                                     dev, *p.grid, p.threads, p.smem)

    out = pq_adc(tables, ecodes)
    errs["pq_adc"] = max(errs["pq_adc"], same(
        "pq_adc main", [out], [pq_adc_ref(tables, ecodes)], exact=True))
    w_adc = tables.permute(1, 2, 0).reshape(M * K, B).contiguous()
    i_adc = (ecodes.long() + torch.arange(M, device=dev) * K).contiguous()
    lib_out = F.embedding_bag(i_adc, w_adc, mode="sum").T
    log(f"  pq_adc yardstick embedding_bag max |diff| "
        f"{float((lib_out - out).abs().max()):.3g}")
    b_bytes = (table_bytes(ecodes[None].expand(B, E, M), K) + ecodes.numel()
               + B * E * 4)
    p_adc = adc_plan(B, E, M, K, ecodes.data_ptr())
    rows["pq_adc"] = dict(
        kernel=timed(lambda: pq_adc(tables, ecodes)),
        plain=timed(lambda: pq_adc_ref(tables, ecodes)),
        library=timed(lambda: F.embedding_bag(i_adc, w_adc, mode="sum")),
        bound=bound(b_bytes, B * E * M), plan=p_adc,
        floor=timed(adc_floor(p_adc)))

    nb = torch.randint(0, n_main, (B, R), device=dev, generator=gen)
    cand_codes = codes[nb].contiguous()                      # (B, R, M)
    out = pq_adc_rowwise(tables, cand_codes)
    errs["pq_adc_rowwise"] = max(errs["pq_adc_rowwise"], same(
        "pq_adc_rowwise main", [out], [pq_adc_rowwise_ref(tables, cand_codes)],
        exact=True))
    w_row = tables.reshape(B * M * K, 1)
    i_row = (cand_codes.long() + torch.arange(M, device=dev) * K
             + torch.arange(B, device=dev)[:, None, None] * (M * K)
             ).reshape(B * R, M).contiguous()
    b_bytes = table_bytes(cand_codes, K) + cand_codes.numel() + B * R * 4
    p_row = adc_plan(B, R, M, K, cand_codes.data_ptr())
    rows["pq_adc_rowwise"] = dict(
        kernel=timed(lambda: pq_adc_rowwise(tables, cand_codes)),
        plain=timed(lambda: pq_adc_rowwise_ref(tables, cand_codes)),
        library=timed(lambda: F.embedding_bag(i_row, w_row, mode="sum")),
        bound=bound(b_bytes, B * R * M), plan=p_row,
        floor=timed(adc_floor(p_row)))

    pool = seeded_pool(tables, codes, cands, NE, L)
    got = beam_hops(adj, *pool, HOPS, tables=tables, codes=codes)
    want = beam_hops_ref(adj, *pool, HOPS, tables=tables, codes=codes)
    errs["beam_hops"] = max(errs["beam_hops"], same("beam_hops main", got,
                                                    want, exact=True))
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
    adc_ms = rows["beam_hops"]["kernel"]["device"]
    log(f"  beam_hops main: {hop_total} hops over {B} rows, "
        f"{valid_nbrs} valid neighbours scored; device "
        + (f"{adc_ms * 1e3 / HOPS:.4f} us a hop ({HOPS} hops a row, rows in "
           f"parallel; {card})" if adc_ms else "time not seen by the "
           "profiler"))

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
    hop_ms = rows["beam_hops_l2"]["kernel"]["device"]
    log(f"  beam_hops_l2 main: {int(got[3].sum())} hops over {B2} rows, "
        f"{valid_l2} valid neighbours scored; device "
        + (f"{hop_ms * 1e3 / HOPS2:.4f} us a hop ({HOPS2} hops a row, rows "
           f"in parallel), beside the ADC kernel's {adc_ms * 1e3 / HOPS:.4f} "
           f"({card})" if hop_ms and adc_ms else "time not seen by the "
           "profiler"))
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
    # bench's (bench_kernels.py), one long_500k layer, and phase 11's
    # decode_32k layers of gemma-7b (B = 2, Dh = 256) and h2o-danube-3-4b
    # (B = 128, G = 4, Dh = 120, its 4,096-slot ring), bf16, every position
    # valid; bytes: K and V once, q in, out f32; operations 4 B H S Dh
    main_fd = (8, 16, 16, 128, 32768)
    fd_rows = {}
    for b, h, hkv, dh, s in (main_fd, (4, 32, 8, 128, 8192),
                             (1, 16, 16, 128, 524288),
                             (2, 16, 16, 256, 32768),
                             (128, 32, 8, 120, 4096)):
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
        if "floor" in row:
            log(f"  {name}: {row['plan']} | design floor (an empty kernel "
                f"at that geometry): {fmt(row['floor'])}")
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

    log(f"phase 3 took {time.perf_counter() - t_phase:.1f} s | {card}")

    # ---- 4. main path at full size ----------------------------------------
    t_phase = time.perf_counter()
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
    del eng, arrays, adj, exact
    torch.cuda.empty_cache()
    log(f"phase 4 took {time.perf_counter() - t_phase:.1f} s | {card}")

    # ---- 9. the serving fleet on phase 4's corpus ------------------------
    fleet_launches = fleet_serving(
        dev, card, (ds, x, codec, codes),
        EngineConfig(l=L, max_hops=HOPS, n_entry=NE), B, R, E, args.disk_n,
        reset_counts, read_counts)
    del x, codes, codec, ds
    torch.cuda.empty_cache()

    # ---- 5. construction path: build a BAMG on the card, serve it ----------
    t_phase = time.perf_counter()
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
    del eng
    torch.cuda.empty_cache()
    log(f"phase 5 took {time.perf_counter() - t_phase:.1f} s | {card}")

    # ---- 8. the disk-resident index on phase 5's BAMG ---------------------
    disk_launches, (dd, small_idx) = disk_index(
        dev, card, (ds, graph, codec, codes, nav), served,
        EngineConfig(l=L, max_hops=HOPS, n_entry=NE), B, args.disk_n,
        reset_counts, read_counts)
    torch.cuda.empty_cache()

    # ---- 10. deployment, freshness on phase 8's --disk-n BAMG, BMRNG -------
    fresh_launches = deploy_fresh(
        dev, card, small_idx, dd, EngineConfig(l=L, max_hops=HOPS,
                                               n_entry=NE),
        B, args.disk_n, args.inserts, reset_counts, read_counts)
    del small_idx
    torch.cuda.empty_cache()

    # ---- 6. DIN serving -------------------------------------------------------
    din_launches = din_serving(dev, card, reset_counts, read_counts)

    # ---- 7. OLMo-1B decode serving ------------------------------------------
    lm_launches = lm_serving(dev, card, reset_counts, read_counts)

    # ---- 11. gemma-7b, h2o-danube-3-4b, qwen2-moe-a2.7b, moonshot ----------
    arch_launches = lm_archs(dev, card, reset_counts, read_counts)

    # ---- 12. training on the card, the trained model served -----------------
    train_launches = training(dev, card, reset_counts, read_counts)

    # ---- 13. the GNN family trained on the card -----------------------------
    gnn_launches = gnn_training(dev, card, reset_counts, read_counts)

    # ---- 14. the sharded mesh: ranks on the card over gloo -------------------
    mesh_launches = mesh_training(dev, card, reset_counts, read_counts)

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
    # the hop loop both beam-hop kernels run
    loop = "src/repro_torch/csrc/beam_loop.cuh"
    # launches on the main paths: the query path's auto and cuda runs, the
    # construction path's build for the exact-L2 kernel, DIN's retrieval,
    # LM decode
    path_launches = {k: launches["auto"][k] + launches["cuda"][k]
                     for k in counters}
    path_launches["beam_hops_l2"] = build_launches["beam_hops_l2"]
    path_launches["l2_topk"] = din_launches
    path_launches["flash_decode"] = lm_launches
    # phase 8's launches (the three index builds, `from_index` under auto
    # and cuda) go on a line of their own: the kernels line keeps the
    # counts of the paths it has always counted
    log("phase 8 launches (not in the kernels line's launches): "
        + json.dumps(disk_launches))
    log("phase 9 launches (not in the kernels line's launches): "
        + json.dumps(fleet_launches))
    log("phase 10 launches (not in the kernels line's launches): "
        + json.dumps(fresh_launches))
    log("phase 11 flash_decode launches, by arch (not in the kernels line's "
        "launches): " + json.dumps(arch_launches))
    log("phase 12 launches, by part (not in the kernels line's launches): "
        + json.dumps(train_launches))
    log("phase 13 launches, by part (not in the kernels line's launches; "
        "no hand-written kernel lies on the GNN path): "
        + json.dumps(gnn_launches))
    log("phase 14 launches, in each rank and in this process (not in the "
        "kernels line's launches; on the mesh path the sharded DIN "
        "shortlist reaches l2_topk and \"head\" decode flash_decode): "
        + json.dumps(mesh_launches))
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
        if "floor" in row:
            p = row["plan"]
            entry["plan"] = dict(form=p.form, grid=list(p.grid),
                                 threads=p.threads, smem=p.smem, vec=p.vec)
            entry["floor_ms"] = on_card(row["floor"])
        if name in also:
            entry["also_replaces"] = also[name]
            entry["source_header"] = loop
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
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s | {card}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
