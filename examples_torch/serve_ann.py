"""Batched ANN serving on the PyTorch port: scatter-gather over sharded
BAMG sub-indexes (the counterpart of examples/serve_ann.py, through
`repro_torch` only).

    PYTHONPATH=src python examples_torch/serve_ann.py              # the card
    PYTHONPATH=src python examples_torch/serve_ann.py --device cpu

The corpus is partitioned into S sub-corpora; each shard builds its own
BAMG sub-index; a query batch fans out as ONE batched engine call per
shard (on the card: `pq_adc` entry scoring and the fused `beam_hops_adc`
hop loop, one launch each a shard call) and the per-shard top-k merge to
a global top-k in one pass.  The per-query host loop over the shards'
disk indexes is kept as the baseline.  The fan-out is the runtime's
SCATTER / RUN / GATHER / MERGE program over a placed shard fleet; the
tail drives the continuous-batching scheduler over an open-loop arrival
timeline (p50 / p99 against the SLO).  `main()` returns the printed
figures.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.distances import recall_at_k  # noqa: E402
from repro_torch.core.engine import BAMGParams  # noqa: E402
from repro_torch.data.synthetic import make_vector_dataset  # noqa: E402
from repro_torch.serve import (EngineConfig, Scheduler,  # noqa: E402
                               SchedulerConfig, ShardedFrontend,
                               make_requests, summarize)


def _sync(dev: str) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="sharded BAMG serving on the "
                                             "port")
    ap.add_argument("--n", type=int, default=4000, help="corpus vectors")
    ap.add_argument("--d", type=int, default=64, help="dimension")
    ap.add_argument("--nq", type=int, default=32, help="queries")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--requests", type=int, default=96,
                    help="scheduler requests")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev, k, n_shards = args.device, 10, args.shards
    ds = make_vector_dataset("serve", n=args.n, d=args.d, nq=args.nq,
                             k_gt=k, seed=0, device=dev)
    params = BAMGParams(alpha=3, beta=1.05, r=16, l_build=32, knn_k=16)

    t0 = time.perf_counter()
    frontend = ShardedFrontend.build(ds.base, n_shards, params=params,
                                     config=EngineConfig(l=24, max_hops=24),
                                     device=dev)
    out = {"build_s": time.perf_counter() - t0}
    print(f"{n_shards} BAMG sub-indexes built in {out['build_s']:.1f} s on "
          f"{dev} (independent -> elastic scale-out)")

    # --- batched path: one engine call per shard, one global merge ---------
    frontend.search_batch(ds.queries, k=k)        # kernel build + warm
    _sync(dev)
    t0 = time.perf_counter()
    ids, _ = frontend.search_batch(ds.queries, k=k)
    _sync(dev)
    batched_s = time.perf_counter() - t0
    n_q = len(ds.queries)
    out.update(recall=recall_at_k(ids, ds.gt, k),
               batched_ms_per_query=batched_s / n_q * 1e3,
               batched_qps=n_q / batched_s)
    print(f"batched: recall@{k}={out['recall']:.3f}, "
          f"{out['batched_ms_per_query']:.3f} ms/query "
          f"({out['batched_qps']:.0f} qps, one call per shard per batch)")

    # --- host baseline: per-query per-shard loop over the disk indexes -----
    tops = []
    nio = 0
    t0 = time.perf_counter()
    for q in ds.queries:
        cand_ids, cand_d = [], []
        for vids, idx in zip(frontend.shard_vids, frontend.host_indexes):
            r = idx.search(q, k=k, l=24)
            cand_ids.append(vids[r.ids])
            cand_d.append(r.dists)
            nio += r.nio
        all_ids = np.concatenate(cand_ids)
        all_d = np.concatenate(cand_d)
        tops.append(all_ids[np.argsort(all_d)[:k]])
    host_s = time.perf_counter() - t0
    out.update(host_recall=recall_at_k(np.stack(tops), ds.gt, k),
               host_nio_per_query=nio / n_q,
               host_ms_per_query=host_s / n_q * 1e3,
               speedup=host_s / batched_s)
    print(f"host loop: recall@{k}={out['host_recall']:.3f}, NIO/query "
          f"(summed over shards)={out['host_nio_per_query']:.1f}, "
          f"{out['host_ms_per_query']:.1f} ms/query -> batched speedup "
          f"{out['speedup']:.1f}x")

    # --- the runtime underneath: compiled program + request scheduler ------
    rt = frontend.runtime
    prog = " ".join(f"{ins.op.name}({ins.shard})" if ins.shard >= 0
                    else ins.op.name for ins in rt.program)
    print(f"\ncompiled serving program ({rt.n_shards} shards, "
          f"{rt.health()['n_workers']} worker(s)): {prog}")

    slo = 0.5
    sched = Scheduler(rt, SchedulerConfig(k=k, max_batch=16, slo=slo))
    reqs = make_requests(ds.queries, qps=100.0, slo=slo, n=args.requests,
                         seed=0)
    s = summarize(sched.run(reqs))
    out.update({f"sched_{key}": s[key] for key in (
        "p50_ms", "p99_ms", "deadline_hit", "shrunk_frac", "achieved_qps")})
    print(f"scheduler @100 qps offered, SLO={slo * 1e3:.0f}ms: "
          f"p50={s['p50_ms']:.1f}ms p99={s['p99_ms']:.1f}ms "
          f"deadline_hit={s['deadline_hit']:.2f} "
          f"shrunk_frac={s['shrunk_frac']:.2f} "
          f"({s['achieved_qps']:.0f} qps achieved)")
    return out


if __name__ == "__main__":
    main()
