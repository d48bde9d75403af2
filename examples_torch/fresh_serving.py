"""Streaming freshness on the PyTorch port: inserts and deletes over a
live BAMG index (the counterpart of examples/fresh_serving.py, through
`repro_torch` only).

    PYTHONPATH=src python examples_torch/fresh_serving.py      # the card
    PYTHONPATH=src python examples_torch/fresh_serving.py --device cpu

The FreshDiskANN pattern over BAMG (`repro_torch.index.delta`): the disk
index stays frozen; writes land in an in-memory overlay -- inserts are
wired by incremental RobustPrune into copy-on-write adjacency rows,
deletes become tombstones that stay navigable but never surface.  Every
query is served unified (frozen base + overlay, one exact top-k), so a
write is visible on the next read.  `consolidate()` folds the overlay
into a fresh build and publishes it through the blue/green deployment
lifecycle.  The deployment depot is a temporary directory, removed at
the end.  `main()` returns the printed figures.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.distances import exact_knn  # noqa: E402
from repro_torch.core.engine import BAMGParams  # noqa: E402
from repro_torch.data.synthetic import make_vector_dataset  # noqa: E402
from repro_torch.index.delta import DeltaParams, FreshService  # noqa: E402
from repro_torch.serve import EngineConfig  # noqa: E402

K, L = 10, 48


def recall(svc, queries, k=K) -> float:
    """Unified recall@k against the exact top-k of the live corpus."""
    live_x, live_ext = svc.live_corpus()
    _, rows = exact_knn(torch.from_numpy(live_x), torch.from_numpy(queries),
                        k)
    gt = live_ext[rows.numpy()]
    ids, _ = svc.search_batch(queries, k, l=L)
    hits = sum(len(set(r.tolist()) & set(g.tolist()))
               for r, g in zip(ids, gt))
    return hits / (len(gt) * k)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="streaming freshness on the "
                                             "port")
    ap.add_argument("--n", type=int, default=2000, help="corpus vectors")
    ap.add_argument("--d", type=int, default=32, help="dimension")
    ap.add_argument("--nq", type=int, default=16, help="queries")
    ap.add_argument("--inserts", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    ds = make_vector_dataset("fresh", n=args.n, d=args.d, nq=args.nq,
                             k_gt=K, n_clusters=16, seed=0, device=dev)
    out = {}
    with tempfile.TemporaryDirectory(prefix="fresh-") as root:
        svc = FreshService(root, params=BAMGParams(r=16, l_build=32, seed=0),
                           config=EngineConfig(l=L, max_hops=24),
                           delta_params=DeltaParams(r=16, ef=48), device=dev)
        t0 = time.perf_counter()
        svc.bootstrap(ds.base, "gen-0")
        out["bootstrap_s"] = time.perf_counter() - t0
        print(f"gen-0: built+published+promoted {len(ds.base)} vectors in "
              f"{out['bootstrap_s']:.1f} s on {dev} "
              f"(ACTIVE={svc.manager.active()})")

        # --- writes are visible on the next read ----------------------------
        rng = np.random.default_rng(1)
        m = args.inserts
        new = (ds.base[rng.integers(0, len(ds.base), m)]
               + 0.02 * rng.standard_normal((m, args.d)).astype(np.float32))
        t0 = time.perf_counter()
        ext = svc.insert_batch(new)
        out.update(insert_s=time.perf_counter() - t0,
                   overlay_kib=svc.delta.memory_bytes() / 2 ** 10)
        print(f"inserted {m} vectors in {out['insert_s']:.2f} s "
              f"(overlay={out['overlay_kib']:.0f} KiB)")
        ids, d = svc.search_batch(new[0][None, :], K)
        assert ids[0, 0] == ext[0]
        print(f"new vector findable immediately: id={ids[0, 0]} "
              f"d={d[0, 0]:.4f}")

        victim = int(ds.gt[0, 0])              # the top-1 of query 0
        svc.delete(victim)
        svc.delete(int(ext[1]))                # deleting fresh writes too
        ids, _ = svc.search_batch(ds.queries, K)
        assert victim not in set(ids.ravel().tolist())
        out["unified_recall"] = recall(svc, ds.queries)
        print(f"deleted id {victim} gone from results on the next read; "
              f"unified recall@{K}={out['unified_recall']:.3f}")

        # --- consolidation: fold the overlay, swap blue/green ---------------
        t0 = time.perf_counter()
        svc.consolidate("gen-1", queries=ds.queries, k=K, min_recall=0.5,
                        keep_builds=2)
        out.update(consolidate_s=time.perf_counter() - t0,
                   n_live=svc.n_live,
                   validation_recall=svc.last_validation_recall,
                   post_swap_recall=recall(svc, ds.queries))
        print(f"gen-1: consolidated {out['n_live']} live vectors in "
              f"{out['consolidate_s']:.1f} s -- published, validated "
              f"(recall={out['validation_recall']:.3f}), promoted, "
              f"hot-swapped")
        print(f"post-swap recall@{K}={out['post_swap_recall']:.3f}; builds "
              f"kept: {svc.manager.builds()} (rollback target "
              f"{svc.manager.rollback_target()})")

        ids, _ = svc.search_batch(new[0][None, :], K)
        assert ids[0, 0] == ext[0], "external ids are stable across the swap"
        print("external ids stable across id-space compaction -- done")
    return out


if __name__ == "__main__":
    main()
