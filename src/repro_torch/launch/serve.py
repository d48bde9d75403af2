"""ANN serving launcher: build a BAMG index and serve queries (port of
`repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --d 128 \
      --queries 100 --k 10 --l 40 [--compare] [--device cpu]

Builds the full paper stack (NSG -> BNF -> BAMG -> nav graph -> decoupled
layout) on a synthetic corpus -- the graph and PQ on the card (the
exact-L2 hop kernel drives the NSG frontier) unless `--device cpu` --
serves the queries through Algorithm 4 on the I/O simulator, and prints
recall / NIO / simulated QPS against the Starling and DiskANN baselines
(--compare).
"""
import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--l", type=int, default=40)
    ap.add_argument("--alpha", type=int, default=3)
    ap.add_argument("--beta", type=float, default=1.05)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--save", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the builds and the ground truth run "
                         "(default: the CUDA device; 'cpu' for the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..core.engine import (BAMGIndex, BAMGParams, DiskANNIndex,
                               DiskANNParams, StarlingIndex, StarlingParams)
    from ..data.synthetic import make_vector_dataset

    dev = resolve_device(args.device)
    ds = make_vector_dataset("serve", args.n, args.d, args.queries,
                             k_gt=args.k, seed=args.seed, device=dev)
    t0 = time.time()
    idx = BAMGIndex.build(ds.base, BAMGParams(alpha=args.alpha,
                                              beta=args.beta, seed=args.seed),
                          device=dev)
    print(f"BAMG built in {time.time()-t0:.1f}s: "
          f"{idx.graph.members.shape[0]} blocks x {idx.graph.capacity} cap, "
          f"nav layers={idx.nav.n_layers if idx.nav else 0}, "
          f"index {idx.index_bytes()/2**20:.1f} MiB, "
          f"memory {idx.memory_bytes()/2**20:.1f} MiB")
    st = idx.search_batch(ds.queries, k=args.k, l=args.l, gt=ds.gt)
    print(f"BAMG     recall@{args.k}={st.recall:.3f} NIO={st.mean_nio:.1f} "
          f"(graph {st.mean_graph_reads:.1f} + vec {st.mean_vector_reads:.1f}) "
          f"QPS~{st.qps:.0f}")
    if args.save:
        idx.save(args.save)
        print(f"saved -> {args.save}")

    if args.compare:
        t0 = time.time()
        sl = StarlingIndex.build(ds.base, StarlingParams(seed=args.seed),
                                 device=dev)
        ss = sl.search_batch(ds.queries, k=args.k, l=args.l, gt=ds.gt)
        print(f"Starling recall@{args.k}={ss.recall:.3f} NIO={ss.mean_nio:.1f} "
              f"QPS~{ss.qps:.0f}  (built {time.time()-t0:.0f}s)")
        t0 = time.time()
        da = DiskANNIndex.build(ds.base, DiskANNParams(seed=args.seed),
                                device=dev)
        sd = da.search_batch(ds.queries, k=args.k, l=args.l, gt=ds.gt)
        print(f"DiskANN  recall@{args.k}={sd.recall:.3f} NIO={sd.mean_nio:.1f} "
              f"QPS~{sd.qps:.0f}  (built {time.time()-t0:.0f}s)")


if __name__ == "__main__":
    main()
