"""Quickstart on the PyTorch port: build a BAMG index, search it, inspect
the I/O profile (the counterpart of examples/quickstart.py, through
`repro_torch` only).

    PYTHONPATH=src python examples_torch/quickstart.py              # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The build's products (kNN, pruning, refinement, the NSG frontier) and
the PQ training run on `--device`; the block-first search walks the
simulated disk on the host.  `main()` returns the printed figures.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.engine import BAMGIndex, BAMGParams  # noqa: E402
from repro_torch.data.synthetic import make_vector_dataset  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="BAMG quickstart on the port")
    ap.add_argument("--n", type=int, default=2000, help="corpus vectors")
    ap.add_argument("--d", type=int, default=64, help="dimension")
    ap.add_argument("--nq", type=int, default=20, help="queries")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev, k, l = args.device, 10, 40

    # 1. a corpus with exact ground truth
    ds = make_vector_dataset("quickstart", n=args.n, d=args.d, nq=args.nq,
                             k_gt=k, seed=0, device=dev)

    # 2. build: NSG -> BNF block shuffling -> BAMG refinement (Alg. 2)
    #    -> multi-layer nav graph (Alg. 3) -> decoupled disk layout (Fig. 3)
    t0 = time.perf_counter()
    idx = BAMGIndex.build(ds.base, BAMGParams(alpha=3, beta=1.05),
                          device=dev)
    out = {"build_s": time.perf_counter() - t0,
           "blocks": int(idx.graph.members.shape[0]),
           "capacity": int(idx.graph.capacity),
           "nav_layers": int(idx.nav.n_layers),
           "graph_mib": idx.store.graph_bytes / 2 ** 20,
           "vector_mib": idx.store.vector_bytes / 2 ** 20,
           "memory_mib": idx.memory_bytes() / 2 ** 20}
    print(f"built in {out['build_s']:.1f} s on {dev}: blocks "
          f"{out['blocks']} x capacity {out['capacity']}, nav layers: "
          f"{out['nav_layers']}")
    print(f"on-disk: graph {out['graph_mib']:.1f} MiB + vectors "
          f"{out['vector_mib']:.1f} MiB; in-memory: {out['memory_mib']:.2f} "
          f"MiB (PQ codes + nav)")

    # 3. search one query (Alg. 4: block-first, PQ-guided, exact re-rank)
    r = idx.search(ds.queries[0], k=k, l=l)
    out.update(q0_nio=r.nio, q0_graph_reads=r.graph_reads,
               q0_vector_reads=r.vector_reads, q0_hops=r.hops)
    print(f"query 0: {r.nio} block reads ({r.graph_reads} graph + "
          f"{r.vector_reads} vector), {r.hops} hops, "
          f"ids={r.ids[:5].tolist()}...")

    # 4. batch evaluation against ground truth
    t0 = time.perf_counter()
    st = idx.search_batch(ds.queries, k=k, l=l, gt=ds.gt)
    out.update(search_ms_per_query=(time.perf_counter() - t0) * 1e3
               / len(ds.queries), recall=st.recall, mean_nio=st.mean_nio,
               qps=st.qps)
    print(f"recall@{k}={st.recall:.3f}  NIO={st.mean_nio:.1f}  simulated "
          f"QPS~{st.qps:.0f}  ({out['search_ms_per_query']:.2f} ms a query "
          f"on the host)")

    # 5a. pipelined I/O: batched submissions at queue depth 8.  NIO is
    #     identical by construction -- only the modeled service time drops.
    idx.configure_io(qd=8, batch_io=True)
    stp = idx.search_batch(ds.queries, k=k, l=l, gt=ds.gt)
    assert stp.mean_nio == st.mean_nio
    out.update(pipelined_service_us=stp.mean_service_us,
               serial_us=stp.mean_serial_us, qps_pipelined=stp.qps_pipelined)
    print(f"pipelined qd=8: NIO={stp.mean_nio:.1f} (unchanged)  "
          f"service={stp.mean_service_us:.0f}us vs "
          f"serial={stp.mean_serial_us:.0f}us  QPS~{stp.qps_pipelined:.0f}")

    # 5b. cache engineering: 2Q block cache + the hot navigation-entry
    #     graph blocks pinned in memory (Starling-style) -- this one *does*
    #     cut NIO, by turning the per-query entry reads into hits.
    idx.configure_io(cache_policy="2q", pin_nav_blocks=16)
    stq = idx.search_batch(ds.queries, k=k, l=l, gt=ds.gt)
    out.update(cached_nio=stq.mean_nio, hit_rate=stq.cache_hit_rate,
               cached_qps=stq.qps_pipelined)
    print(f"2q + pinned nav: NIO={stq.mean_nio:.1f}  "
          f"hit_rate={stq.cache_hit_rate:.2f}  QPS~{stq.qps_pipelined:.0f}")
    idx.configure_io(cache_policy="lru", qd=1, batch_io=False,
                     pin_nav_blocks=0)

    # 6. persistence: the reference's npz, read back onto the same device
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bamg_quickstart.npz")
        idx.save(path)
        r2 = BAMGIndex.load(path, device=dev).search(ds.queries[0], k=k, l=l)
    assert np.array_equal(r.ids, r2.ids)
    print("save/load roundtrip OK")
    return out


if __name__ == "__main__":
    main()
