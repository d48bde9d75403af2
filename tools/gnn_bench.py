"""Time where a GNN training step goes on the card: GraphCast's gathers
and scatters at minibatch_lg, and NequIP's host dispatch at the
molecule cell.

GraphCast at its full config (16 x 512, bf16) on one minibatch_lg
sample (1,024 seeds at fanout [15, 10] from `chip_smoke`'s base graph,
padded to 169,984 nodes x 168,960 edges, about 97,000 of them -1 pads):
one loss-and-gradient evaluation, timed 3 times after a warm-up, under
four ways to gather and scatter, in turns (a, b, c, d, c, b, a):

  a  the port's: `index_select` gathers (pads clipped to row 0), one
     dump row for the padded messages;
  b  as a, the padded messages spread over 1,024 dump rows;
  c  as b, the pads' gathers spread over the real rows (their values
     reach no output);
  d  advanced indexing `x[idx]` for the gathers (its backward sorts the
     indices and sums each run of duplicates in turn), timed once;

then the device time by kernel under a and c (torch.profiler).  NequIP
at its full config on the molecule cell: a loss-and-gradient evaluation
and a whole train step (AdamW leaf by leaf) timed apart, and one step's
aten ops by calls.

    python3 tools/gnn_bench.py

Needs a CUDA device; prints the card's name and power limit.
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DUMP_ROWS = 1024


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import graphcast_cfg, nequip_cfg
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models.gnn import graphcast, nequip
    from repro_torch.models.gnn.common import segment_sum
    from repro_torch.models.gnn.sampler import (csr_from_edges,
                                                expected_sizes, padded_sample)
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           make_train_step)

    if not torch.cuda.is_available():
        print("gnn_bench: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # --- GraphCast at minibatch_lg: one sample --------------------------
    shape = GNN_SHAPES["minibatch_lg"]
    cfg = graphcast_cfg.model_config(d_feat=shape.d_feat)
    g = random_graph(shape.n_nodes, shape.n_edges // 10, d_feat=shape.d_feat,
                     seed=0)
    csr = csr_from_edges(shape.n_nodes, g.edge_src, g.edge_dst)
    fan = list(shape.fanout)
    mn, me = expected_sizes(shape.batch_nodes, fan)
    b = padded_sample(csr, g.node_feat, g.labels, shape.batch_nodes, fan,
                      step=0, max_nodes=mn, max_edges=me, seed=0)
    rng = np.random.default_rng(1)
    b["edge_feat"] = rng.normal(size=(me, cfg.d_edge)).astype(np.float32)
    b["targets"] = rng.normal(size=(mn, cfg.n_vars)).astype(np.float32)
    del b["labels"], b["seed_mask"], g, csr
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = graphcast.init_params(cfg, gen, device=dev)
    print(f"{card} | graphcast minibatch_lg: {mn} nodes x {me} edge slots, "
          f"{int((b['edge_src'] < 0).sum())} of them -1 pads", flush=True)

    port_scatter = graphcast.scatter_to_nodes
    port_gather = graphcast.gather_src_dst

    def spread_scatter(messages, edge_dst, n_nodes, mask=None, agg="sum"):
        dump = torch.arange(edge_dst.shape[0], device=edge_dst.device)
        dst = torch.where(mask, edge_dst.long(), n_nodes + dump % DUMP_ROWS)
        m = torch.where(mask[:, None], messages, 0.0)
        return segment_sum(m, dst, n_nodes + DUMP_ROWS)[:n_nodes]

    def spread_gather(x, src, dst):
        real = torch.arange(src.shape[0], device=src.device) % x.shape[0]
        return (torch.index_select(x, 0, torch.where(src >= 0, src.long(),
                                                     real)),
                torch.index_select(x, 0, torch.where(dst >= 0, dst.long(),
                                                     real)))

    def index_gather(x, src, dst):
        n = x.shape[0]
        return x[src.clamp(0, n - 1).long()], x[dst.clamp(0, n - 1).long()]

    variants = {"a": (port_scatter, port_gather),
                "b": (spread_scatter, port_gather),
                "c": (spread_scatter, spread_gather),
                "d": (port_scatter, index_gather)}

    def evaluate():
        return loss_and_grads(
            lambda p, bt: (graphcast.loss_fn(p, cfg, bt), {}), params, batch)

    times = {k: [] for k in variants}
    try:
        for name in "abcdcba":
            graphcast.scatter_to_nodes, graphcast.gather_src_dst = \
                variants[name]
            evaluate()
            for _ in range(1 if name == "d" else 3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                evaluate()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name, ts in times.items():
            print(f"  {name}: loss and gradients {statistics.median(ts):.2f} "
                  f"ms (median of {len(ts)}: "
                  + ", ".join(f"{t:.2f}" for t in ts) + ")", flush=True)
        for name in "ac":
            graphcast.scatter_to_nodes, graphcast.gather_src_dst = \
                variants[name]
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                evaluate()
                torch.cuda.synchronize()
            avg = sorted(prof.key_averages(),
                         key=lambda a: -a.self_device_time_total)
            total = sum(a.self_device_time_total for a in avg) / 1e3
            print(f"  {name}: device {total:.2f} ms, "
                  f"{sum(a.count for a in avg)} kernel runs; the top 8:")
            for a in avg[:8]:
                print(f"    {a.self_device_time_total / 1e3:8.2f} ms "
                      f"{a.count:5d} x {a.key[:100]}")
    finally:
        graphcast.scatter_to_nodes = port_scatter
        graphcast.gather_src_dst = port_gather
    del params, batch
    torch.cuda.empty_cache()

    # --- NequIP at the molecule cell: host dispatch ---------------------
    cfg = nequip_cfg.model_config()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in chip_smoke._molecule_batch("nequip").items()}
    gen.manual_seed(0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    state = init_train_state(nequip.init_params(cfg, gen, device=dev), opt)

    def loss_fn(p, bt):
        return nequip.loss_fn(p, cfg, bt), {}

    step = make_train_step(loss_fn, opt)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_and_grads(loss_fn, state["params"], batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{card} | nequip molecule: loss and gradients "
          f"{(t1 - t0) * 1e3:.2f} ms, a whole train step "
          f"{(t2 - t1) * 1e3:.2f} ms", flush=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    ops = sorted((a for a in prof.key_averages()
                  if a.key.startswith("aten::")), key=lambda a: -a.count)
    print(f"  one step: {sum(a.count for a in ops)} aten calls; the top 10:")
    for a in ops[:10]:
        print(f"    {a.count:6d} x {a.key}: host {a.self_cpu_time_total / 1e3:.2f}"
              f" ms, device {a.device_time_total / 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
