"""The paper's technique serving the recsys architecture on the PyTorch
port: DIN retrieval over item embeddings through a BAMG disk index
against brute force (the counterpart of examples/din_retrieval.py,
through `repro_torch` only).

    PYTHONPATH=src python examples_torch/din_retrieval.py      # the card
    PYTHONPATH=src python examples_torch/din_retrieval.py --device cpu

Pipeline:
  1. train a reduced DIN for a few SGD steps on `--device` (so the item
     embeddings are non-trivial);
  2. index the item-embedding table with BAMG (the disk-ANN engine);
  3. serve user queries: interest vector -> BAMG kNN shortlist, checked
     against the exact brute-force shortlist.
`main()` returns the printed figures.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.engine import BAMGIndex, BAMGParams  # noqa: E402
from repro_torch.data.synthetic import din_batch  # noqa: E402
from repro_torch.models.recsys.din import (  # noqa: E402
    DINConfig, init_params, loss_fn)
from repro_torch.utils.tree import leaves, unflatten  # noqa: E402

KEYS = ("hist_items", "hist_cates", "hist_len", "target_item", "target_cate",
        "label")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="DIN retrieval through BAMG "
                                             "on the port")
    ap.add_argument("--n-items", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=20, help="SGD steps")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--users", type=int, default=8, help="queries served")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = DINConfig(n_items=args.n_items, n_cates=128, seq_len=24,
                    embed_dim=16, attn_mlp=(32, 16), mlp=(64, 32))
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = init_params(cfg, gen, device=dev).param_tree()
    flat = [x.detach().clone().requires_grad_() for x in leaves(tree)]

    # 1. a few plain SGD steps (lr 0.3) so the table has structure
    t0 = time.perf_counter()
    for i in range(args.steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in zip(
            KEYS, din_batch(i, args.batch, cfg.seq_len, cfg.n_items,
                            cfg.n_cates))}
        loss = loss_fn(unflatten(tree, flat), cfg, b)
        grads = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        with torch.no_grad():
            for p, g in zip(flat, grads):
                p.sub_(0.3 * g)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {"train_s": time.perf_counter() - t0, "loss": loss.item()}
    print(f"DIN trained {args.steps} steps on {dev.type} in "
          f"{out['train_s']:.1f} s, loss={out['loss']:.4f}")
    params = unflatten(tree, [p.detach() for p in flat])

    # 2. BAMG over the item-embedding table (the ANN corpus)
    table = params["item_emb"].float().cpu().numpy()
    t0 = time.perf_counter()
    idx = BAMGIndex.build(table, BAMGParams(alpha=3, beta=1.05, r=16,
                                            l_build=32, knn_k=16),
                          device=dev)
    out.update(build_s=time.perf_counter() - t0,
               blocks=int(idx.graph.members.shape[0]))
    print(f"BAMG over {len(table):,} item embeddings in {out['build_s']:.1f} "
          f"s ({out['blocks']} blocks)")

    # 3. serve: user interest -> ANN shortlist -> exact check
    hi, hc, hl, _, _, _ = din_batch(99, args.users, cfg.seq_len, cfg.n_items,
                                    cfg.n_cates)
    # query = mean item embedding of the history (as retrieval_step)
    e_hist = table[np.clip(hi, 0, cfg.n_items - 1)]
    mask = np.arange(cfg.seq_len)[None] < hl[:, None]
    q = (np.where(mask[..., None], e_hist, 0).sum(1)
         / np.maximum(hl, 1)[:, None]).astype(np.float32)
    k = 10
    nio_tot, hit_tot = 0, 0
    t0 = time.perf_counter()
    for u in range(len(q)):
        r = idx.search(q[u], k=k, l=48)
        exact = np.argsort(((table - q[u]) ** 2).sum(1))[:k]
        hit_tot += len(set(r.ids.tolist()) & set(exact.tolist()))
        nio_tot += r.nio
    out.update(recall=hit_tot / (len(q) * k), mean_nio=nio_tot / len(q),
               serve_ms_per_user=(time.perf_counter() - t0) * 1e3 / len(q),
               brute_force_blocks=table.nbytes // 4096)
    print(f"BAMG shortlist: recall@{k}={out['recall']:.2f}, avg "
          f"NIO={out['mean_nio']:.1f} (brute force would read "
          f"{out['brute_force_blocks']:,} blocks), "
          f"{out['serve_ms_per_user']:.2f} ms a user")
    return out


if __name__ == "__main__":
    main()
