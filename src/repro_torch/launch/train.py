"""End-to-end training launcher (port of `repro.launch.train`, one device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 200 --reduced --batch 8 --seq 128 [--device cpu]

Runs the train step (`train.trainer.make_train_step`, state updated in
place) on the card unless `--device cpu`, with checkpoint/restart in the
reference's format (--ckpt-dir), deterministic step-indexed data and
metrics logging.  --reduced (the default) uses the arch's smoke config;
--full the published one.  The LM and recsys families train, and of the
GNN family graphcast, on a 256-node random graph with fixed targets (the
reference's demo); the other GNN archs exit as the reference's launcher
does.
"""
import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA "
                         "device; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from .._device import resolve_device, to_device
    from ..configs.registry import get_arch
    from ..data.synthetic import din_batch, lm_batch
    from ..train import checkpoint as ckpt
    from ..train.optimizer import AdamWConfig
    from ..train.trainer import init_train_state, make_train_step
    from ..utils.tree import tree_count_params

    mod = get_arch(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    opt_cfg = AdamWConfig(lr=args.lr,
                          warmup_steps=min(50, args.steps // 10 + 1),
                          total_steps=args.steps)
    cfg = mod.model_config(reduced=args.reduced)

    if mod.FAMILY == "lm":
        from ..models.transformer import init_lm_params, lm_loss

        def loss_fn(params, batch):
            return lm_loss(params, cfg, batch["tokens"], batch["labels"])

        def batch_fn(step):
            t, l = lm_batch(step, args.batch, args.seq, cfg.vocab,
                            seed=args.seed)
            return {"tokens": to_device(t, dev), "labels": to_device(l, dev)}

        params = init_lm_params(cfg, gen, device=dev)
    elif mod.FAMILY == "recsys":
        from ..models.recsys import din as m

        def loss_fn(params, batch):
            return m.loss_fn(params, cfg, batch), {}

        def batch_fn(step):
            arrays = din_batch(step, args.batch, cfg.seq_len, cfg.n_items,
                               cfg.n_cates, seed=args.seed)
            return {k: to_device(v, dev) for k, v in zip(
                ("hist_items", "hist_cates", "hist_len", "target_item",
                 "target_cate", "label"), arrays)}

        params = m.init_params(cfg, gen, device=dev,
                               trainable=True).param_tree()
    else:  # gnn
        import numpy as np

        from ..data.synthetic import random_graph
        from ..models.gnn import graphcast as gc
        if args.arch != "graphcast":
            raise SystemExit("gnn trainer demo supports graphcast; "
                             "see tests/test_arch_smoke.py for the others")
        g = random_graph(256, 2048, d_feat=cfg.d_feat, seed=args.seed)
        targets = np.random.default_rng(1).normal(
            size=(256, cfg.n_vars)).astype(np.float32)
        graph = {"node_feat": to_device(g.node_feat, dev),
                 "edge_src": to_device(g.edge_src, dev),
                 "edge_dst": to_device(g.edge_dst, dev),
                 "edge_feat": to_device(g.edge_feat, dev),
                 "targets": to_device(targets, dev)}

        def loss_fn(params, batch):
            return gc.loss_fn(params, cfg, batch), {}

        def batch_fn(step):
            return graph

        params = gc.init_params(cfg, gen, device=dev)

    print(f"arch={args.arch} reduced={args.reduced} "
          f"params={tree_count_params(params):,} device={dev}")

    state = init_train_state(params, opt_cfg)
    step_fn = make_train_step(loss_fn, opt_cfg)

    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, start = ckpt.restore(args.ckpt_dir, state)
            print(f"restored step {start} from {args.ckpt_dir}")

    t_start = time.time()
    for s in range(start, args.steps):
        state, metrics = step_fn(state, batch_fn(s))
        if (s + 1) % args.log_every == 0:
            dt = (time.time() - t_start) / (s + 1 - start)
            print(f"step {s+1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt*1e3:.0f} ms/step)",
                  flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s + 1, state)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state)
    print("done")


if __name__ == "__main__":
    main()
