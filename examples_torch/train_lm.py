"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM with
checkpoint / restart (the counterpart of examples/train_lm.py, through
`repro_torch` only).

    PYTHONPATH=src python examples_torch/train_lm.py --steps 300   # the card
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 4 \
        --layers 2 --d-model 64 --vocab 256 --seq 16

~100M params: 8 layers, d_model=512, 8 heads, d_ff=2048, vocab=32000, f32.
Restart safety: kill it mid-run and rerun -- it resumes from the latest
checkpoint and the loss curve continues exactly (stateless step-indexed
data, `train/ft.py`).  `--stop-after K` ends a run after step K's
checkpoint, as a kill there would.  Checkpoints go to `--ckpt-dir`
(default `build/examples/train_lm` under the repository root).  `main()`
returns the logged losses and the step time.
"""
import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.models.transformer import (LMConfig,  # noqa: E402
                                            init_lm_params, lm_loss)
from repro_torch.train.ft import (FTConfig, resume_or_init,  # noqa: E402
                                  run_loop)
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import (init_train_state,  # noqa: E402
                                       make_train_step)
from repro_torch.utils.tree import tree_count_params  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train a ~100M LM with "
                                             "checkpoint / restart")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stop-after", type=int, default=None,
                    help="end the run after this step's checkpoint")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        ROOT, "build", "examples", "train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    d = args.d_model
    cfg = LMConfig(name="lm100m", n_layers=args.layers, d_model=d,
                   n_heads=8, n_kv_heads=8, d_head=d // 8, d_ff=4 * d,
                   vocab=args.vocab, remat="none", loss_chunks=8,
                   dtype="float32")
    opt = AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps)

    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"])

    def batch_fn(step):
        t, l = lm_batch(step, args.batch, args.seq, cfg.vocab, seed=0)
        return {"tokens": torch.from_numpy(t).to(dev),
                "labels": torch.from_numpy(l).to(dev)}

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(0)
        return init_train_state(init_lm_params(cfg, gen, device=dev), opt)

    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    state = resume_or_init(init_fn, ft)
    start = int(state["step"])
    n_params = tree_count_params(state["params"])
    print(f"params: {n_params / 1e6:.1f}M on {dev.type}")
    if start:
        print(f"resumed from step {start}")
    end = args.steps if args.stop_after is None else min(args.stop_after,
                                                         args.steps)
    step_fn = make_train_step(loss_fn, opt, donate=False)
    t0 = time.perf_counter()
    state, logs = run_loop(state, step_fn, batch_fn, end, ft,
                           log_every=args.log_every)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(end - start, 1)
    for s, m in logs:
        print(f"step {s:4d}  loss {m['loss']:.4f}  gnorm "
              f"{m['grad_norm']:.2f}")
    print(f"done ({ms:.0f} ms/step, checkpoints included); checkpoints in "
          f"{args.ckpt_dir}")
    return {"params": n_params, "start": start, "end": end,
            "losses": {s: m["loss"] for s, m in logs}, "ms_per_step": ms}


if __name__ == "__main__":
    main()
