#!/usr/bin/env python3
"""h2o-danube-3-4b's kv heads shared by tensor-parallel ranks, on the card.

On the production meshes danube's 8 kv heads meet tp 16: each head is
shared by f = 2 "model" ranks, each storing 60 of its 120 wk / wv
columns, gathering the head's 120 to compute with
(`models.transformer._kv_head_weights`).  This tool runs that layout at
the published widths on a (1, 16) mesh: 16 ranks spawned on the one
card, joined over gloo (NCCL refuses two ranks on one device), with 2
of the 24 layers (`reduced`: each rank draws the whole f32 model to take
its blocks, 2.2 GB at 2 layers and 16 of them at once, where 24 layers
would need 16 x 15.8 GB).  It holds:

- an f32 step 0 (`lm_loss` and its gradients, B = 2 x 512) against the
  same step on one card: loss within rtol 1e-4, gradient norm within
  rtol 1e-3 (phase 14's rule);
- an f32 prefill of S = 4,096 tokens (`serve_prefill`): every rank's
  last-token logits within rtol / atol 3e-4 of one card's, and each
  rank's cache that of its head m // 2 on one card, within the same.

It prints each rank's peak GiB, the step's and the prefill's ms on rank
0 (gloo on one card, not a figure of NCCL), the ranks' start-up and the
card's name and power limit, and writes them as JSON to
`chiprun_out/kv_share_check.json`.  If the 16 ranks cannot start on the
card, it says why and exits 1.

    PYTHONPATH=src python3 tools/kv_share_check.py           # the card
    PYTHONPATH=src python3 tools/kv_share_check.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src")]

SEED = 0
TOL = 3e-4
LAYERS = 2


def _config(reduced: bool):
    """danube in f32 with LAYERS of its layers (the reduced config's 2
    under --reduced)."""
    import dataclasses

    from repro_torch.configs import h2o_danube3_4b

    cfg = h2o_danube3_4b.model_config(reduced=reduced)
    return dataclasses.replace(cfg, n_layers=LAYERS, dtype="float32")


def _params(cfg, dev):
    """f32 parameters drawn on dev from SEED: the same bits on every rank
    and in the parent."""
    import torch

    from repro_torch.models.transformer import init_lm_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return init_lm_params(cfg, gen, device=dev)


def _inputs(cfg, b: int, s: int, s_pre: int):
    from repro_torch.data.synthetic import lm_batch

    tokens, labels = lm_batch(0, b, s, cfg.vocab, seed=SEED)
    prompt, _ = lm_batch(1, 1, s_pre, cfg.vocab, seed=SEED)
    return tokens, labels, prompt


def _loss_fn(cfg, ctx):
    from repro_torch.models.transformer import lm_loss

    def fn(p, b):
        return lm_loss(p, cfg, b["tokens"], b["labels"], ctx)
    return fn


def _one_card(cfg, dev, tokens, labels, prompt) -> dict:
    """The same step and prefill in this process on one device."""
    import torch

    from repro_torch.models.transformer import serve_prefill
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.utils.tree import global_norm

    t0 = time.perf_counter()
    params = _params(cfg, dev)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    loss, _, g = loss_and_grads(_loss_fn(cfg, None), params, batch)
    out = {"loss": float(loss), "grad_norm": float(global_norm(g))}
    del g
    with torch.no_grad():
        logits, (ck, cv), _ = serve_prefill(params, cfg,
                                            torch.from_numpy(prompt).to(dev))
    out.update(logits=logits.cpu(), ck=ck.cpu(), cv=cv.cpu(),
               s=time.perf_counter() - t0)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _rank(mesh, reduced: bool, inputs: tuple, ref_path: str,
          t_spawn: float) -> dict:
    """Each rank: its blocks of the model, the f32 step 0 and the
    prefill; rank 0 returns every rank's figures."""
    import torch

    from repro_torch.models.transformer import (ShardCtx, lm_param_specs,
                                                serve_prefill)
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.utils import sharding
    from repro_torch.utils.sharding import all_gather, shard_tree
    from repro_torch.utils.tree import global_norm

    start = time.time() - t_spawn
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = mesh.device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = _config(reduced)
    ctx = ShardCtx(mesh=mesh)
    f = max(1, ctx.tp // cfg.n_kv_heads)      # ranks sharing a kv head
    m = mesh.get_local_rank("model")
    t0 = time.perf_counter()
    params = shard_tree(_params(cfg, dev), lm_param_specs(cfg, ctx), mesh)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    init_s = time.perf_counter() - t0
    wk = sharding.local(params["layers"]["wk"])
    tokens, labels, prompt = inputs
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}

    sharding.comm_log.reset()
    sync()
    t0 = time.perf_counter()
    loss, _, g = loss_and_grads(_loss_fn(cfg, ctx), params, batch)
    gn = global_norm(g)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_comm = sharding.comm_log.snapshot()
    del g

    sharding.comm_log.reset()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, (ck, cv), _ = serve_prefill(
            params, cfg, torch.from_numpy(prompt).to(dev), ctx=ctx)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_comm = sharding.comm_log.snapshot()
    ref = torch.load(ref_path, mmap=True)
    want = ref["logits"].to(dev)
    err = float((logits - want).abs().max())
    ok = bool(((logits - want).abs() <= TOL + TOL * want.abs()).all())
    head = slice(m // f, m // f + 1)
    cache_err = 0.0
    for got, full in ((ck, ref["ck"]), (cv, ref["cv"])):
        w = full[:, :, :, head].to(dev)
        cache_err = max(cache_err, float((got - w).abs().max()))
        ok = ok and bool(((got - w).abs() <= TOL + TOL * w.abs()).all())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0

    row = torch.tensor([[start, init_s, peak, err, cache_err, float(ok),
                         float(ck.shape[3]), float(wk.shape[-1])]],
                       dtype=torch.float64, device=dev)
    rows = all_gather(row, mesh, "model", 0).tolist()
    return {"loss": float(loss), "grad_norm": float(gn), "step_ms": step_ms,
            "prefill_ms": prefill_ms, "step_comm": step_comm,
            "prefill_comm": prefill_comm, "f": f,
            "ranks": [dict(zip(("start_s", "init_s", "peak_gib", "logit_err",
                                "cache_err", "ok", "cache_heads", "wk_cols"),
                               r)) for r in rows]}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config on a (1, 4) mesh at small "
                         "shapes (a CPU rehearsal)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch.mesh import run_ranks

    tp, b, s, s_pre = (4, 2, 32, 64) if args.reduced else (16, 2, 512, 4096)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run with --device cpu for a rehearsal")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(args.reduced)
    card = _card() if dev.type == "cuda" else "cpu"
    inputs = _inputs(cfg, b, s, s_pre)
    ref = _one_card(cfg, dev, *inputs)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    record = {"arch": "h2o-danube-3-4b", "reduced": args.reduced,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "d_head": cfg.d_head, "mesh": [1, tp], "batch": [b, s],
              "prefill_seq": s_pre, "card": card,
              "one_card": {"loss": ref["loss"], "grad_norm": ref["grad_norm"],
                           "s": ref["s"]}}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({k: ref[k] for k in ("logits", "ck", "cv")}, ref_path)
        del ref["logits"], ref["ck"], ref["cv"]
        t0 = time.perf_counter()
        try:
            got = run_ranks(_rank, (1, tp), device=dev.type,
                            init_method=f"file://{tmp}/init",
                            args=(args.reduced, inputs, ref_path,
                                  time.time()),
                            timeout=600, threads=1)
        except (RuntimeError, TimeoutError) as e:
            record["failed"] = f"{type(e).__name__}: {e}"[-4000:]
            print(f"kv_share_check: {tp} ranks on one {dev.type} device did "
                  f"not complete: {record['failed']}")
            with open(os.path.join(out_dir, "kv_share_check.json"), "w") as fh:
                json.dump(record, fh, indent=1)
            return 1
        record["spawn_s"] = time.perf_counter() - t0
    record.update(got)
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_rel = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    ranks = got["ranks"]
    checks = {"loss": loss_rel <= 1e-4, "grad_norm": norm_rel <= 1e-3,
              "prefill": all(r["ok"] for r in ranks),
              "shared": got["f"] == tp // cfg.n_kv_heads > 1 and all(
                  r["cache_heads"] == 1 and r["wk_cols"] == cfg.d_head
                  // got["f"] for r in ranks)}
    record.update(loss_rel=loss_rel, grad_norm_rel=norm_rel, checks=checks)
    with open(os.path.join(out_dir, "kv_share_check.json"), "w") as fh:
        json.dump(record, fh, indent=1)

    def comm(c):
        return ", ".join(f"{k} {c['calls'][k]} ({c['bytes'][k] / 1e6:.1f} MB)"
                         for k in sorted(c["calls"]))

    print(f"h2o-danube-3-4b kv sharing: (1, {tp}) mesh, {tp} ranks on one "
          f"{dev.type} device over gloo, d {cfg.d_model}, {cfg.n_heads} "
          f"heads, "
          f"{cfg.n_kv_heads} kv heads, d_head {cfg.d_head} (each head shared "
          f"by {got['f']} ranks, {cfg.d_head // got['f']} stored wk / wv "
          f"columns a rank), {cfg.n_layers} layers (reduced), f32 | {card}")
    print(f"  step 0 (B = {b} x {s}): loss {got['loss']:.6f} vs one card "
          f"{ref['loss']:.6f} (rel {loss_rel:.2e}), grad norm "
          f"{got['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
          f"{norm_rel:.2e}), {got['step_ms']:.1f} ms on rank 0 | "
          f"collectives on rank 0: {comm(got['step_comm'])}")
    print(f"  prefill S = {s_pre:,}: {got['prefill_ms']:.1f} ms on rank 0, "
          f"logits max |mesh - card| by rank "
          + ", ".join(f"{r['logit_err']:.3g}" for r in ranks)
          + ", cache (its head) "
          + ", ".join(f"{r['cache_err']:.3g}" for r in ranks)
          + f" (rtol / atol {TOL}) | collectives on rank 0: "
          f"{comm(got['prefill_comm'])}")
    print(f"  ranks: started work "
          + ", ".join(f"{r['start_s']:.1f}" for r in ranks)
          + f" s after the spawn; blocks drawn in "
          + ", ".join(f"{r['init_s']:.1f}" for r in ranks)
          + " s; peak GiB " + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
          + f" | spawn to finish {record['spawn_s']:.1f} s, one card "
          f"{ref['s']:.1f} s | {card}")
    failed = sorted(k for k, v in checks.items() if not v)
    print(json.dumps({"ok": not failed, "failed": failed,
                      "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                      "step_ms": got["step_ms"],
                      "prefill_ms": got["prefill_ms"],
                      "peak_gib": [r["peak_gib"] for r in ranks],
                      "start_s": [r["start_s"] for r in ranks],
                      "card": card}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
