"""Time a train-state checkpoint's parts on the card, at OLMo-1B's full
train state (f32 parameters and AdamW's m and v: 15.36 GB), against
`np.savez` / `np.load` on the same arrays.

Parts, each over the whole state: the host copy that
`train.checkpoint.AsyncCheckpointer.save` makes on the caller's thread
(pageable memory); the same copy into pinned buffers (their allocation
and the copy apart); CRC-32 of every array on one thread; a raw write of
the same bytes; the port's write (`train.checkpoint._write_npz`) and
`np.savez`, in turns (port, numpy, numpy, port); `np.load` of every
array, then the port's read (`train.checkpoint._read_npz`) of the same
file.  Files go to `build/checkpoint_bench/` and are removed.

    python3 tools/checkpoint_bench.py [--layers N]

Needs a CUDA device; prints the card's name and power limit.
"""
import argparse
import os
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="OLMo-1B layers (default: all 16)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import olmo_1b
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import init_train_state
    from repro_torch.utils.tree import flatten_with_path, leaves

    if not torch.cuda.is_available():
        print("checkpoint_bench: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = olmo_1b.model_config()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(init_lm_params(cfg, gen, device=dev),
                             AdamWConfig())
    for x in leaves(state["opt"]["m"]):
        x.normal_(generator=gen)
    torch.cuda.synchronize()
    gb = sum(x.numel() * x.element_size() for x in leaves(state)) / 1e9
    flat = flatten_with_path(state)
    out = ROOT / "build" / "checkpoint_bench"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    def timed(label, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{label}: {dt:.2f} s, {gb / dt:.2f} GB/s | {card}",
              flush=True)
        return res

    print(f"state: {cfg.name} {cfg.n_layers} layers, {len(flat)} leaves, "
          f"{gb:.2f} GB", flush=True)
    host = timed("host copy, pageable (AsyncCheckpointer.save's)",
                 lambda: {k: ckpt._host(v) for k, v in flat})
    pinned = timed("pinned buffers, allocation", lambda: {
        k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        for k, v in flat})
    timed("host copy into pinned buffers",
          lambda: [pinned[k].copy_(v) for k, v in flat])
    del pinned
    timed("CRC-32 of every array, one thread",
          lambda: [zlib.crc32(a) for a in host.values()])

    def write_raw():
        with open(out / "raw.bin", "wb") as f:
            for a in host.values():
                f.write(memoryview(a.reshape(-1)).cast("B"))
    timed("raw write of the same bytes", write_raw)
    os.remove(out / "raw.bin")

    def write(name, fn):
        def run():
            with open(out / name, "wb") as f:
                fn(f)
        return run

    ours = write("ours.npz", lambda f: ckpt._write_npz(f, host))
    numpy = write("numpy.npz", lambda f: np.savez(f, **host))
    for label, fn in (("the port's write", ours), ("np.savez", numpy),
                      ("np.savez", numpy), ("the port's write", ours)):
        timed(label, fn)
    os.remove(out / "ours.npz")
    timed("np.load, every array", lambda: dict(np.load(out / "numpy.npz")))
    got = timed("the port's .npz read",
                lambda: ckpt._read_npz(str(out / "numpy.npz"), list(host)))
    if not all(np.array_equal(got[k], a) for k, a in host.items()):
        raise AssertionError("the port's read differs from np.savez's input")
    shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
