#!/usr/bin/env python3
"""Which collectives gloo takes on CUDA tensors, for ranks that share one
card (NCCL refuses two ranks on one device).

Spawns 4 ranks on card 0 with `repro_torch.launch.mesh.run_ranks` (a
(2, 2) ("data", "model") mesh over gloo) and, in each, tries on CUDA
tensors the collectives that the sequence-sharded decode and the
expert-parallel MoE need: `all_to_all_single` (even and uneven splits),
the list `all_to_all`, and an `all_reduce` with `ReduceOp.MAX`; then the
port's own `utils.sharding.all_to_all` and `all_reduce(op="max")`; then
one step of the ring the GNN ring ops take (the reference's
collective-permute: everything to the next rank of 4, from the previous
one) in two forms, `batch_isend_irecv` and an `all_to_all_single` with
one nonzero split, and the port's `utils.sharding.ring_shift` (the
second form).  The point-to-point form runs in a spawn of its own, last:
gloo's send of a CUDA tensor can abort the rank's process (a C++
exception, not a Python one), and the probe reports that too.  Each
outcome is printed with the values it gave against the expected ones:
the probe reports what the backend does, it does not stop at the first
refusal.

    PYTHONPATH=src python3 tools/gloo_probe.py     # on a machine with a card
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _try(name, fn, want, out):
    import torch

    t0 = time.perf_counter()
    try:
        got = fn()
        if got.is_cuda:
            torch.cuda.synchronize()
        ok = torch.equal(got.cpu(), want.cpu())
        out[name] = {"ran": True, "equal": bool(ok),
                     "device": str(got.device),
                     "ms": (time.perf_counter() - t0) * 1e3}
    except Exception as e:      # the probe's finding, reported as it is
        out[name] = {"ran": False, "error": f"{type(e).__name__}: "
                                            f"{str(e).splitlines()[0][:200]}"}


def probe(mesh, p2p: bool = False) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.utils import sharding

    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    r, w = dist.get_rank(), dist.get_world_size()
    out = {"backend": dist.get_backend(), "torch": torch.__version__}
    # rank r sends block j = [r * 10 + j] * 3 to rank j
    send = torch.tensor([[r * 10 + j] * 3 for j in range(w)],
                        dtype=torch.float32, device=dev)
    want = torch.tensor([[j * 10 + r] * 3 for j in range(w)],
                        dtype=torch.float32)

    def a2a_single():
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return recv

    def a2a_uneven():
        # rank r sends j + 1 rows to rank j, receives r + 1 from each
        rows = [torch.full((j + 1, 3), float(r * 10 + j), device=dev)
                for j in range(w)]
        recv = torch.empty((w * (r + 1), 3), device=dev)
        dist.all_to_all_single(recv, torch.cat(rows), [r + 1] * w,
                               [j + 1 for j in range(w)])
        return recv

    want_uneven = torch.cat([torch.full((r + 1, 3), float(j * 10 + r))
                             for j in range(w)])

    def a2a_list():
        outs = [torch.empty(3, device=dev) for _ in range(w)]
        dist.all_to_all(outs, list(send.unbind(0)))
        return torch.stack(outs)

    def max_reduce():
        x = torch.tensor([float(r), -float(r)], device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x

    def port_a2a():
        return sharding.all_to_all(send[:2], mesh, "model")

    me = mesh.get_local_rank("model")
    base = r - me
    want_port = torch.tensor([[(base + j) * 10 + me] * 3 for j in range(2)],
                             dtype=torch.float32)

    def port_max():
        return sharding.all_reduce(torch.tensor([float(r)], device=dev),
                                   mesh, ("data", "model"), op="max")

    nxt, prv = (r + 1) % w, (r - 1) % w
    block = torch.full((5, 3), float(r), device=dev)
    want_ring = torch.full((5, 3), float(prv))

    def ring_p2p():
        recv = torch.empty_like(block)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, block, nxt),
                dist.P2POp(dist.irecv, recv, prv)]):
            req.wait()
        return recv

    def ring_a2a():
        recv = torch.empty_like(block)
        send_rows = [5 if j == nxt else 0 for j in range(w)]
        recv_rows = [5 if j == prv else 0 for j in range(w)]
        dist.all_to_all_single(recv, block, recv_rows, send_rows)
        return recv

    def port_ring():
        return sharding.ring_shift(block, mesh, ("data", "model"))

    if p2p:
        _try("ring_batch_isend_irecv", ring_p2p, want_ring, out)
        gathered = [None] * w
        dist.all_gather_object(gathered, out)
        return gathered
    _try("all_to_all_single", a2a_single, want, out)
    _try("all_to_all_single_uneven", a2a_uneven, want_uneven, out)
    _try("all_to_all_list", a2a_list, want, out)
    _try("all_reduce_max", max_reduce,
         torch.tensor([float(w - 1), 0.0]), out)
    _try("sharding.all_to_all", port_a2a, want_port, out)
    _try("sharding.all_reduce_max", port_max, torch.tensor([float(w - 1)]),
         out)
    _try("ring_all_to_all_single", ring_a2a, want_ring, out)
    _try("sharding.ring_shift", port_ring, want_ring, out)
    out["comm"] = sharding.comm_log.snapshot()
    gathered = [None] * w
    dist.all_gather_object(gathered, out)
    return gathered


def main(argv=None) -> int:
    import argparse

    import torch

    from repro_torch.launch.mesh import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the probe) or cpu (a check of the script)")
    device = ap.parse_args(argv).device
    if device == "cuda" and not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    for p2p in (False, True):
        try:
            with tempfile.TemporaryDirectory() as rdv:
                res = run_ranks(probe, (2, 2), device=device,
                                init_method=f"file://{rdv}/init", timeout=180,
                                threads=1, args=(p2p,))
        except RuntimeError as e:   # a rank's process died: the finding
            print(f"ring_batch_isend_irecv: aborted the ranks on {device} "
                  f"tensors over gloo ({str(e).splitlines()[0]}; the ranks' "
                  f"stderr has gloo's message) | torch {torch.__version__} "
                  f"| {card}")
            continue
        for rank, r in enumerate(res):
            print(f"rank {rank}: " + json.dumps(r))
        names = [k for k in res[0] if isinstance(res[0][k], dict)
                 and "ran" in res[0][k]]
        for k in names:
            ran = all(r[k]["ran"] for r in res)
            eq = ran and all(r[k]["equal"] for r in res)
            print(f"{k}: {'ran' if ran else 'refused'} on {device} tensors "
                  f"over {res[0]['backend']}, values "
                  f"{'equal' if eq else 'NOT equal' if ran else '-'}"
                  + ("" if ran else f" ({res[0][k].get('error')})")
                  + f" | torch {res[0]['torch']} | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
