"""Multi-pod dry run (port of `repro.launch.dryrun`).

For every (architecture x input shape x mesh) cell: rank 0's step
(`launch.cells`) on meta tensors, in this one process, over a fake
process group of 256 (the (16, 16) mesh) or 512 ranks (the (2, 16, 16)
mesh) -- `torch.testing`'s `FakeStore` group, whose collectives move
nothing.  Nothing is allocated and nothing is computed: the step's ops
run for their shapes, counted by `roofline.op_count.OpCounter`, its
collectives by `utils.sharding.comm_log`.  Each cell's record goes into
a resumable JSON keyed "arch|shape|mesh": the memory of rank 0 (its
argument blocks, its peak live bytes), the counts, and the roofline with
H100 data-sheet constants (`roofline.analysis`).  Every number is rank
0's and none is measured on a card; building the cell and its arguments
and running the step are the reference's lowering and compiling.  A
cell that fails is recorded with its error, and the sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out out.json --force
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out out.json --table
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..roofline.analysis import HBM_BYTES, roofline_from_counts
from ..roofline.op_count import OpCounter
from ..utils import sharding
from ..utils.tree import leaves

HBM_PER_CARD = HBM_BYTES  # H100 SXM, 80 GiB (data sheet)
NOTE = ("rank 0's numbers, from its step on meta tensors over a fake "
        "process group; the roofline's constants are the H100 SXM data "
        "sheet's, not measured on a card")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of `world` ranks in which this process is
    rank 0 (every collective returns at once and moves nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _storages(tree) -> dict:
    """{id: bytes} of the storages that hold `tree`'s tensors (a DTensor's
    local block)."""
    out = {}
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str) -> dict:
    """One cell's record on `mesh` (a DeviceMesh of the current process
    group, this process its rank 0)."""
    from .cells import build_cell

    n_dev = sharding.mesh_size(mesh)
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                 "n_devices": n_dev, "note": NOTE}
    t0 = time.time()
    cell = build_cell(arch_id, shape_name, mesh)
    rec["kind"] = cell.kind
    rec["comment"] = cell.comment
    rec["model_flops"] = cell.model_flops
    args = cell.rank_args(mesh)
    rec["t_build_s"] = round(time.time() - t0, 1)
    held = _storages(args)
    counter = OpCounter()
    counter.track(args)
    sharding.comm_log.reset()
    t0 = time.time()
    with counter:
        out = cell.fn(*args)
    rec["t_run_s"] = round(time.time() - t0, 1)
    comm = sharding.comm_log.snapshot()
    counts = counter.summary()
    new_out = {k: v for k, v in _storages(out).items() if k not in held}
    arg_b, out_b = sum(held.values()), sum(new_out.values())
    total = max(counts["peak_bytes"], arg_b + out_b)
    rec["mem"] = {"argument_bytes": arg_b,
                  "temp_bytes": total - arg_b - out_b,
                  "output_bytes": out_b,
                  "generated_code_bytes": 0,     # eager: no compiled code
                  "total_bytes": total,
                  "fits_hbm": bool(total <= HBM_PER_CARD)}
    rec["cost_analysis"] = {"flops": counts["flops"],
                            "bytes accessed": counts["traffic_bytes"]}
    rec["comm"] = comm
    t0 = time.time()
    rl = roofline_from_counts(counts, comm["out_bytes"], cell.model_flops,
                              n_dev)
    rec["roofline"] = rl.summary()
    rec["t_analyze_s"] = round(time.time() - t0, 1)
    del out, args, cell
    gc.collect()
    return rec


def table(results: dict) -> str:
    """The records as one markdown table, a row a cell, both meshes side
    by side: rank 0's GiB, whether it fits 80 GiB, the bottleneck,
    t_bound (ms) and useful_ratio, or the failure."""
    def part(rec):
        if rec is None:
            return ["-"] * 5
        if rec.get("status") != "ok":
            return ["fail: " + rec["error"][:60].replace("|", "/")] + [""] * 4
        rl = rec["roofline"]
        return [f"{rec['mem']['total_bytes'] / 2 ** 30:.2f}",
                "yes" if rec["mem"]["fits_hbm"] else "no", rl["bottleneck"],
                f"{rl['t_bound_s'] * 1e3:.4g}", f"{rl['useful_ratio']:.3g}"]

    cells = dict.fromkeys(tuple(k.split("|")[:2]) for k in results)
    head = ["arch", "shape"] + [f"{m}: {c}" for m in ("single", "multi")
                                for c in ("GiB", "fits", "bottleneck",
                                          "t_bound ms", "useful")]
    rows = ["| " + " | ".join(head) + " |",
            "|" + "---|" * len(head)]
    for a, sh in cells:
        rows.append("| " + " | ".join(
            [a, sh] + part(results.get(f"{a}|{sh}|single"))
            + part(results.get(f"{a}|{sh}|multi"))) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print --out's records as a markdown table, run "
                         "nothing")
    args = ap.parse_args(argv)
    if args.table:
        with open(args.out) as f:
            print(table(json.load(f)))
        return

    from ..configs.registry import all_cells
    from .mesh import make_production_mesh

    cells = [(a, s) for (a, s) in all_cells()
             if (args.arch == "all" or a == args.arch)
             and (args.shape == "all" or s == args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results: dict = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for multi in meshes:
        name = "multi" if multi else "single"
        with fake_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            for arch_id, shape_name in cells:
                key = f"{arch_id}|{shape_name}|{name}"
                if key in results and results[key].get("status") == "ok" \
                        and not args.force:
                    continue
                t0 = time.time()
                try:
                    rec = run_cell(arch_id, shape_name, mesh, name)
                    rec["status"] = "ok"
                    mem_g = rec["mem"]["total_bytes"] / 2 ** 30
                    fits = "fits" if rec["mem"]["fits_hbm"] else "OVER"
                    rl = rec["roofline"]
                    print(f"OK   {key:58s} {time.time()-t0:6.1f}s "
                          f"mem={mem_g:6.2f}GiB({fits}) "
                          f"bneck={rl['bottleneck']:10s} "
                          f"t={rl['t_bound_s']*1e3:8.2f}ms "
                          f"useful={rl['useful_ratio']:.2f}", flush=True)
                except Exception as e:  # noqa: BLE001 -- report, continue
                    rec = {"status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"FAIL {key:58s} {time.time()-t0:6.1f}s "
                          f"{rec['error'][:140]}", flush=True)
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    ok = sum(1 for r in results.values() if r.get("status") == "ok")
    print(f"\n{ok} ok / {len(results)} recorded -> {args.out}")


if __name__ == "__main__":
    main()
