#!/usr/bin/env python3
"""The dry run of phase 14's OLMo-1B training on its (2, 2) mesh: rank
0's peak live bytes from `repro_torch.launch.dryrun.run_cell` (meta
tensors over a fake group of 4), to hold against what the card measured
(`chip_smoke.py` phase 14's "peak GiB by rank").

Phase 14's configuration: OLMo-1B at full width with MESH_LAYERS of its
16 layers, FSDP over "data" x TP over "model", B = MESH_B x MESH_S, one
micro-batch (`make_train_step`'s default).  The train_4k cell is built
with those sizes and run once, as the dry run runs every cell.

    PYTHONPATH=src python3 tools/dryrun_mesh14.py    # no card needed
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> int:
    import chip_smoke as cs
    from repro_torch.configs import olmo_1b
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh

    full = olmo_1b.model_config
    olmo_1b.model_config = lambda reduced=False: dataclasses.replace(
        full(), n_layers=cs.MESH_LAYERS)
    olmo_1b.TRAIN_ACCUM = 1
    olmo_1b.SHAPES = dict(olmo_1b.SHAPES, train_4k=dataclasses.replace(
        olmo_1b.SHAPES["train_4k"], global_batch=cs.MESH_B,
        seq_len=cs.MESH_S, accum=1))
    with dryrun.fake_group(4):
        mesh = device_mesh((2, 2), ("data", "model"), "cpu")
        rec = dryrun.run_cell("olmo-1b", "train_4k", mesh, "(2, 2)")
    mem = rec["mem"]
    print(json.dumps({"layers": cs.MESH_LAYERS, "batch": [cs.MESH_B,
                                                          cs.MESH_S],
                      "mem": mem, "calls": rec["comm"]["calls"]}))
    print(f"dry run, phase 14's OLMo-1B ({cs.MESH_LAYERS} layers, (2, 2), "
          f"B = {cs.MESH_B} x {cs.MESH_S}, f32 masters, "
          f"{olmo_1b.model_config().dtype} compute): rank 0's peak "
          f"{mem['total_bytes'] / 2 ** 30:.3f} GiB (arguments "
          f"{mem['argument_bytes'] / 2 ** 30:.3f}, temporaries "
          f"{mem['temp_bytes'] / 2 ** 30:.3f}); meta tensors, not measured")
    return 0


if __name__ == "__main__":
    sys.exit(main())
