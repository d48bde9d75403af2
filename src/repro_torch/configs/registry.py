"""Architecture registry of the port: `get_arch(id)` for every ported
architecture.  The reference's GNN architectures are not ported yet."""
from __future__ import annotations

from . import (din_cfg, gemma_7b, h2o_danube3_4b, moonshot_v1_16b_a3b,
               olmo_1b, qwen2_moe_a2_7b)

ARCHS = {m.ARCH_ID: m for m in (
    h2o_danube3_4b, gemma_7b, olmo_1b, qwen2_moe_a2_7b, moonshot_v1_16b_a3b,
    din_cfg)}
# the reference's GNN architectures (models/gnn/*)
UNPORTED = ("graphcast", "nequip", "mace", "dimenet")


def get_arch(arch_id: str):
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r}: the GNN models and their configs wait for "
            f"their slice (ROADMAP Queue 1 item 7.5)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch_id, shape_name) pair of the ported architectures."""
    return [(aid, sname) for aid, mod in ARCHS.items()
            for sname in mod.SHAPES]
