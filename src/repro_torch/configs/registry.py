"""Architecture registry of the port: `get_arch(id)` for every
architecture of the reference, the reference's ten ids."""
from __future__ import annotations

from . import (din_cfg, dimenet_cfg, gemma_7b, graphcast_cfg,
               h2o_danube3_4b, mace_cfg, moonshot_v1_16b_a3b, nequip_cfg,
               olmo_1b, qwen2_moe_a2_7b)

ARCHS = {m.ARCH_ID: m for m in (
    h2o_danube3_4b, gemma_7b, olmo_1b, qwen2_moe_a2_7b, moonshot_v1_16b_a3b,
    graphcast_cfg, nequip_cfg, mace_cfg, dimenet_cfg, din_cfg)}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch_id, shape_name) pair -- the reference's 40 cells."""
    return [(aid, sname) for aid, mod in ARCHS.items()
            for sname in mod.SHAPES]
