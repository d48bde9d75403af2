"""Shared shape-cell definitions (the assigned input shapes per family):
a copy of `repro.configs.base`, which is pure data.

Every (arch x shape) pair is one cell of the reference's dry run; the
port reads the recsys shapes (`serve_p99`, `serve_bulk`,
`retrieval_cand`) for DIN serving.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                     # train | prefill | decode | serve | retrieval
    # --- LM ---
    seq_len: int = 0
    global_batch: int = 0
    accum: int = 1                # grad-accumulation microbatches (train)
    kv_mode: str = "auto"         # decode cache sharding: head | seq | seq_all
    # --- GNN ---
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_graphs: int = 0         # molecule cell
    batch_nodes: int = 0          # minibatch cell (seed nodes)
    fanout: tuple = ()
    # --- recsys ---
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256,
                          accum=2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288,
                           global_batch=1, kv_mode="seq_all"),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train", n_nodes=2708,
                               n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train", n_nodes=232965,
                              n_edges=114615892, batch_nodes=1024,
                              fanout=(15, 10), d_feat=602),
    "ogb_products": ShapeSpec("ogb_products", "train", n_nodes=2449029,
                              n_edges=61859140, d_feat=100),
    "molecule": ShapeSpec("molecule", "train", n_nodes=30, n_edges=64,
                          batch_graphs=128),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", batch=1,
                                n_candidates=1_000_000),
}


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
