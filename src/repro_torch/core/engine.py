"""Index interchange for the port: a `BAMGIndex.save` npz read with numpy
alone, and the PQ subspace-count rule (from `repro.core.engine`).

The BAMG build itself (NSG, BNF blocks, the Alg. 2 refine, the nav graph)
is not ported yet; until it is, the port serves indexes that the
reference package built and saved.
"""
from __future__ import annotations

import numpy as np


def _pick_pq_m(d: int, target: int | None = None) -> int:
    """Largest M <= target dividing d (PQ subspace count).  The default
    target scales with dimension (~d/16, clamped to [16, 64])."""
    if target is None:
        target = min(64, max(16, d // 16))
    for m in range(min(target, d), 0, -1):
        if d % m == 0:
            return m
    return 1


def load_batch_arrays(path: str, n_entry_cands: int = 256) -> dict:
    """Read a `BAMGIndex.save` npz into exactly the dict that
    `BAMGIndex.batch_arrays(n_entry_cands)` returns: x (N, D) f32, adj
    (N, R) int32 with -1 pad, codes (N, M) uint8, codebooks (M, K, dsub)
    f32, and entry_cands (E,) int64 -- the finest nav layer's vids when
    the index has a nav graph, else every vid, cut to `n_entry_cands` by
    even striding."""
    with np.load(path) as z:
        n_nav = int(z["n_nav"])
        if n_nav > 0:
            cands = np.asarray(z[f"nav{n_nav - 1}_vids"], np.int64)
        else:
            cands = np.arange(len(z["x"]), dtype=np.int64)
        if len(cands) > n_entry_cands:
            cands = cands[np.linspace(0, len(cands) - 1, n_entry_cands,
                                      dtype=np.int64)]
        return {
            "x": np.asarray(z["x"], np.float32),
            "adj": np.asarray(z["adj"], np.int32),
            "codes": np.asarray(z["codes"], np.uint8),
            "codebooks": np.asarray(z["codebooks"], np.float32),
            "entry_cands": cands,
        }
