"""Index interchange for the port (from `repro.core.engine`): the serving
arrays of a built BAMG (`batch_arrays`, the body of
`BAMGIndex.batch_arrays`), a `BAMGIndex.save` npz read with numpy alone,
and the PQ subspace-count rule.

The BAMG build itself is `build.GraphBuilder` (NSG, BNF blocks, the
Alg. 2 refine), `core.pq.train_pq` and `core.navgraph.build_navgraph`.
The index classes with their disk layouts and save/load (`BAMGIndex`,
`DiskANNIndex`, `StarlingIndex`) wait for the port of the host index
stack.
"""
from __future__ import annotations

import numpy as np

from .._device import to_numpy


def _pick_pq_m(d: int, target: int | None = None) -> int:
    """Largest M <= target dividing d (PQ subspace count).  The default
    target scales with dimension (~d/16, clamped to [16, 64])."""
    if target is None:
        target = min(64, max(16, d // 16))
    for m in range(min(target, d), 0, -1):
        if d % m == 0:
            return m
    return 1


def entry_candidates(nav_vids, n: int, n_entry_cands: int = 256) -> np.ndarray:
    """The engine's entry-candidate pool: the finest nav layer's vids when
    the index has a nav graph (`nav_vids`, else None: every vid of the n),
    cut to `n_entry_cands` by even striding so candidates stay spread
    across the corpus.  (E,) int64."""
    if nav_vids is not None:
        cands = np.asarray(nav_vids, np.int64)
    else:
        cands = np.arange(n, dtype=np.int64)
    if len(cands) > n_entry_cands:
        cands = cands[np.linspace(0, len(cands) - 1, n_entry_cands,
                                  dtype=np.int64)]
    return cands


def batch_arrays(x, graph, codes, codebooks, nav=None,
                 n_entry_cands: int = 256) -> dict:
    """Fixed-shape numpy arrays for `serve.BatchedANNEngine`, from a built
    BAMG (`core.bamg.BAMGGraph`), its PQ codes and codebooks (arrays or
    tensors) and its nav graph (`core.navgraph.NavGraph` or None): exactly
    the dict of `BAMGIndex.batch_arrays(n_entry_cands)` -- x (N, D) f32,
    adj (N, R) int32 with -1 pad, codes (N, M) uint8, codebooks
    (M, K, dsub) f32, entry_cands (E,) int64."""
    nav_vids = nav.layers[-1].vids if nav is not None and nav.layers else None
    return {
        "x": to_numpy(x, np.float32),
        "adj": np.asarray(graph.adj, np.int32),
        "codes": to_numpy(codes, np.uint8),
        "codebooks": to_numpy(codebooks, np.float32),
        "entry_cands": entry_candidates(nav_vids, len(x), n_entry_cands),
    }


def load_batch_arrays(path: str, n_entry_cands: int = 256) -> dict:
    """Read a `BAMGIndex.save` npz into exactly the dict that
    `BAMGIndex.batch_arrays(n_entry_cands)` returns (see `batch_arrays`)."""
    with np.load(path) as z:
        n_nav = int(z["n_nav"])
        nav_vids = z[f"nav{n_nav - 1}_vids"] if n_nav > 0 else None
        return {
            "x": np.asarray(z["x"], np.float32),
            "adj": np.asarray(z["adj"], np.int32),
            "codes": np.asarray(z["codes"], np.uint8),
            "codebooks": np.asarray(z["codebooks"], np.float32),
            "entry_cands": entry_candidates(nav_vids, len(z["x"]),
                                            n_entry_cands),
        }
