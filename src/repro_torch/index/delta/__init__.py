"""FreshDiskANN-style delta layer over a frozen BAMG index (port of
`repro.index.delta`).

The write path, in four pieces:

- `layer.DeltaLayer` -- the in-memory overlay: new points are wired into
  copy-on-write adjacency rows by incremental RobustPrune
  (`build.prune.robust_prune_inc`), deletes become tombstones that
  stay *navigable* but can never surface in a result.
- `engine.FreshBAMGEngine` -- unified base+delta queries: beam search
  over the frozen BAMG index (host Alg-4 or the batched serve engine)
  and over the delta graph, merged through the existing pool machinery
  with tombstones masked on every path.
- `consolidate.consolidate` -- background fold of the delta into a fresh
  BAMG build: edge repair around deleted nodes via neighbor-of-neighbor
  RobustPrune, then BNF block re-assignment + block-aware Alg-2 refine
  so block topology realigns with the merged graph.
- `service.FreshService` -- the read-write facade: stable external ids,
  insert/delete/search while consolidated builds publish through
  `serve.deploy` (publish -> verify -> validate -> promote) and
  `BlueGreenEngine.refresh()` hot-swaps with zero read downtime.
"""
from .consolidate import consolidate
from .engine import FreshBAMGEngine
from .layer import DeltaLayer, DeltaParams
from .service import FreshService

__all__ = [
    "DeltaLayer",
    "DeltaParams",
    "FreshBAMGEngine",
    "FreshService",
    "consolidate",
]
