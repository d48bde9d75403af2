"""The system under test for the batch-search cells: one BAMG index served
by `repro_torch.serve.BatchedANNEngine`.

The index belongs to the configuration, as a published data set's would:
the first run in a checkout builds it with `BAMGIndex.build` from the
benchmark's corpus and saves it (`BAMGIndex.save`) under the cache
directory; later runs load it with `core.engine.load_batch_arrays`.  The
file's name carries a digest of the configuration and of the code that
makes the corpus and the index, so a changed configuration builds anew.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path

import torch

from bench import data

_SOURCES = (Path(data.__file__), Path(__file__))


def _digest(cfg: dict) -> str:
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for p in _SOURCES:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


class System:
    """`search(queries, k, **kw)` -> (ids, dists) numpy, as the engine
    gives them; `call_shape(kw)` the sizes that the byte count of such a
    call reads."""

    def __init__(self, cfg: dict, device, cache_dir: Path, log):
        from repro_torch.core.engine import (BAMGIndex, BAMGParams,
                                             load_batch_arrays)
        from repro_torch.serve.ann_engine import BatchedANNEngine, EngineConfig

        path = Path(cache_dir) / f"{cfg['name']}-{_digest(cfg)}.npz"
        self.built_s = None
        if not path.exists():
            t = time.perf_counter()
            x = data.corpus(cfg, device).cpu().numpy()
            idx = BAMGIndex.build(x, BAMGParams(**cfg["index"]),
                                  device=device)
            del x
            self.built_s = time.perf_counter() - t
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".part.npz")
            idx.save(str(tmp))
            os.replace(tmp, path)
            log(f"built the index in {self.built_s:.1f} s, saved in "
                f"{time.perf_counter() - t - self.built_s:.1f} s: {path}")
            del idx
        config = EngineConfig(**cfg["engine"])
        arrays = load_batch_arrays(str(path), config.n_entry_cands)
        self.engine = BatchedANNEngine(arrays, config, device=device)
        self.config = dataclasses.asdict(config)

    def call_shape(self, kw: dict) -> dict:
        e = self.engine
        return {"n": e.n, "dim": e.d, "pq_m": e.codebooks.shape[0],
                "pq_k": e.codebooks.shape[1], "r": e.adj.shape[1],
                "entry_cands": e.entry_cands.shape[0],
                "max_hops": kw.get("max_hops") or self.config["max_hops"],
                "rerank": e.effective_rerank(kw.get("l"))}

    def search(self, queries: torch.Tensor, k: int, **kw):
        return self.engine.search_batch(queries, k, **kw)

    def corpus_equals(self, x: torch.Tensor) -> bool:
        """Whether the served vectors are the benchmark's corpus bit for
        bit (a guard on the cached index)."""
        return bool(torch.equal(self.engine.x, x.to(self.engine.x.device)))

    def close(self) -> None:
        self.engine = None
