"""Blue/green index deployment: versioned builds, checksummed manifests,
atomic promotion, rollback (port of `repro.serve.deploy`).

Layout under a deployment root::

    root/
      builds/<build_id>/index.npz      the saved BAMG index artifact
      builds/<build_id>/MANIFEST.json  IndexManifest (sha256 of the artifact)
      ACTIVE                           build_id of the live index (pointer)
      HISTORY                          one promoted build_id per line

The live index is named by a single small pointer file; promotion writes
the new pointer to a temp file and `os.replace`s it over ACTIVE, so a
reader sees either the old build or the new one -- never a torn pointer.
Rollback is just promotion of the previous HISTORY entry.

Lifecycle (`DeploymentManager.deploy`): build -> publish (write artifact +
manifest) -> verify (sha256 round-trip) -> validate (recall smoke against
a golden query set) -> promote.  A build that fails validation is left
published-but-inactive for inspection; ACTIVE keeps serving the old index.

`BlueGreenEngine` is the serving side: it holds a `BatchedANNEngine` for
the ACTIVE build and `refresh()` hot-swaps the engine when the pointer
moved (the swap is one attribute assignment -- queries before it see the
old index, queries after see the new one, no in-between).

The layout, the artifact (`BAMGIndex.save`'s npz, the reference's keys)
and the manifest's JSON are the reference's, so either package's manager
verifies, loads and promotes a build that the other published.  The
manager builds and loads on `device` (None: the CUDA device); the engines
it validates and serves run where their index's codebooks live.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from ..core.distances import recall_at_k
from ..core.engine import BAMGIndex, BAMGParams
from ..utils.faults import IntegrityError

from .ann_engine import BatchedANNEngine, EngineConfig

_ARTIFACT = "index.npz"
_MANIFEST = "MANIFEST.json"


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def _atomic_write(path: str, text: str) -> None:
    """Write-then-rename so readers never observe a partial file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class IndexManifest:
    """Immutable description of one published build."""
    build_id: str
    created: float            # unix seconds at publish time
    path: str                 # artifact path relative to the build dir
    sha256: str               # checksum of the artifact
    n: int                    # corpus size
    d: int                    # vector dimension
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "IndexManifest":
        return cls(**json.loads(text))


class DeploymentManager:
    """Publish / verify / promote / rollback over one deployment root;
    builds and loads on `device` (None: the CUDA device)."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.device = device
        self.builds_dir = os.path.join(root, "builds")
        self.active_path = os.path.join(root, "ACTIVE")
        self.history_path = os.path.join(root, "HISTORY")
        os.makedirs(self.builds_dir, exist_ok=True)

    # --- publish ------------------------------------------------------------
    def publish(self, index: BAMGIndex, build_id: str,
                meta: Optional[dict] = None) -> IndexManifest:
        """Write the index artifact + checksummed manifest for `build_id`.

        Publishing does NOT change what is served; only `promote` moves the
        ACTIVE pointer."""
        bdir = os.path.join(self.builds_dir, build_id)
        os.makedirs(bdir, exist_ok=True)
        apath = os.path.join(bdir, _ARTIFACT)
        index.save(apath)
        man = IndexManifest(
            build_id=build_id, created=time.time(), path=_ARTIFACT,
            sha256=_sha256(apath), n=len(index.x), d=index.x.shape[1],
            meta=dict(meta or {}))
        _atomic_write(os.path.join(bdir, _MANIFEST), man.to_json())
        return man

    def manifest(self, build_id: str) -> IndexManifest:
        with open(os.path.join(self.builds_dir, build_id, _MANIFEST)) as f:
            return IndexManifest.from_json(f.read())

    def builds(self) -> list[str]:
        """Published build ids, oldest first (by manifest creation time)."""
        out = []
        if os.path.isdir(self.builds_dir):
            for b in os.listdir(self.builds_dir):
                if os.path.exists(os.path.join(self.builds_dir, b, _MANIFEST)):
                    out.append(b)
        return sorted(out, key=lambda b: self.manifest(b).created)

    # --- verify / load ------------------------------------------------------
    def verify(self, build_id: str) -> IndexManifest:
        """Checksum the artifact against its manifest.

        Raises `IntegrityError` on mismatch (torn write, bit rot, tampering)
        so a corrupt build can never be promoted or loaded."""
        man = self.manifest(build_id)
        apath = os.path.join(self.builds_dir, build_id, man.path)
        got = _sha256(apath)
        if got != man.sha256:
            raise IntegrityError(
                f"build {build_id!r}: artifact sha256 {got[:12]}... != "
                f"manifest {man.sha256[:12]}...")
        return man

    def load(self, build_id: str) -> BAMGIndex:
        """Verify then load a published build."""
        man = self.verify(build_id)
        return BAMGIndex.load(
            os.path.join(self.builds_dir, build_id, man.path),
            device=self.device)

    # --- promote / rollback -------------------------------------------------
    def active(self) -> Optional[str]:
        if not os.path.exists(self.active_path):
            return None
        with open(self.active_path) as f:
            return f.read().strip() or None

    def history(self) -> list[str]:
        if not os.path.exists(self.history_path):
            return []
        with open(self.history_path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def promote(self, build_id: str) -> str:
        """Atomically point ACTIVE at a verified build; append to HISTORY."""
        self.verify(build_id)
        _atomic_write(self.active_path, build_id + "\n")
        with open(self.history_path, "a") as f:
            f.write(build_id + "\n")
        return build_id

    def rollback_target(self) -> Optional[str]:
        """The build `rollback()` would promote: the most recent HISTORY
        entry that is not the active build and is still published (a
        pruned entry cannot be re-promoted, so it is skipped)."""
        published = set(self.builds())
        cur = self.active()
        for b in reversed(self.history()):
            if b != cur and b in published:
                return b
        return None

    def rollback(self) -> str:
        """Re-promote the previous distinct *still-published* build."""
        target = self.rollback_target()
        if target is None:
            raise RuntimeError("rollback: no previous build in history")
        return self.promote(target)

    def prune(self, keep: int = 2) -> list[str]:
        """Drop the oldest published builds beyond `keep`.

        The ACTIVE build and the current rollback target are protected
        unconditionally -- even `keep=0` can never delete the build being
        served or strand `rollback()`.  Returns the removed build ids."""
        import shutil
        protected = {b for b in (self.active(), self.rollback_target())
                     if b is not None}
        victims = []
        candidates = [b for b in self.builds() if b not in protected]
        n_keep = max(0, keep - len(protected))
        excess = len(candidates) - n_keep
        for b in candidates[:max(0, excess)]:
            shutil.rmtree(os.path.join(self.builds_dir, b))
            victims.append(b)
        return victims

    # --- validate / full lifecycle ------------------------------------------
    def validate(self, build_id: str, queries: np.ndarray, gt: np.ndarray,
                 k: int = 10, min_recall: float = 0.8,
                 config: Optional[EngineConfig] = None) -> float:
        """Recall smoke test of a published build against a golden set.

        Returns the measured recall; raises ValueError below `min_recall`."""
        eng = BatchedANNEngine.from_index(self.load(build_id), config)
        ids, _ = eng.search_batch(queries, min(k, eng.rerank_capacity))
        rec = recall_at_k(ids, gt[:, :ids.shape[1]], ids.shape[1])
        if rec < min_recall:
            raise ValueError(
                f"build {build_id!r} failed validation: recall@{k} "
                f"{rec:.3f} < {min_recall:.3f} (left unpromoted)")
        return rec

    def deploy(self, x: np.ndarray, build_id: str, queries: np.ndarray,
               gt: np.ndarray, params: Optional[BAMGParams] = None,
               k: int = 10, min_recall: float = 0.8,
               config: Optional[EngineConfig] = None,
               meta: Optional[dict] = None) -> IndexManifest:
        """Full lifecycle: build -> publish -> verify -> validate -> promote.

        ACTIVE is untouched until the new build passes every gate, so a bad
        deploy degrades nothing."""
        idx = BAMGIndex.build(x, params or BAMGParams(), device=self.device)
        man = self.publish(idx, build_id, meta=meta)
        self.verify(build_id)
        rec = self.validate(build_id, queries, gt, k=k,
                            min_recall=min_recall, config=config)
        self.promote(build_id)
        return dataclasses.replace(
            man, meta={**man.meta, "validated_recall": rec})


class BlueGreenEngine:
    """Serves the ACTIVE build; `refresh()` hot-swaps on pointer moves.

    The swap is a single attribute assignment after the new engine is fully
    constructed, so `search_batch` always runs against a complete index --
    the blue index serves until the green one is ready, then the next call
    uses green."""

    def __init__(self, manager: DeploymentManager,
                 config: Optional[EngineConfig] = None,
                 keep_index: bool = False):
        self.manager = manager
        self.config = config if config is not None else EngineConfig()
        self.keep_index = keep_index   # retain the loaded BAMGIndex (the
        # streaming delta layer wires its in-memory graph off it)
        self.build_id: Optional[str] = None
        self._engine: Optional[BatchedANNEngine] = None
        self.index: Optional[BAMGIndex] = None
        self.refresh()

    def refresh(self) -> bool:
        """Follow the ACTIVE pointer; returns True when the engine swapped."""
        target = self.manager.active()
        if target is None or target == self.build_id:
            return False
        idx = self.manager.load(target)
        engine = BatchedANNEngine.from_index(idx, self.config)
        if self.keep_index:
            self.index = idx
        self._engine, self.build_id = engine, target   # atomic swap
        return True

    @property
    def engine(self) -> Optional[BatchedANNEngine]:
        """The live engine (None until a build is promoted)."""
        return self._engine

    def search_batch(self, queries: np.ndarray, k: int, exclude=None):
        if self._engine is None:
            raise RuntimeError("no ACTIVE build promoted yet")
        return self._engine.search_batch(queries, k, exclude=exclude)
