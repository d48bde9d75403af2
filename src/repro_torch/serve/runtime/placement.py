"""Shard placement over a host device mesh (port of
`repro.serve.runtime.placement`).

The alpa device-mesh hierarchy (SNIPPETS.md Snippet 2), collapsed to what
scatter-gather ANN serving needs::

    ServeRuntime                 (the fleet)
    |
    ShardPlacement               (shard/replica -> worker binding)
    |
    MeshWorker                   (one executor pinned to one mesh device)

`ShardPlacement.plan` flattens the device grid of a `launch.mesh` host
mesh (or `make_host_mesh(device=device)`'s devices when no mesh is given:
`device=None` means every CUDA device) into one `MeshWorker` per device
and binds each shard's replica group onto workers round-robin.  Replica 0
of every shard is the caller's engine object *placed*
(`BatchedANNEngine.place`, an in-place `.to(device)`) on its worker --
object identity is preserved so fault hooks (`engine.inject_fault`) and
blue/green hot swaps keep working; replicas > 0 are copies
(`BatchedANNEngine.replicate`).

With more replicas than devices (on one card a single worker, `cuda:0`,
takes every replica) a replica's `.to(device)` copies nothing: replicas
on one device share their arrays (memory does not grow with
`n_replicas`) and keep separate fault state, as the reference's replicas
do on one device.

Health has two granularities.  `ShardHealth` is the shard-level record
(shared with the `ShardedFrontend` shim: same objects, same `health()`
shape); per-replica up/down lives on the `Replica` itself.  A replica that
raises is marked down and the shard's error counter bumped; the shard only
goes down -- i.e. its RUN/GATHER instructions get masked -- once no
healthy replica remains.  `select()` round-robins query batches over the
healthy replicas of a shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ...launch.mesh import make_host_mesh
from ..ann_engine import BatchedANNEngine


@dataclasses.dataclass
class ShardHealth:
    """Mutable per-shard serving state (one entry per replica group)."""
    up: bool = True
    errors: int = 0          # engine calls that raised
    last_error: str = ""


class MeshWorker:
    """One executor bound to a single device of the serving mesh."""

    def __init__(self, worker_id: int, device):
        self.worker_id = worker_id
        self.device = device
        self.replicas: list["Replica"] = []

    def bind(self, replica: "Replica") -> None:
        self.replicas.append(replica)

    def run(self, replica: "Replica", queries: np.ndarray, k: int, *,
            l: Optional[int] = None, max_hops: Optional[int] = None,
            exclude=None):
        """Execute one shard-batch on this worker's engine copy."""
        return replica.engine.search_batch(queries, k, l=l,
                                           max_hops=max_hops,
                                           exclude=exclude)

    def __repr__(self) -> str:
        bound = [(r.shard, r.replica) for r in self.replicas]
        return (f"MeshWorker(id={self.worker_id}, device={self.device}, "
                f"replicas={bound})")


@dataclasses.dataclass
class Replica:
    """One placed copy of a shard's engine, bound to a worker."""
    shard: int
    replica: int
    engine: BatchedANNEngine
    worker: MeshWorker
    up: bool = True
    last_error: str = ""


class ShardPlacement:
    """Binding of S shard replica groups onto mesh workers."""

    def __init__(self, workers: Sequence[MeshWorker],
                 shard_replicas: Sequence[Sequence[Replica]],
                 shard_health: Sequence[ShardHealth]):
        self.workers = list(workers)
        self.shard_replicas = [list(g) for g in shard_replicas]
        self.shard_health = list(shard_health)
        self._rr = [0] * len(self.shard_replicas)

    @classmethod
    def plan(cls, engines: Sequence[BatchedANNEngine], mesh=None,
             n_replicas: int = 1, device=None) -> "ShardPlacement":
        """Carve the mesh into workers and bind replica groups round-robin.
        Without a mesh the workers are `make_host_mesh(device=device)`'s
        devices (None: every CUDA device; raises without one)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} must be >= 1")
        if not engines:
            raise ValueError("placement needs at least one shard engine")
        if mesh is None:
            mesh = make_host_mesh(device=device)
        devices = list(mesh.devices.flat)
        n_workers = max(1, min(len(devices), len(engines) * n_replicas))
        workers = [MeshWorker(i, d) for i, d in enumerate(devices[:n_workers])]
        groups, health = [], []
        for s, eng in enumerate(engines):
            group = []
            for r in range(n_replicas):
                w = workers[(s * n_replicas + r) % n_workers]
                e = eng.place(w.device) if r == 0 else eng.replicate(w.device)
                rep = Replica(shard=s, replica=r, engine=e, worker=w)
                w.bind(rep)
                group.append(rep)
            groups.append(group)
            health.append(ShardHealth())
        return cls(workers, groups, health)

    @property
    def n_shards(self) -> int:
        return len(self.shard_replicas)

    @property
    def engines(self) -> list[BatchedANNEngine]:
        """Replica-0 engines, shard order (the caller's own objects)."""
        return [g[0].engine for g in self.shard_replicas]

    # --- replica selection --------------------------------------------------
    def select(self, shard: int) -> Optional[Replica]:
        """Next healthy replica of `shard`, round-robin; None if none left."""
        group = self.shard_replicas[shard]
        n = len(group)
        for i in range(n):
            rep = group[(self._rr[shard] + i) % n]
            if rep.up:
                self._rr[shard] = (self._rr[shard] + i + 1) % n
                return rep
        return None

    def record_failure(self, rep: Replica, exc: Exception) -> None:
        """A replica raised: mark it down; the shard masks out only when
        its whole replica group is dead."""
        rep.up, rep.last_error = False, repr(exc)
        h = self.shard_health[rep.shard]
        h.errors, h.last_error = h.errors + 1, repr(exc)
        if not any(r.up for r in self.shard_replicas[rep.shard]):
            h.up = False

    # --- shard-level administration (the frontend's semantics) -------------
    def mark_down(self, shard: int, reason: str = "marked down") -> None:
        h = self.shard_health[shard]
        h.up, h.last_error = False, reason

    def mark_up(self, shard: int) -> None:
        """Revive a shard after repair: the whole replica group comes back."""
        self.shard_health[shard].up = True
        for rep in self.shard_replicas[shard]:
            rep.up = True

    def mask(self) -> np.ndarray:
        """(S,) bool: which shards' RUN/GATHER instructions are live."""
        return np.array([h.up for h in self.shard_health], bool)
