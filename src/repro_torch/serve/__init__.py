"""Serving layer of the port (from `repro.serve`).

- `ann_engine.BatchedANNEngine` -- the batched fixed-shape engine over one
  BAMG sub-index: `pq_adc` entry scoring, the fused beam-hop kernel (or
  the hop loop with `pq_adc_rowwise`), exact re-rank.
- `runtime.ServeRuntime` -- the scatter-gather fleet: shard replica groups
  placed onto `launch.mesh` workers, a static SCATTER/RUN/GATHER/MERGE
  program, and the deadline-aware continuous-batching `Scheduler`.
- `frontend.ShardedFrontend` -- the legacy scatter-gather API, a thin shim
  over the runtime.
- `deploy.DeploymentManager` / `deploy.BlueGreenEngine` -- checksummed
  builds behind an atomic ACTIVE pointer, validated before promotion, and
  the engine that hot-swaps to the ACTIVE build.
"""
from .ann_engine import (BatchedANNEngine, EngineConfig, batched_search,
                         resolve_backend)
from .deploy import BlueGreenEngine, DeploymentManager, IndexManifest
from .frontend import ServeStatus, ShardedFrontend, ShardHealth
from .runtime import (BeamTier, Completion, Request, RequestQueue,
                      Scheduler, SchedulerConfig, ServeRuntime,
                      build_shard_fleet, make_requests, open_loop_arrivals,
                      summarize)

__all__ = ["BatchedANNEngine", "BeamTier", "BlueGreenEngine", "Completion",
           "DeploymentManager", "EngineConfig", "IndexManifest", "Request",
           "RequestQueue", "Scheduler", "SchedulerConfig", "ServeRuntime",
           "ServeStatus", "ShardHealth", "ShardedFrontend", "batched_search",
           "build_shard_fleet", "make_requests", "open_loop_arrivals",
           "resolve_backend", "summarize"]
