"""Distributed mesh serving runtime (alpa-style, scaled to ANN serving;
port of `repro.serve.runtime`).

Three layers, each its own module:

- `placement` -- `ShardPlacement` binds shard replica groups onto
  `MeshWorker`s (one per device of a `launch.mesh` host mesh),
  moving engine arrays to each worker's device; round-robin replica
  selection with the shard-level `ShardHealth` folded in.
- `instructions` -- the static SCATTER / RUN / GATHER / MERGE program
  compiled once per fleet topology and executed by
  `InstructionInterpreter`; dead shards are instruction *masks*, not
  try/except control flow.
- `scheduler` -- `RequestQueue`/`Scheduler`: open-loop arrivals with
  deadlines, EDF micro-batch formation padded to the engines' fixed
  shapes, and per-query adaptive beam width (shrink `l`/`max_hops` for
  near-deadline queries) to hold a p99 SLO.

`runtime.ServeRuntime` is the facade tying them together; the legacy
`serve.ShardedFrontend` is a thin compatibility shim over it.
"""
from .instructions import (Instruction, InstructionInterpreter,  # noqa: F401
                           Opcode, ServeStatus, compile_program,
                           merge_topk, pad_cols)
from .placement import (MeshWorker, Replica, ShardHealth,  # noqa: F401
                        ShardPlacement)
from .runtime import ServeRuntime, build_shard_fleet  # noqa: F401
from .scheduler import (BeamTier, Completion, Request,  # noqa: F401
                        RequestQueue, Scheduler, SchedulerConfig,
                        make_requests, open_loop_arrivals, summarize)
