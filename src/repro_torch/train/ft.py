"""Fault tolerance: checkpoint/restart orchestration + failure injection
(port of `repro.train.ft`).

  node loss / preemption     atomic checkpoints every `ckpt_every` steps
                             (train/checkpoint.py); restart resumes from
                             the latest step; the stateless step-indexed
                             data pipeline replays the exact stream.
  mid-save crash             tmp-file + os.replace: the previous
                             checkpoint stays valid.
  stragglers                 bounded per-step host work; the async
                             checkpointer keeps serialization off the
                             step path; the loop keeps a step-time EWMA.

`run_with_recovery` drives a training loop with optional injected
failures (the tests prove restart equivalence with it: a run killed at
step k and resumed matches the uninterrupted run).

Failure injection shares `utils.faults` with the storage simulator:
`SimulatedFailure` is the training face of that taxonomy, and a seeded
`FaultPlan` (``FaultSpec(step_fail_rate=...)``) draws step crashes the
same deterministic way the I/O layer draws read errors.  A step that
failed on attempt 0 is drawn again under the restart's attempt number,
so a retried run makes progress as a retried block read does.

  changed topology           elastic restore: `resume_or_init(...,
  (lose a pod, resize DP)    shardings=...)` lays the checkpoint's full
                             arrays out on the new mesh
                             (`checkpoint.restore_sharded`); ZeRO-1
                             moment blocks re-partition with it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

from ..utils.faults import (FaultPlan, InjectedFault,  # noqa: F401
                            SimulatedFailure)
from . import checkpoint as ckpt


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True


def run_loop(state, step_fn: Callable, batch_fn: Callable, n_steps: int,
             ft: FTConfig, fail_at: Optional[int] = None,
             fault_plan: Optional[FaultPlan] = None, fault_attempt: int = 0,
             log_every: int = 0) -> tuple[Any, list]:
    """Run from state["step"] to n_steps, checkpointing; optionally raise a
    SimulatedFailure after completing step `fail_at` (before its save), or
    wherever the seeded `fault_plan` draws a step failure
    (`FaultSpec.step_fail_rate`; `fault_attempt` is the restart count, so
    transient failures clear on retry).  Returns (state, [(step, metrics
    as floats)] every `log_every` steps)."""
    saver = ckpt.AsyncCheckpointer(ft.ckpt_dir, keep=ft.keep)
    metrics_log = []
    start = int(state["step"])
    ewma = None
    try:
        for s in range(start, n_steps):
            t0 = time.perf_counter()
            batch = batch_fn(s)
            state, m = step_fn(state, batch)
            if log_every and (s + 1) % log_every == 0:
                m = {k: float(v) for k, v in m.items()}
                metrics_log.append((s + 1, m))
            dt = time.perf_counter() - t0
            # straggler probe
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if fail_at is not None and s + 1 == fail_at:
                raise SimulatedFailure(f"injected failure after step {s + 1}")
            if (fault_plan is not None
                    and fault_plan.fail_step(s + 1, fault_attempt)):
                raise SimulatedFailure(f"planned failure after step {s + 1} "
                                       f"(attempt {fault_attempt})")
            if (s + 1) % ft.ckpt_every == 0 or s + 1 == n_steps:
                if ft.async_save:
                    saver.save(s + 1, state)
                else:
                    ckpt.save(ft.ckpt_dir, s + 1, state)
    finally:
        # a simulated crash leaves the directory as a finished write would
        saver.wait()
    return state, metrics_log


def resume_or_init(init_fn: Callable[[], Any], ft: FTConfig,
                   shardings=None) -> Any:
    """Restore the latest checkpoint if present (onto the fresh state's
    devices and dtypes; with `shardings`, a tree of
    `utils.sharding.NamedSharding` like the state, laid out on their
    mesh), else the fresh init."""
    step = ckpt.latest_step(ft.ckpt_dir)
    state = init_fn()
    if step is None:
        return state
    if shardings is not None:
        state, _ = ckpt.restore_sharded(ft.ckpt_dir, state, shardings)
    else:
        state, _ = ckpt.restore(ft.ckpt_dir, state)
    return state


def run_with_recovery(init_fn, step_fn, batch_fn, n_steps, ft: FTConfig,
                      fail_at: Optional[int] = None,
                      fault_plan: Optional[FaultPlan] = None,
                      max_restarts: int = 3):
    """Training with automatic restart-from-checkpoint on failure.  Returns
    (state, metrics log, restarts).

    The restart count is fed back into the fault plan as the attempt
    number, so a plan's transient step failures are drawn again on retry
    (persistent bad luck still exhausts `max_restarts` and re-raises)."""
    attempts = 0
    logs = []
    while True:
        state = resume_or_init(init_fn, ft)
        try:
            state, mlog = run_loop(state, step_fn, batch_fn, n_steps, ft,
                                   fail_at=fail_at, fault_plan=fault_plan,
                                   fault_attempt=attempts)
            logs.extend(mlog)
            return state, logs, attempts
        except InjectedFault:
            attempts += 1
            fail_at = None  # fail only once per run_with_recovery call
            if attempts > max_restarts:
                raise
