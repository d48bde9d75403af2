"""Continuous-batching request scheduler (open-loop arrivals, deadline SLOs;
port of `repro.serve.runtime.scheduler`, host Python as the reference).

Continuous batching scaled down to scatter-gather ANN serving: requests
arrive on an *open-loop* timeline (the arrival process never waits for the
server -- the honest way to measure tail latency under offered load, per
the experimental-evaluation literature in PAPERS.md), queue in an
earliest-deadline-first heap, and drain into fixed-shape micro-batches:

- **Formation** pops the `max_batch` earliest deadlines.  A later deadline
  is never served while an earlier one waits (no deadline inversion;
  asserted in tests/test_runtime.py).
- **Padding** tiles every micro-batch up to exactly `max_batch` rows, so
  each beam tier compiles one (B, D) signature for the lifetime of the
  server (the fixed-shape contract of `BatchedANNEngine`).
- **Adaptive beam width** re-triages each popped request by its remaining
  slack: a request whose slack has fallen under `shrink_slack * slo`
  executes on the shrunk `BeamTier` (smaller pool `l` / `max_hops` =
  less work per query), trading recall for latency only when the SLO is
  actually at risk.  Within a formation round the shrunk tier runs first
  (those are the urgent requests).  Shrunk results are flagged
  `degraded` on their `Completion`.

Service time is real wall clock -- the engines actually run -- while only
the arrival timeline is simulated, so a single-process load sweep reports
achieved p50/p99 against offered QPS without a multi-host harness.  The
engines return host arrays, which waits for the card, so each
micro-batch's `perf_counter` window covers its device work.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One query on the open-loop timeline."""
    rid: int
    query: np.ndarray          # (D,)
    arrival: float             # seconds
    deadline: float            # arrival + SLO


@dataclasses.dataclass(frozen=True)
class BeamTier:
    """Per-call beam overrides (None = the engine's configured value)."""
    l: Optional[int] = None
    max_hops: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    k: int = 10
    max_batch: int = 32        # fixed micro-batch shape (rows are padded)
    slo: float = 0.5           # seconds; deadline = arrival + slo
    shrink_slack: float = 0.5  # slack < shrink_slack*slo -> shrunk tier
    # (full, shrunk) beam tiers; tier l is clamped to >= k at execution
    tiers: tuple = (BeamTier(), BeamTier(l=16, max_hops=8))


@dataclasses.dataclass
class Completion:
    """Served request: answer + timing + how it was served."""
    rid: int
    ids: np.ndarray            # (k,) global ids, -1 pad
    dists: np.ndarray          # (k,) ascending
    arrival: float
    finish: float
    latency: float
    tier: int                  # BeamTier index it executed on
    deadline_met: bool
    degraded: bool             # shrunk beam and/or missed >=1 shard


class RequestQueue:
    """Earliest-deadline-first queue; equal deadlines dequeue FIFO.

    The tie-break is a push-time arrival sequence number, NOT the rid:
    rids are caller-assigned and need not be monotone with arrival order,
    so breaking ties on them would reorder same-deadline requests between
    replays of the same seeded timeline.  The sequence counter makes EDF
    stable by arrival, bit-reproducible run to run."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0              # arrival order of pushes (FIFO tie-break)

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (req.deadline, self._seq, req))
        self._seq += 1

    def pop_batch(self, n: int) -> list[Request]:
        """The n earliest-deadline requests (fewer when the queue drains)."""
        return [heapq.heappop(self._heap)[2]
                for _ in range(min(n, len(self._heap)))]

    def min_deadline(self) -> float:
        return self._heap[0][0] if self._heap else float("inf")

    def __len__(self) -> int:
        return len(self._heap)


def open_loop_arrivals(n: int, qps: float, seed: int = 0,
                       process: str = "poisson") -> np.ndarray:
    """(n,) arrival times at offered `qps` (seeded Poisson or uniform)."""
    if qps <= 0:
        raise ValueError(f"qps={qps} must be > 0")
    if process == "poisson":
        gaps = np.random.default_rng(seed).exponential(1.0 / qps, n)
    elif process == "uniform":
        gaps = np.full(n, 1.0 / qps)
    else:
        raise ValueError(f"unknown arrival process {process!r}")
    return np.cumsum(gaps)


def make_requests(queries: np.ndarray, qps: float, slo: float,
                  n: Optional[int] = None, seed: int = 0,
                  process: str = "poisson") -> list[Request]:
    """Tile `queries` into an n-request open-loop timeline at `qps`."""
    queries = np.atleast_2d(queries)
    n = len(queries) if n is None else n
    arrivals = open_loop_arrivals(n, qps, seed=seed, process=process)
    return [Request(rid=i, query=queries[i % len(queries)],
                    arrival=float(a), deadline=float(a) + slo)
            for i, a in enumerate(arrivals)]


class Scheduler:
    """Drains a RequestQueue into the runtime as deadline-aware batches."""

    def __init__(self, runtime, config: Optional[SchedulerConfig] = None):
        self.runtime = runtime
        self.config = config if config is not None else SchedulerConfig()
        self.queue = RequestQueue()

    # --- triage / formation -------------------------------------------------
    def assign_tier(self, req: Request, now: float) -> int:
        """0 (full beam) unless remaining slack puts the SLO at risk."""
        cfg = self.config
        if len(cfg.tiers) == 1:
            return 0
        slack = req.deadline - now
        return 0 if slack >= cfg.shrink_slack * cfg.slo else len(cfg.tiers) - 1

    def form_microbatches(self, now: float) -> list[tuple[int, list[Request]]]:
        """EDF-pop up to max_batch and group by tier, urgent tiers first.

        Every popped deadline precedes every deadline left in the queue --
        formation never inverts deadlines."""
        popped = self.queue.pop_batch(self.config.max_batch)
        groups: dict[int, list[Request]] = {}
        for r in popped:
            groups.setdefault(self.assign_tier(r, now), []).append(r)
        return [(t, groups[t]) for t in sorted(groups, reverse=True)]

    # --- execution ----------------------------------------------------------
    def _tier_args(self, tier_idx: int) -> dict:
        tier = self.config.tiers[tier_idx]
        l = None if tier.l is None else max(self.config.k, tier.l)
        return {"l": l, "max_hops": tier.max_hops}

    def _execute(self, tier_idx: int, reqs: Sequence[Request]):
        """One fixed-shape runtime call; returns the unpadded rows."""
        cfg = self.config
        q = np.stack([r.query for r in reqs])
        b = len(reqs)
        if b < cfg.max_batch:                    # pad to the compiled shape
            q = np.concatenate([q, np.tile(q[:1], (cfg.max_batch - b, 1))])
        t0 = time.perf_counter()
        ids, dists, status = self.runtime.serve_batch(
            q, cfg.k, with_status=True, **self._tier_args(tier_idx))
        dt = time.perf_counter() - t0
        return ids[:b], dists[:b], status, dt

    def warmup(self, d: int) -> None:
        """Compile every tier's (max_batch, d) signature off the clock."""
        q = np.zeros((self.config.max_batch, d), np.float32)
        for t in range(len(self.config.tiers)):
            self.runtime.serve_batch(q, self.config.k, **self._tier_args(t))

    def run(self, requests: Sequence[Request],
            warmup: bool = True) -> list[Completion]:
        """Serve an open-loop timeline; returns Completions sorted by rid.

        The clock `t` advances by *measured* wall-clock service time of
        each micro-batch; arrivals are admitted whenever `t` passes them,
        so queueing delay under overload shows up in the latencies."""
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        if not reqs:
            return []
        if warmup:
            self.warmup(len(np.atleast_1d(reqs[0].query)))
        out: list[Completion] = []
        t, i, n = 0.0, 0, len(reqs)
        while i < n or len(self.queue):
            if not len(self.queue):              # idle: jump to next arrival
                t = max(t, reqs[i].arrival)
            while i < n and reqs[i].arrival <= t + 1e-12:
                self.queue.push(reqs[i])
                i += 1
            for tier_idx, batch in self.form_microbatches(t):
                ids, dists, status, dt = self._execute(tier_idx, batch)
                t += dt
                for j, r in enumerate(batch):
                    out.append(Completion(
                        rid=r.rid, ids=ids[j], dists=dists[j],
                        arrival=r.arrival, finish=t, latency=t - r.arrival,
                        tier=tier_idx, deadline_met=t <= r.deadline,
                        degraded=bool(status.degraded[j]) or tier_idx > 0))
        out.sort(key=lambda c: c.rid)
        return out


def summarize(completions: Sequence[Completion]) -> dict:
    """Load-sweep row: latency percentiles + service-mix fractions."""
    lat = np.array([c.latency for c in completions])
    span = (max(c.finish for c in completions)
            - min(c.arrival for c in completions))
    p50, p99 = np.percentile(lat, [50, 99])
    return {"n": len(completions),
            "p50_ms": float(p50 * 1e3), "p99_ms": float(p99 * 1e3),
            "achieved_qps": len(completions) / max(span, 1e-12),
            "deadline_hit": float(np.mean([c.deadline_met
                                           for c in completions])),
            "degraded_frac": float(np.mean([c.degraded
                                            for c in completions])),
            "shrunk_frac": float(np.mean([c.tier > 0
                                          for c in completions]))}
