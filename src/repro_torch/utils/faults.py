"""Shared failure taxonomy (port of `repro.utils.faults`, numpy and the
standard library only): seeded deterministic fault injection for the
storage stack (block read errors, latency spikes, torn payloads, dead
blocks) and the training loop (step failures).

One `FaultPlan` drives every injected failure in the system, so a run is
reproducible end to end from a single seed.  Determinism is *access-order
independent*: every decision is a pure function of
``(seed, stream, kind, block, attempt)`` hashed through blake2b, so the
same plan produces the same fault schedule whether reads are issued
serially, batched, or interleaved across devices -- the property the
`tests/test_faults.py` suite pins (`tests/test_torch_io_sim.py` holds
this copy's draws equal to the reference's).

Failure classes (mirroring what a real disk path sees):

* **transient read error** -- an attempt fails outright; an independent
  draw per attempt, so a bounded retry usually recovers (rate
  ``read_error_rate``).
* **persistent dead block** -- a per-block draw (rate ``dead_rate``);
  every attempt fails, retries cannot help, the reader must degrade.
* **torn/corrupted payload** -- the transfer "succeeds" but the payload is
  perturbed (rate ``corrupt_rate``); the per-block checksum catches it and
  the read is retried.  `corrupt_payload` really flips bytes so the
  checksum mechanism is load-bearing, not a flag.
* **latency spike** -- the attempt takes ``read_us + spike`` (rate
  ``spike_rate``, exponential magnitude scaled by ``spike_us``); hedged
  reads and timeouts in `core.io_sim` bound the tail.
* **training step failure** -- `fail_step` (rate ``step_fail_rate``) is the
  same taxonomy applied to a training loop: a transient failure per
  (step, attempt), recovered by checkpoint restart.

Exception hierarchy: `InjectedFault` is the base for every simulated
failure; `SimulatedFailure` (training) subclasses it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import zlib
from typing import Optional

import numpy as np


class InjectedFault(Exception):
    """Base class of every simulated failure in the system."""


class SimulatedFailure(InjectedFault):
    """Injected training-step failure."""


class IntegrityError(InjectedFault):
    """A checksum/manifest verification failed (corrupted artifact)."""


# ---------------------------------------------------------------------------
# Deterministic uniform draws
# ---------------------------------------------------------------------------
def _u01(seed: int, *key) -> float:
    """Uniform [0, 1) as a pure function of (seed, key) -- blake2b-based,
    independent of PYTHONHASHSEED and of access order."""
    h = hashlib.blake2b(repr((int(seed),) + key).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Rates and magnitudes of every injected failure mode (all default 0:
    a zero spec is a valid no-op plan, used to prove the resilient read
    path is bit-identical to the plain one when nothing fires)."""

    read_error_rate: float = 0.0   # transient per-attempt read failure
    dead_rate: float = 0.0         # persistent per-block failure
    corrupt_rate: float = 0.0      # per-attempt torn payload (checksummed)
    spike_rate: float = 0.0        # per-attempt latency spike probability
    spike_us: float = 2000.0       # spike magnitude scale (exponential)
    step_fail_rate: float = 0.0    # training-loop per-step failure

    @property
    def any_io(self) -> bool:
        return (self.read_error_rate > 0 or self.dead_rate > 0
                or self.corrupt_rate > 0 or self.spike_rate > 0)


@dataclasses.dataclass(frozen=True)
class FaultOutcome:
    """Resolution of one read attempt."""

    error: bool = False        # attempt failed outright
    persistent: bool = False   # the block is dead: retries cannot help
    corrupt: bool = False      # payload delivered torn (checksum will fail)
    spike_us: float = 0.0      # extra latency on top of the base read time


class FaultPlan:
    """Seeded, deterministic fault schedule over block reads and training
    steps.  Stateless: every query is a pure hash of its coordinates."""

    def __init__(self, spec: FaultSpec = FaultSpec(), seed: int = 0):
        self.spec = spec
        self.seed = int(seed)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, spec={self.spec})"

    # --- storage faults -----------------------------------------------------
    def dead(self, kind: str, block: int) -> bool:
        """Persistent per-block failure (same answer for every attempt)."""
        if self.spec.dead_rate <= 0:
            return False
        return _u01(self.seed, "dead", kind, int(block)) < self.spec.dead_rate

    def outcome(self, kind: str, block: int, attempt: int) -> FaultOutcome:
        """Resolve one read attempt of `block` on the `kind` device."""
        s = self.spec
        b, a = int(block), int(attempt)
        if self.dead(kind, b):
            return FaultOutcome(error=True, persistent=True)
        if s.read_error_rate > 0 and \
                _u01(self.seed, "err", kind, b, a) < s.read_error_rate:
            return FaultOutcome(error=True)
        corrupt = (s.corrupt_rate > 0
                   and _u01(self.seed, "tear", kind, b, a) < s.corrupt_rate)
        spike = 0.0
        if s.spike_rate > 0 and \
                _u01(self.seed, "spike", kind, b, a) < s.spike_rate:
            # exponential magnitude, deterministic from the same hash family
            u = _u01(self.seed, "spikemag", kind, b, a)
            spike = s.spike_us * -math.log(max(1e-12, 1.0 - u))
        return FaultOutcome(corrupt=corrupt, spike_us=spike)

    def jitter(self, kind: str, block: int, attempt: int) -> float:
        """Uniform [0, 1) backoff jitter draw for a retry."""
        return _u01(self.seed, "jit", kind, int(block), int(attempt))

    def corruption_salt(self, kind: str, block: int, attempt: int) -> int:
        """Which byte perturbation a torn transfer applies (deterministic)."""
        return int(_u01(self.seed, "salt", kind, int(block), int(attempt))
                   * 2 ** 31)

    # --- training faults ----------------------------------------------------
    def fail_step(self, step: int, attempt: int = 0) -> bool:
        """Should training step `step` fail on restart-attempt `attempt`?
        Independent draws per attempt, so checkpoint-restart recovery
        converges (the block-read transient-retry semantics, applied to
        steps)."""
        if self.spec.step_fail_rate <= 0:
            return False
        return _u01(self.seed, "step", int(step),
                    int(attempt)) < self.spec.step_fail_rate


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter for failed reads.

    An initial attempt plus up to `budget` retries; retry r waits
    ``backoff_us * backoff_mult**r * (1 + jitter * u)`` with u drawn
    deterministically from the fault plan.  budget=0 disables retries
    (first failure is final)."""

    budget: int = 3
    backoff_us: float = 50.0
    backoff_mult: float = 2.0
    jitter: float = 0.5

    def backoff(self, retry_index: int, u: float) -> float:
        return (self.backoff_us * self.backoff_mult ** retry_index
                * (1.0 + self.jitter * u))


# ---------------------------------------------------------------------------
# Payload checksums + deterministic corruption
# ---------------------------------------------------------------------------
def payload_checksum(payload) -> int:
    """CRC32 of a block payload: ndarray, dataclass-of-ndarrays (the storage
    layer's CoupledRecord / GraphBlock), bytes, or None (span placeholder)."""
    if payload is None:
        return 0
    if isinstance(payload, np.ndarray):
        return zlib.crc32(np.ascontiguousarray(payload).tobytes())
    if dataclasses.is_dataclass(payload):
        c = 0
        for f in dataclasses.fields(payload):
            v = np.ascontiguousarray(getattr(payload, f.name))
            c = zlib.crc32(v.tobytes(), c)
        return c
    if isinstance(payload, (bytes, bytearray)):
        return zlib.crc32(bytes(payload))
    return zlib.crc32(repr(payload).encode())


def corrupt_payload(payload, salt: int = 0):
    """A torn copy of `payload`: one element of (the first array of) the
    payload gets its bits flipped, position chosen by `salt`.  The original
    is never mutated.  None (span placeholders) has no bytes to tear and is
    returned as-is."""
    if payload is None:
        return None
    if isinstance(payload, np.ndarray):
        return _corrupt_array(payload, salt)
    if dataclasses.is_dataclass(payload):
        kw = {f.name: getattr(payload, f.name)
              for f in dataclasses.fields(payload)}
        first = dataclasses.fields(payload)[0].name
        kw[first] = _corrupt_array(np.asarray(kw[first]), salt)
        return type(payload)(**kw)
    if isinstance(payload, (bytes, bytearray)):
        b = bytearray(payload)
        if b:
            b[salt % len(b)] ^= 0xFF
        return bytes(b)
    return payload


def _corrupt_array(a: np.ndarray, salt: int) -> np.ndarray:
    out = np.array(a, copy=True)
    flat = out.reshape(-1).view(np.uint8)
    if flat.size:
        flat[salt % flat.size] ^= 0xFF
    return out
