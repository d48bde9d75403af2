"""Static instruction stream for the scatter-gather serving pipeline (port
of `repro.serve.runtime.instructions`: host numpy, the reference's code).

The alpa pipeline runtime (SNIPPETS.md Snippet 1) compiles execution into
a per-worker list of RUN/SEND/RECV instructions walked by a dumb
interpreter; the win is that control flow -- who runs what, in which
order, what gets skipped -- becomes *data* fixed at compile time instead
of ad-hoc loop code.  The serving pipeline here is small enough for one
stream per fleet topology::

    SCATTER                      stage the query batch, snapshot the mask
    RUN(s) ; GATHER(s)   (x S)   shard-batch search ; local->global remap
    MERGE                        one global top-k over gathered candidates

`compile_program` emits the stream once per topology;
`InstructionInterpreter.execute` walks it against a per-batch execution
state.  Dead shards are *masked*: a RUN whose shard is administratively
down (or whose replica group is exhausted) marks its own and its GATHER's
slot inactive, so degraded mode is a mask over a static program, never a
different program and never control-flow-by-exception.  A replica that
raises during RUN is marked down and the RUN retries on the shard's next
healthy replica (round-robin) before the shard masks out.

Merge semantics are bit-identical to the pre-runtime `ShardedFrontend`
loop: per-shard candidates concatenate in ascending shard order, are
padded with -1/+inf when a shard contributes fewer than k, and merge via
`merge_topk`'s stable argsort (ties keep shard order).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np

from .placement import ShardPlacement


class Opcode(enum.IntEnum):
    SCATTER = 0
    RUN = 1
    GATHER = 2
    MERGE = 3


@dataclasses.dataclass(frozen=True)
class Instruction:
    """One step of the serving program; `shard` is the RUN/GATHER operand."""
    op: Opcode
    shard: int = -1

    @classmethod
    def scatter(cls) -> "Instruction":
        return cls(Opcode.SCATTER)

    @classmethod
    def run(cls, shard: int) -> "Instruction":
        return cls(Opcode.RUN, shard)

    @classmethod
    def gather(cls, shard: int) -> "Instruction":
        return cls(Opcode.GATHER, shard)

    @classmethod
    def merge(cls) -> "Instruction":
        return cls(Opcode.MERGE)

    def __repr__(self) -> str:
        arg = f"({self.shard})" if self.op in (Opcode.RUN, Opcode.GATHER) \
            else ""
        return f"{self.op.name}{arg}"


def compile_program(n_shards: int) -> tuple[Instruction, ...]:
    """The static serving program for an S-shard fleet."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    prog = [Instruction.scatter()]
    for s in range(n_shards):
        prog += [Instruction.run(s), Instruction.gather(s)]
    prog.append(Instruction.merge())
    return tuple(prog)


@dataclasses.dataclass
class ServeStatus:
    """Per-batch serving report returned by `with_status=True`."""
    degraded: np.ndarray                 # (B,) bool: answer missed >=1 shard
    shards_up: int
    shards_down: tuple                   # shard indices skipped this batch


@dataclasses.dataclass
class _ExecState:
    """Mutable per-batch state threaded through the instruction stream."""
    queries: np.ndarray
    k: int
    l: Optional[int]
    max_hops: Optional[int]
    exclude: Optional[Sequence] = None   # per-shard local tombstone masks
    b: int = 0
    mask: Optional[np.ndarray] = None
    results: dict = dataclasses.field(default_factory=dict)
    all_ids: list = dataclasses.field(default_factory=list)
    all_d: list = dataclasses.field(default_factory=list)
    down: list = dataclasses.field(default_factory=list)
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None


class InstructionInterpreter:
    """Executes a compiled serving program against the placement."""

    def __init__(self, placement: ShardPlacement,
                 luts: Sequence[np.ndarray]):
        self.placement = placement
        self.luts = list(luts)
        self._dispatch = {Opcode.SCATTER: self._scatter,
                          Opcode.RUN: self._run,
                          Opcode.GATHER: self._gather,
                          Opcode.MERGE: self._merge}

    def execute(self, program: Sequence[Instruction], queries: np.ndarray,
                k: int, *, l: Optional[int] = None,
                max_hops: Optional[int] = None,
                exclude: Optional[Sequence] = None):
        """Run one query batch through the program.

        `exclude` is an optional per-shard sequence of shard-local VID
        lists/masks (the delta-layer tombstone mask, already scattered to
        local id space by the runtime); each live RUN forwards its shard's
        entry to the engine.  Returns (ids (B, k) int64, dists (B, k),
        ServeStatus)."""
        st = _ExecState(queries=queries, k=k, l=l, max_hops=max_hops,
                        exclude=exclude)
        for ins in program:
            self._dispatch[ins.op](st, ins)
        status = ServeStatus(
            degraded=np.full(st.b, bool(st.down)),
            shards_up=self.placement.n_shards - len(st.down),
            shards_down=tuple(st.down))
        return st.ids, st.dists, status

    # --- opcodes ------------------------------------------------------------
    def _scatter(self, st: _ExecState, ins: Instruction) -> None:
        st.queries = np.atleast_2d(st.queries)
        st.b = len(st.queries)
        st.mask = self.placement.mask()

    def _run(self, st: _ExecState, ins: Instruction) -> None:
        s = ins.shard
        if not st.mask[s]:                       # masked: known-dead shard
            st.down.append(s)
            return
        while True:
            rep = self.placement.select(s)
            if rep is None:                      # replica group exhausted
                st.mask[s] = False
                st.down.append(s)
                return
            # a shard smaller than k contributes what it has, padded at
            # GATHER -- the merge still sees plenty from the other shards
            ks = min(st.k, rep.engine.effective_rerank(st.l))
            excl = st.exclude[s] if st.exclude is not None else None
            try:
                ids_s, d_s = rep.worker.run(rep, st.queries, ks,
                                            l=st.l, max_hops=st.max_hops,
                                            exclude=excl)
            except Exception as e:  # noqa: BLE001 -- replica down, try next
                self.placement.record_failure(rep, e)
                continue
            st.results[s] = (ids_s, d_s, ks)
            return

    def _gather(self, st: _ExecState, ins: Instruction) -> None:
        res = st.results.get(ins.shard)
        if res is None:                          # masked RUN: nothing to do
            return
        ids_s, d_s, ks = res
        if ks < st.k:
            ids_s = np.concatenate(
                [ids_s, np.full((st.b, st.k - ks), -1, ids_s.dtype)], axis=1)
            d_s = np.concatenate(
                [d_s, np.full((st.b, st.k - ks), np.inf, d_s.dtype)], axis=1)
        st.all_ids.append(self.luts[ins.shard][ids_s])  # -1 -> global -1
        st.all_d.append(d_s)

    def _merge(self, st: _ExecState, ins: Instruction) -> None:
        if st.all_ids:
            ids = np.concatenate(st.all_ids, axis=1)    # (B, S*k)
            d = np.concatenate(st.all_d, axis=1)
        else:                                           # every shard down
            ids = np.full((st.b, st.k), -1, np.int64)
            d = np.full((st.b, st.k), np.inf, np.float64)
        gd, gi = merge_topk(d, st.k)
        ids = pad_cols(ids, st.k, -1)                   # match merge pad
        gids = np.take_along_axis(ids, gi, axis=1)
        st.ids = np.where(np.isfinite(gd), gids, -1)
        st.dists = gd


def pad_cols(a: np.ndarray, k: int, fill) -> np.ndarray:
    """Pad (B, C) to at least k columns with `fill` (no-op when C >= k)."""
    if a.shape[1] >= k:
        return a
    pad = np.full((a.shape[0], k - a.shape[1]), fill, a.dtype)
    return np.concatenate([a, pad], axis=1)


def merge_topk(dists: np.ndarray, k: int):
    """Host-side (B, C) -> ascending (B, k); tiny, so plain numpy.

    C is normally S*k but can drop below k when shards are down or the
    fleet is small -- pad with +inf so argpartition's kth stays in range
    (the caller pads its id matrix the same way).
    """
    dists = pad_cols(dists, k, np.inf)
    part = np.argpartition(dists, k - 1, axis=1)[:, :k]
    pd = np.take_along_axis(dists, part, axis=1)
    o = np.argsort(pd, axis=1, kind="stable")
    return np.take_along_axis(pd, o, axis=1), np.take_along_axis(part, o, axis=1)
