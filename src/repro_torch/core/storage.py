"""On-disk layouts (paper Fig. 3) over the block-device simulator (port
of `repro.core.storage`; numpy only, the same payloads block for block).

Two layouts, all byte-accounted against the 4 KB block size:

1. `CoupledStorage` -- the DiskANN / Starling layout: each node record holds
   [raw vector (d*4 B) | degree (4 B) | R neighbor ids (4 B each)], packed
   nodes-per-block = block_size // record_bytes (>=1; large records span
   ceil(record/block) blocks, each read costing that many I/Os).  The node
   order is a permutation: identity for DiskANN, BNF-shuffled for Starling.

2. `DecoupledStorage` -- the paper's BAMG layout: graph blocks hold only
   [OID | VID | degree | neighbor OIDs], so capacity c is much larger; raw
   vectors live in a *separate* region, packed per graph block in contiguous
   blocks ordered by slot, so a vector's location is computable from its OID
   (no in-memory map -- §4.2).

Payloads are numpy structs (not raw bytes) for speed; byte sizes are
computed exactly and validated against the block size.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.faults import FaultPlan, RetryPolicy
from .io_sim import (BLOCK_SIZE, READ_FAILED, BlockDevice, CachePolicy,
                     CostModel, IOScheduler)


# ---------------------------------------------------------------------------
# Coupled layout (DiskANN / Starling baselines)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CoupledRecord:
    vids: np.ndarray   # (npb,) int32, -1 pad
    vecs: np.ndarray   # (npb, d) float32
    nbrs: np.ndarray   # (npb, R) int32 neighbor VIDs, -1 pad


class CoupledStorage:
    """DiskANN/Starling node-record layout on the simulator."""

    def __init__(self, x: np.ndarray, adj: np.ndarray, order: np.ndarray | None = None,
                 block_size: int = BLOCK_SIZE, cache_blocks: int = 256,
                 policy: str | CachePolicy = "lru",
                 cost: CostModel | None = None,
                 faults: FaultPlan | None = None,
                 retry: RetryPolicy | None = None):
        n, d = x.shape
        r = adj.shape[1]
        self.n, self.d, self.r = n, d, r
        self.record_bytes = 4 * d + 4 + 4 * r
        self.blocks_per_record = max(1, -(-self.record_bytes // block_size))
        if self.record_bytes <= block_size:
            self.npb = block_size // self.record_bytes  # nodes per block
        else:
            self.npb = 1  # one (multi-block) record per logical slot
        order = np.arange(n, dtype=np.int64) if order is None else np.asarray(order, np.int64)
        assert len(order) == n
        self.layout = order                  # slot -> vid
        self.pos = np.empty(n, np.int64)     # vid -> slot
        self.pos[order] = np.arange(n)

        m = -(-n // self.npb)
        payloads: list[CoupledRecord] = []
        for b in range(m):
            sl = order[b * self.npb: (b + 1) * self.npb]
            vids = -np.ones(self.npb, np.int32)
            vids[: len(sl)] = sl
            vecs = np.zeros((self.npb, d), np.float32)
            vecs[: len(sl)] = x[sl]
            nb = -np.ones((self.npb, r), np.int32)
            nb[: len(sl)] = adj[sl]
            payloads.append(CoupledRecord(vids=vids, vecs=vecs, nbrs=nb))
        # multi-block records: the payload lives at the first block id of the
        # span; the extra span blocks are placeholders (None) that still cost
        # one read each via read_node.
        dev_blocks: list = []
        self._payload_block = np.empty(m, np.int64)
        for b, p in enumerate(payloads):
            self._payload_block[b] = len(dev_blocks)
            dev_blocks.append(p)
            for _ in range(self.blocks_per_record - 1):
                dev_blocks.append(None)
        self.device = BlockDevice(dev_blocks, block_size, cache_blocks,
                                  kind="graph", policy=policy, faults=faults)
        self.scheduler = IOScheduler(cost, retry)

    @property
    def n_blocks(self) -> int:
        return len(self.device)

    def block_of(self, vid: int) -> int:
        return int(self.pos[vid]) // self.npb

    def reset(self, drop_cache: bool = True) -> None:
        self.device.reset(drop_cache)
        self.scheduler.reset()

    def read_node_block(self, vid: int, prefetch=()) -> CoupledRecord:
        """Read the block(s) containing vid's record; returns the payload.

        Multi-block records go down as one batched submission (their span is
        known up front); `prefetch` adds speculative logical-block hints
        (timing only -- see io_sim.IOScheduler).  Under fault injection a
        record any of whose span blocks could not be delivered is
        `READ_FAILED` (the caller degrades, it does not crash).
        """
        b = self.block_of(vid)
        first = int(self._payload_block[b])
        span = list(range(first, first + self.blocks_per_record))
        pf: list[int] = []
        for lb in prefetch:
            f = int(self._payload_block[lb])
            pf.extend(range(f, f + self.blocks_per_record))
        payloads = self.scheduler.submit(self.device, span, prefetch=pf)
        if any(p is READ_FAILED for p in payloads):
            return READ_FAILED
        return payloads[0]

    def slot_in_block(self, vid: int) -> int:
        return int(self.pos[vid]) % self.npb


# ---------------------------------------------------------------------------
# Decoupled layout (BAMG, §4.2 / Fig. 3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GraphBlock:
    oids: np.ndarray   # (c,) int32, -1 pad
    vids: np.ndarray   # (c,) int32, -1 pad
    nbrs: np.ndarray   # (c, R) int32 neighbor OIDs, -1 pad


class DecoupledStorage:
    """Graph blocks (neighbor OIDs only) + separate contiguous vector region.

    OID = block_id * capacity + slot.  Vector region: per graph block, the
    vectors of its members are packed in slot order into contiguous blocks,
    *aligned* so no vector straddles a block boundary (vectors_per_block =
    floor(block / vec) when vec <= block; unused tail space left empty --
    the paper's "remaining space is left empty").  Vectors larger than one
    block get ceil(vec/block) dedicated aligned blocks.  Alignment costs a
    few % of space and halves rerank I/Os for near-block-sized vectors
    (measured: GIST-like d=960 went from ~1.55 to 1.0 reads/vector).
    """

    def __init__(self, x: np.ndarray, adj: np.ndarray, blocks: np.ndarray,
                 members: np.ndarray, block_size: int = BLOCK_SIZE,
                 cache_blocks: int = 256, vec_cache_blocks: int = 256,
                 policy: str | CachePolicy = "lru",
                 vec_policy: str | CachePolicy | None = None,
                 pinned_gblocks=(), cost: CostModel | None = None,
                 faults: FaultPlan | None = None,
                 retry: RetryPolicy | None = None):
        n, d = x.shape
        r = adj.shape[1]
        m, c = members.shape
        self.n, self.d, self.r = n, d, r
        self.m, self.capacity = m, c
        self.block_size = block_size
        # --- graph region ----------------------------------------------------
        self.record_bytes = 4 + 4 + 4 + 4 * r  # OID + VID + degree + R nbr OIDs
        need = c * self.record_bytes
        if need > block_size:
            raise ValueError(
                f"graph block overflow: c={c} * record={self.record_bytes}B "
                f"= {need}B > {block_size}B; lower capacity or max degree")
        self.vid2oid = -np.ones(n, np.int64)
        for b in range(m):
            row = members[b]
            for s, v in enumerate(row[row >= 0].tolist()):
                self.vid2oid[v] = b * c + s
        assert (self.vid2oid >= 0).all(), "every node must be assigned a slot"
        self.oid2vid = -np.ones(m * c, np.int64)
        self.oid2vid[self.vid2oid] = np.arange(n)

        payloads: list[GraphBlock] = []
        for b in range(m):
            row = members[b]
            mem = row[row >= 0]
            oids = -np.ones(c, np.int32)
            vids = -np.ones(c, np.int32)
            nb = -np.ones((c, r), np.int32)
            oids[: len(mem)] = (b * c + np.arange(len(mem))).astype(np.int32)
            vids[: len(mem)] = mem
            for s, v in enumerate(mem.tolist()):
                nn = adj[v]
                nn = nn[nn >= 0]
                nb[s, : len(nn)] = self.vid2oid[nn]
            payloads.append(GraphBlock(oids=oids, vids=vids, nbrs=nb))
        self.graph_dev = BlockDevice(payloads, block_size, cache_blocks,
                                     kind="graph", policy=policy,
                                     pinned=pinned_gblocks, faults=faults)
        self.scheduler = IOScheduler(cost, retry)

        # --- vector region ---------------------------------------------------
        self.vec_bytes = 4 * d
        if self.vec_bytes <= block_size:
            self.vecs_per_vblock = block_size // self.vec_bytes
            self.vblocks_per_vec = 1
            self.vblocks_per_gblock = -(-c // self.vecs_per_vblock)
        else:
            self.vecs_per_vblock = 1
            self.vblocks_per_vec = -(-self.vec_bytes // block_size)
            self.vblocks_per_gblock = c * self.vblocks_per_vec
        vec_payloads: list[np.ndarray] = []
        floats_per_block = block_size // 4
        for b in range(m):
            row = members[b]
            mem = row[row >= 0]
            region = np.zeros(self.vblocks_per_gblock * floats_per_block, np.float32)
            for s, v in enumerate(mem.tolist()):
                off = self._vec_offset_floats(s, floats_per_block)
                region[off: off + d] = x[v]
            for vb in range(self.vblocks_per_gblock):
                vec_payloads.append(region[vb * floats_per_block: (vb + 1) * floats_per_block])
        self.vector_dev = BlockDevice(
            vec_payloads, block_size, vec_cache_blocks, kind="vector",
            policy=vec_policy if vec_policy is not None else policy,
            faults=faults)

    def _vec_offset_floats(self, slot: int, floats_per_block: int) -> int:
        """Float offset of slot's vector inside its graph block's region."""
        if self.vblocks_per_vec == 1:
            vb, s_in = divmod(slot, self.vecs_per_vblock)
            return vb * floats_per_block + s_in * (self.vec_bytes // 4)
        return slot * self.vblocks_per_vec * floats_per_block

    # --- addressing ---------------------------------------------------------
    def gblock_of_oid(self, oid: int) -> int:
        return oid // self.capacity

    def read_graph_block(self, gblock: int, prefetch=()) -> GraphBlock:
        """Fetch one graph block; `prefetch` hints further graph blocks for
        the same batched submission (timing only, never accounting).  Under
        fault injection an undeliverable block is `READ_FAILED`."""
        return self.scheduler.submit(self.graph_dev, [gblock],
                                     prefetch=prefetch)[0]

    def _vec_block_span(self, oid: int) -> tuple[int, int]:
        """(first vector-device block, float offset within it) for an OID."""
        b, s = divmod(oid, self.capacity)
        floats_per_block = self.block_size // 4
        off = self._vec_offset_floats(s, floats_per_block)
        first = b * self.vblocks_per_gblock + off // floats_per_block
        return first, off % floats_per_block

    def read_vector(self, oid: int) -> np.ndarray | None:
        """Fetch a raw vector by OID -- location computed, no map (§4.2).
        None when the block could not be delivered (fault injection)."""
        return self.read_vectors([oid], batched=False)[0]

    def read_vectors(self, oids, batched: bool = True) -> list[np.ndarray]:
        """Fetch raw vectors for `oids` (in order).

        `batched=True` issues all the underlying vector-block reads as one
        scheduler submission (the re-rank phase knows its whole read set up
        front); `batched=False` submits them one by one.  Both produce the
        same reads in the same order, so NIO and cache state are identical
        -- only the modeled service time differs.

        Under fault injection a vector any of whose blocks could not be
        delivered comes back as None (the re-rank degrades per-candidate,
        the other vectors of the batch are unaffected).
        """
        spans = [self._vec_block_span(int(o)) for o in oids]
        nb = self.vblocks_per_vec
        if batched:
            demand: list[int] = []
            for first, _ in spans:
                demand.extend(range(first, first + nb))
            payloads = self.scheduler.submit(self.vector_dev, demand)
        else:
            payloads = []
            for first, _ in spans:
                for vb in range(first, first + nb):
                    payloads.append(self.scheduler.read(self.vector_dev, vb))
        out: list[np.ndarray | None] = []
        for i, (_, local) in enumerate(spans):
            chunks = payloads[i * nb: (i + 1) * nb]
            if any(c is READ_FAILED for c in chunks):
                out.append(None)
                continue
            flat = np.concatenate(chunks) if nb > 1 else chunks[0]
            out.append(flat[local: local + self.d])
        return out

    # --- stats ----------------------------------------------------------------
    @property
    def graph_bytes(self) -> int:
        return self.graph_dev.total_bytes

    @property
    def vector_bytes(self) -> int:
        return self.vector_dev.total_bytes

    def reset(self, drop_cache: bool = True) -> None:
        self.graph_dev.reset(drop_cache)
        self.vector_dev.reset(drop_cache)
        self.scheduler.reset()


def max_capacity_for(r: int, block_size: int = BLOCK_SIZE) -> int:
    """Largest c such that c * (12 + 4R) <= block_size (decoupled layout)."""
    return max(1, block_size // (12 + 4 * r))


def coupled_nodes_per_block(d: int, r: int, block_size: int = BLOCK_SIZE) -> int:
    rec = 4 * d + 4 + 4 * r
    return max(1, block_size // rec) if rec <= block_size else 1
