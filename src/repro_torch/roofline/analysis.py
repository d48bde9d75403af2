"""Three-term roofline of a dry-run cell on an H100 (port of
`repro.roofline.analysis`, whose constants are the TPU v5e's).

  compute term    = FLOPs_per_rank / peak_FLOPs
  memory term     = traffic_bytes_per_rank / HBM_bw
  collective term = weighted collective bytes / link bw

The per-rank numbers come from `roofline/op_count.py` (FLOPs of the
products, pre-fusion output bytes) and `utils.sharding.comm_log` (each
collective's result bytes on the rank, the reference's HLO count) over
one step of rank 0's program.

Constants: the H100 SXM's data sheet, not measured.  The collective
term assumes one 400 Gb/s NDR InfiniBand link a card: the production
meshes span 32 or 64 eight-card nodes, and the model charges every
collective byte to that link; NVLink inside a node is not modelled.

Collective weighting (ring algorithms, P = participating ranks):
  all-reduce      2 (P-1)/P   ~ 2x payload over the slowest link
  all-gather      (P-1)/P     (payload = gathered output)
  reduce-scatter  (P-1)/P
  all-to-all      (P-1)/P     (each rank keeps 1/P of its payload)
  collective-permute 1
We report the simple x2 / x1 weights (P large) -- the error is O(1/P).
The port's kinds (`comm_log`: all_reduce, all_reduce_max, all_gather,
reduce_scatter, all_to_all, broadcast, reduce, collective-permute) map
onto these names (`HLO_KIND`); a broadcast and a reduce weigh 1.
"""
from __future__ import annotations

import collections
import dataclasses

# H100 SXM per card (data sheet)
PEAK_FLOPS = 989e12          # dense bf16
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR InfiniBand link
HBM_BYTES = 80 * 2 ** 30     # 80 GiB HBM3

COLL_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

HLO_KIND = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
            "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_to_all": "all-to-all", "broadcast": "broadcast",
            "reduce": "reduce", "collective-permute": "collective-permute"}


@dataclasses.dataclass
class Roofline:
    flops: float                  # per rank
    traffic_bytes: float          # per rank
    collective_bytes: float       # weighted, per rank
    collectives: dict             # raw per-kind bytes
    model_flops: float            # analytic useful FLOPs (whole step, global)
    n_devices: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.traffic_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time (no overlap assumption: max of terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops x ranks): compute usefulness."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops / self.n_devices / self.t_bound) / PEAK_FLOPS

    def summary(self) -> dict:
        return {
            "hlo_flops_per_dev": self.flops,
            "traffic_bytes_per_dev": self.traffic_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "collectives": self.collectives,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
        }


def roofline_from_counts(counts: dict, comm_out_bytes: dict,
                         model_flops: float, n_devices: int) -> Roofline:
    """A Roofline from `OpCounter.summary()` and `comm_log`'s result
    bytes by kind (the port's names)."""
    coll: dict = collections.defaultdict(float)
    for kind, b in comm_out_bytes.items():
        coll[HLO_KIND.get(kind, kind)] += float(b)
    weighted = sum(COLL_WEIGHT.get(k, 1.0) * v for k, v in coll.items())
    return Roofline(flops=counts["flops"],
                    traffic_bytes=counts["traffic_bytes"],
                    collective_bytes=weighted, collectives=dict(coll),
                    model_flops=model_flops, n_devices=n_devices)
