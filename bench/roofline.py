"""Peaks of the cards the benchmark knows, and the bytes a search needs.

Peaks are the published data-sheet figures (SXM part, at its full power
limit).  A card not in the table has no roofline, and metrics that need
one are left out of the result.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def search_bytes(shape: dict, batch: int, k: int) -> int:
    """Bytes one batch search needs to read and write, each once, from
    its shapes, whatever implements it.

    Once a call: the PQ codebooks (M x K x D/M f32) and the entry
    candidates' ids (int64) and codes (M bytes each).  A query: its
    vector (D f32); `max_hops` expansions, each R adjacency ids (int32)
    and R codes of M bytes; `rerank` exact vectors (D f32); and its k
    answers (int64 id, f32 distance).  Intermediates such as the ADC
    tables and the candidate pool are not counted.
    """
    d, m, r = shape["dim"], shape["pq_m"], shape["r"]
    e = shape["entry_cands"]
    once = m * shape["pq_k"] * (d // m) * 4 + e * (8 + m)
    hop = r * 4 + r * m
    query = d * 4 + shape["max_hops"] * hop + shape["rerank"] * d * 4 \
        + k * (8 + 4)
    return once + batch * query
