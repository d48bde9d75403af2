"""Dispatch wrappers for the PQ ADC kernels (`csrc/pq_adc.cu`).

backend: "cuda" launches the kernel (CUDA tensors only), "ref" runs the
plain version, "auto" launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  Each wrapper counts its launches in a
plain integer attribute (`pq_adc.launches`, `pq_adc_rowwise.launches`).
`plan` chooses the kernel's form and geometry from the shapes and the
codes' address alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build
from .ref import pq_adc_ref, pq_adc_rowwise_ref

FORMS = ("gather", "staged")    # the C entry points' form argument
THREADS = 256        # a staged block's threads; the most a gather block has
SMS = 132            # the H100's SMs
STAGED_CTAS = 2 * SMS  # staged blocks a call aims at: two on each SM
# The staged form where a staged block would look each entry of its table
# up at least LOOKUPS_CUT times (rows a block scores / K).  On one H100
# (tools/pq_adc_bench.py --sweep, M = 16, K = 256) the staged form took
# 7-16% less time than the gather form from 3.1 lookups an entry up
# (B = 3, N = 70,000: 3.48 against 3.90 µs); at 1 the two were level
# (B = 64, N = 256: 1.76 against 1.75) or either won (B = 64, N = 1,024:
# gather 2.24 against 2.31; B = 3, N = 16,384: staged 2.13 against 2.60).
# The cut sits between.
LOOKUPS_CUT = 2
_MAX_FLAT = 2 ** 31 - 1   # the gather form's flat index is an int


@dataclass(frozen=True)
class Plan:
    """One call's kernel form and launch geometry.

    gather: grid (ceil(B*N / threads), 1), one thread per estimate over
    the flat index, no shared memory.  staged: grid (B, gy) of THREADS
    threads; block (b, y) stages table b (M*K*4 shared bytes) and scores
    rows y*THREADS + t, stepping by gy*THREADS.  vec: bytes of a row's
    codes read per load (16, 8, 4 or 1)."""
    form: str
    grid: tuple[int, int]
    threads: int
    smem: int
    vec: int


def code_vec(m: int, addr: int) -> int:
    """The widest load (16, 8, 4 or 1 bytes) that every code row can use:
    row i starts at addr + i * M, so the width must divide both."""
    for v in (16, 8, 4):
        if m % v == 0 and addr % v == 0:
            return v
    return 1


def gather_plan(b: int, n: int, vec: int) -> Plan:
    """Blocks of the power of two (32 to THREADS) threads that spreads the
    B*N estimates over all SMS SMs."""
    total = max(1, b * n)
    threads = min(THREADS, max(32, 1 << (-(-total // SMS) - 1).bit_length()))
    return Plan("gather", (-(-total // threads), 1), threads, 0, vec)


def staged_plan(b: int, n: int, m: int, k: int, vec: int,
                ctas: int = STAGED_CTAS) -> Plan:
    """gy blocks a query: `ctas` blocks in all, at most one per THREADS
    rows and 65,535."""
    gy = min(max(1, -(-ctas // max(b, 1))), max(1, -(-n // THREADS)), 65535)
    return Plan("staged", (max(b, 1), gy), THREADS, m * k * 4, vec)


def plan(b: int, n: int, m: int, k: int, addr: int) -> Plan:
    """The form and geometry for B queries of N code rows each (shared by
    the queries or, rowwise, each query's own: the rule is the same),
    M codes a row of K centroids, codes starting at byte address addr."""
    vec = code_vec(m, addr)
    staged = staged_plan(b, n, m, k, vec)
    if b * n > _MAX_FLAT or -(-n // staged.grid[1]) >= LOOKUPS_CUT * k:
        return staged
    return gather_plan(b, n, vec)


def _check_table(tables: torch.Tensor) -> None:
    smem = tables.shape[1] * tables.shape[2] * 4
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"an (M, K) = {tuple(tables.shape[1:])} f32 table needs {smem} "
            f"bytes of shared memory; the limit is {_build.MAX_SMEM_BYTES}")


def _launch(name: str, tables: torch.Tensor, codes: torch.Tensor,
            out: torch.Tensor, n: int) -> None:
    b, m, k = tables.shape
    p = plan(b, n, m, k, codes.data_ptr())
    _build.launch(name, f"{name}_launch", tables.device, tables.data_ptr(),
                  codes.data_ptr(), out.data_ptr(), b, n, m, k,
                  FORMS.index(p.form), p.vec, *p.grid, p.threads)


def pq_adc(tables: torch.Tensor, codes: torch.Tensor,
           backend: str = "auto") -> torch.Tensor:
    """ADC estimates of a shared code set.

    tables: (B, M, K) float32 -- per-query per-subspace centroid distances
    codes:  (N, M) uint8 -- PQ codes (the kernel takes uint8 only; the
            plain version any integer type); every code must be < K
    returns (B, N) float32
    """
    if not _build.use_kernel(backend, tables, "pq_adc"):
        return pq_adc_ref(tables, codes)
    dev = tables.device
    b, m, k = tables.shape
    n = codes.shape[0]
    _build.check(tables, "tables", torch.float32, (b, m, k), dev)
    _build.check(codes, "codes", torch.uint8, (n, m), dev)
    _check_table(tables)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b and n:
        _launch("pq_adc", tables, codes, out, n)
        _build.count(pq_adc)
    return out


def pq_adc_rowwise(tables: torch.Tensor, cand_codes: torch.Tensor,
                   backend: str = "auto") -> torch.Tensor:
    """Per-row ADC estimates (the hop-loop form of `pq_adc`).

    tables:     (B, M, K) float32 -- per-query centroid distance tables
    cand_codes: (B, R, M) uint8 -- each row's gathered neighbour codes
    returns (B, R) float32
    """
    if not _build.use_kernel(backend, tables, "pq_adc_rowwise"):
        return pq_adc_rowwise_ref(tables, cand_codes)
    dev = tables.device
    b, m, k = tables.shape
    r = cand_codes.shape[1]
    _build.check(tables, "tables", torch.float32, (b, m, k), dev)
    _build.check(cand_codes, "cand_codes", torch.uint8, (b, r, m), dev)
    _check_table(tables)
    out = torch.empty((b, r), dtype=torch.float32, device=dev)
    if b and r:
        _launch("pq_adc_rowwise", tables, cand_codes, out, r)
        _build.count(pq_adc_rowwise)
    return out


pq_adc.launches = 0
pq_adc_rowwise.launches = 0
