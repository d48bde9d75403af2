"""Dispatch wrappers for the PQ ADC kernels (`csrc/pq_adc.cu`).

backend: "cuda" launches the kernel (CUDA tensors only), "ref" runs the
plain version, "auto" launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  Each wrapper counts its launches in a
plain integer attribute (`pq_adc.launches`, `pq_adc_rowwise.launches`).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import pq_adc_ref, pq_adc_rowwise_ref


def _check_table(tables: torch.Tensor) -> None:
    smem = tables.shape[1] * tables.shape[2] * 4
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"an (M, K) = {tuple(tables.shape[1:])} f32 table needs {smem} "
            f"bytes of shared memory; the limit is {_build.MAX_SMEM_BYTES}")


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
        _build.launch("pq_adc", "pq_adc_launch", dev, tables.data_ptr(),
                      codes.data_ptr(), out.data_ptr(), b, n, m, k)
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
        _build.launch("pq_adc_rowwise", "pq_adc_rowwise_launch", dev,
                      tables.data_ptr(), cand_codes.data_ptr(),
                      out.data_ptr(), b, r, m, k)
        _build.count(pq_adc_rowwise)
    return out


pq_adc.launches = 0
pq_adc_rowwise.launches = 0
