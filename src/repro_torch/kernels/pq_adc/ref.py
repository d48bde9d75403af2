"""Plain PyTorch versions of PQ asymmetric distance computation (ADC).

est[b, n] = sum_m tables[b, m, codes[n, m]]

Both sum over m in ascending order in an explicit loop, as the CUDA
kernels (`csrc/pq_adc.cu`) do, so kernel and plain version agree bit for
bit.  Codes are cast to int64 before they index: torch reads a uint8 index
tensor as a mask.
"""
from __future__ import annotations

import torch


def pq_adc_ref(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """tables (B, M, K) f32; codes (N, M) uint8/int -> (B, N) f32."""
    c = codes.long()
    acc = torch.zeros((tables.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=tables.device)
    for m in range(tables.shape[1]):
        acc = acc + tables[:, m, :][:, c[:, m]]
    return acc


def pq_adc_rowwise_ref(tables: torch.Tensor,
                       cand_codes: torch.Tensor) -> torch.Tensor:
    """Per-row ADC: each query scores its *own* gathered candidate codes.

    tables (B, M, K) f32; cand_codes (B, R, M) uint8/int -> (B, R) f32,
    est[b, r] = sum_m tables[b, m, cand_codes[b, r, m]].
    """
    c = cand_codes.long()
    acc = torch.zeros(cand_codes.shape[:2], dtype=torch.float32,
                      device=tables.device)
    for m in range(tables.shape[1]):
        acc = acc + torch.gather(tables[:, m, :], 1, c[:, :, m])
    return acc
