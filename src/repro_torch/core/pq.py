"""Product Quantization: k-means codebook training, encoding, ADC tables
(port of `repro.core.pq`).

The tables and codes feed the ADC kernels (`repro_torch.kernels.pq_adc`,
`repro_torch.kernels.beam_fused`).  Training runs on the tensor's device;
its random draws (the sample and the k-means inits) come from numpy's
`default_rng(seed)` exactly as the reference draws them, so codebooks
from one seed differ between the two packages only by float rounding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .distances import f32_matmul


@dataclasses.dataclass
class PQCodec:
    """codebooks: (M, K, dsub) float32 tensor; codes are uint8 (n, M)."""

    codebooks: torch.Tensor

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    def encode(self, x: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
        """(n, d) -> (n, M) uint8 codes on the codebooks' device."""
        cb = self.codebooks
        out = [_encode(x[s:s + chunk].to(cb.device, torch.float32), cb)
               for s in range(0, len(x), chunk)]
        return torch.cat(out, 0)

    def adc_table(self, q: torch.Tensor) -> torch.Tensor:
        """Query (d,) -> (M, K) table of squared L2 distances per subspace."""
        return adc_tables(q[None], self.codebooks)[0]

    def adc_tables(self, qs: torch.Tensor) -> torch.Tensor:
        """(B, d) -> (B, M, K)."""
        return adc_tables(qs, self.codebooks)

    def estimate(self, table: torch.Tensor, codes: torch.Tensor):
        """ADC: (M, K) table + (n, M) codes -> (n,) estimated squared
        distances, summed over m in ascending order."""
        c = codes.long()
        acc = torch.zeros(codes.shape[0], dtype=torch.float32,
                          device=table.device)
        for j in range(table.shape[0]):
            acc = acc + table[j, c[:, j]]
        return acc


def _encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x (b, M*dsub), codebooks (M, K, dsub) -> (b, M) uint8: per subspace
    the argmin (first on ties) of |x|^2 - 2 x.c + |c|^2, in that order."""
    m, _, dsub = codebooks.shape
    xs = x.reshape(x.shape[0], m, dsub).transpose(0, 1)           # (M, b, ds)
    with f32_matmul():
        xc = torch.bmm(xs, codebooks.transpose(1, 2))
    d = ((xs * xs).sum(2, keepdim=True) - 2 * xc
         + (codebooks * codebooks).sum(2)[:, None, :])             # (M, b, K)
    return torch.argmin(d, 2).T.to(torch.uint8).contiguous()


def adc_tables(qs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Batched ADC tables: (B, d) x (M, K, dsub) -> (B, M, K), the squared
    L2 distance of each query subvector to each centroid."""
    m, _, dsub = codebooks.shape
    diff = qs.float().reshape(qs.shape[0], m, 1, dsub) - codebooks[None]
    return (diff * diff).sum(-1)


def _kmeans(data: torch.Tensor, init: torch.Tensor, iters: int):
    """Lloyd iterations for all subspaces at once: data (M, n, dsub), init
    (M, K, dsub).  Empty clusters keep their centroid.  The cluster sums
    are a one-hot matmul, deterministic where an atomic scatter is not."""
    cent = init
    m, n, _ = data.shape
    k = cent.shape[1]
    d2 = (data * data).sum(2, keepdim=True)
    for _ in range(iters):
        with f32_matmul():
            dc = torch.bmm(data, cent.transpose(1, 2))
        d = d2 - 2 * dc + (cent * cent).sum(2)[:, None, :]         # (M, n, K)
        assign = torch.argmin(d, 2)
        onehot = torch.zeros(m, n, k, dtype=torch.float32, device=data.device)
        onehot.scatter_(2, assign[:, :, None], 1.0)
        counts = onehot.sum(1)                                     # (M, K)
        with f32_matmul():
            sums = torch.bmm(onehot.transpose(1, 2), data)         # (M, K, ds)
        cent = torch.where(counts[:, :, None] > 0,
                           sums / counts.clamp_min(1.0)[:, :, None], cent)
    return cent


def train_pq(x: torch.Tensor, m: int = 16, k: int = 256, iters: int = 12,
             sample: int = 65536, seed: int = 0) -> PQCodec:
    """Train a PQ codec on (a sample of) x on x's device; d % m == 0."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"d={d} not divisible by M={m}")
    rng = np.random.default_rng(seed)
    if n > sample:
        x = x[torch.as_tensor(rng.choice(n, sample, replace=False),
                              device=x.device)]
    n = x.shape[0]
    k_eff = min(k, n)
    dsub = d // m
    xs = x.float().reshape(n, m, dsub).transpose(0, 1).contiguous()
    inits = []
    for j in range(m):
        idx = rng.choice(n, k_eff, replace=False)
        if k_eff < k:  # pad duplicate centroids (tiny datasets / tests)
            idx = np.concatenate([idx, idx[rng.integers(0, k_eff,
                                                        k - k_eff)]])
        inits.append(xs[j][torch.as_tensor(idx, device=x.device)])
    return PQCodec(codebooks=_kmeans(xs, torch.stack(inits), iters))
