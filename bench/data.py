"""The benchmark's vector data: a corpus fixed by its configuration and a
query set drawn from the run's seed, in plain torch.

A configuration's mixture has `clusters` components.  Component c has a
centre drawn from N(0, center_std^2 I_dim) and an orthonormal basis of
`latent_dim` random directions; a point of it is the centre, plus
N(0, latent_std^2) coordinates along that basis, plus N(0, noise_std^2)
noise in every dimension.  Points pick their component uniformly.  So the
data's local intrinsic dimension is about `latent_dim`, as published
estimates for real descriptor sets are, where an isotropic Gaussian
cluster has the full `dim`.

The mixture (centres, bases) comes from `data_seed` on the host; the
points come from a generator on `device` seeded with `data_seed` (the
corpus) or with the run's seed (the queries), in a few large calls.  The
same seeds on the same kind of device give the same bits.
"""
from __future__ import annotations

import contextlib

import torch

# keeps the corpus's stream and the query streams apart
_QUERY_STREAM = 0x5EED_0F_0E


@contextlib.contextmanager
def exact_f32():
    """float32 products computed in float32: TF32 off for cuBLAS and
    cuDNN while the block runs, whatever the process had set."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def mixture(cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(centres (C, D), bases (C, D, latent_dim)) of a configuration, on
    the host."""
    g = torch.Generator().manual_seed(int(cfg["data_seed"]))
    c, d, ld = int(cfg["clusters"]), int(cfg["dim"]), int(cfg["latent_dim"])
    centres = torch.randn(c, d, generator=g) * float(cfg["center_std"])
    bases, _ = torch.linalg.qr(torch.randn(c, d, ld, generator=g))
    return centres, bases


def _draw(cfg: dict, n: int, g: torch.Generator, device) -> torch.Tensor:
    centres, bases = (t.to(device) for t in mixture(cfg))
    c, d, ld = bases.shape
    comp = torch.randint(c, (n,), generator=g, device=device)
    z = torch.randn(n, ld, generator=g, device=device) * float(
        cfg["latent_std"])
    x = torch.randn(n, d, generator=g, device=device) * float(
        cfg["noise_std"])
    x += centres[comp]
    order = torch.argsort(comp, stable=True)
    counts = torch.bincount(comp, minlength=c).tolist()
    start = 0
    with exact_f32():
        for j, cnt in enumerate(counts):
            rows = order[start:start + cnt]
            x[rows] += z[rows] @ bases[j].T
            start += cnt
    return x


def corpus(cfg: dict, device) -> torch.Tensor:
    """The configuration's (n, dim) float32 corpus, drawn on `device`."""
    g = torch.Generator(device=device).manual_seed(int(cfg["data_seed"]))
    return _draw(cfg, int(cfg["n"]), g, device)


def queries(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """`n` held-out (n, dim) float32 queries from the configuration's
    mixture, drawn on `device` from `seed` (any whole number >= 0)."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) ^ _QUERY_STREAM) % (1 << 63))
    return _draw(cfg, n, g, device)
