"""Real SO(3) representation machinery for the equivariant GNNs
(NequIP / MACE): real spherical harmonics, real Wigner-D matrices, and real
Clebsch-Gordan coefficients for l <= 2 (port of `repro.models.gnn.so3`:
the numpy functions are the reference's, line for line, so their tables
are bitwise the reference's; `sph_harm_torch` is `sph_harm_jax`).

CG coefficients are derived *numerically* (at import time, in numpy) by
solving the equivariance constraint

    C . (D_l1(R) (x) D_l2(R)) = D_l3(R) . C        for all R in SO(3)

as a null-space problem over a batch of random rotations.  Real Wigner-D
matrices themselves are obtained by evaluating the (explicit, closed-form)
real spherical harmonics on rotated unit vectors and solving a small least
squares system.  This avoids complex-basis phase pitfalls entirely, and the
construction is *self-validating*: tests/test_gnn.py checks equivariance of
full model outputs under random rotations (tests/test_torch_gnn.py
holds the port to the same).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

L_MAX = 2
DIMS = {0: 1, 1: 3, 2: 5}


def real_sph_harm_np(l: int, xyz: np.ndarray) -> np.ndarray:
    """Real spherical harmonics (orthonormal on S^2), xyz (..., 3) unit.
    Returns (..., 2l+1) in m = -l..l order."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    c0 = 0.5 * np.sqrt(1.0 / np.pi)
    if l == 0:
        return np.full(xyz.shape[:-1] + (1,), c0)
    if l == 1:
        c1 = np.sqrt(3.0 / (4 * np.pi))
        return np.stack([c1 * y, c1 * z, c1 * x], axis=-1)
    if l == 2:
        c = np.sqrt(15.0 / (4 * np.pi))
        c20 = np.sqrt(5.0 / (16 * np.pi))
        return np.stack([
            c * x * y,
            c * y * z,
            c20 * (3 * z * z - 1.0),
            c * x * z,
            0.5 * c * (x * x - y * y),
        ], axis=-1)
    raise NotImplementedError(l)


def _random_rotations(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3, 3) uniform-ish random rotation matrices via QR."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    qs = []
    for i in range(n):
        q, r = np.linalg.qr(a[i])
        q = q * np.sign(np.diag(r))[None, :]
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        qs.append(q)
    return np.stack(qs)


def wigner_d_real_np(l: int, rot: np.ndarray, seed: int = 1) -> np.ndarray:
    """Real Wigner-D for rotation `rot` (3,3): Y_l(R v) = D_l(R) Y_l(v).

    Solved by least squares over random unit vectors."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(4 * (2 * l + 1), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = real_sph_harm_np(l, v)                 # (n, 2l+1)
    b = real_sph_harm_np(l, v @ rot.T)         # (n, 2l+1)
    # D such that b = a @ D^T  =>  D^T = lstsq(a, b)
    dt, *_ = np.linalg.lstsq(a, b, rcond=None)
    return dt.T


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real CG tensor C (2l3+1, 2l1+1, 2l2+1), None if (l1,l2,l3) forbidden.

    Normalized so that sum C^2 = 2l3+1 (componentwise orthonormal rows)."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rots = _random_rotations(12, seed=42)
    rows = []
    for r in rots:
        dd1 = wigner_d_real_np(l1, r)
        dd2 = wigner_d_real_np(l2, r)
        dd3 = wigner_d_real_np(l3, r)
        # constraint: D3 C - C (D1 (x) D2) = 0, C flattened (d3*d1*d2,)
        k12 = np.kron(dd1, dd2)                       # (d1*d2, d1*d2)
        m = np.kron(dd3, np.eye(d1 * d2)) - np.kron(np.eye(d3), k12.T)
        rows.append(m)
    m = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(m)
    null = vt[s.size - np.sum(s < 1e-8):] if np.sum(s < 1e-8) else vt[-1:]
    if null.shape[0] == 0 or s[-1] > 1e-8:
        return None
    c = null[-1].reshape(d3, d1, d2)
    c = c / np.linalg.norm(c) * np.sqrt(d3)
    # sign convention: make the first significant entry positive
    flat = c.reshape(-1)
    idx = np.argmax(np.abs(flat) > 1e-6)
    if flat[idx] < 0:
        c = -c
    return c


def allowed_paths(l_max: int = L_MAX):
    """All (l1, l2, l3) with a valid CG, l's <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    out.append((l1, l2, l3))
    return out


def sph_harm_torch(l: int, xyz: torch.Tensor) -> torch.Tensor:
    """torch version of real_sph_harm_np (same formulas), xyz (..., 3)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    c0 = float(0.5 * np.sqrt(1.0 / np.pi))
    if l == 0:
        return torch.full(xyz.shape[:-1] + (1,), c0, dtype=xyz.dtype,
                          device=xyz.device)
    if l == 1:
        c1 = float(np.sqrt(3.0 / (4 * np.pi)))
        return torch.stack([y * c1, z * c1, x * c1], dim=-1)
    if l == 2:
        c = float(np.sqrt(15.0 / (4 * np.pi)))
        c20 = float(np.sqrt(5.0 / (16 * np.pi)))
        return torch.stack([
            x * c * y, y * c * z, (z * 3 * z - 1.0) * c20, x * c * z,
            (x * x - y * y) * (0.5 * c)], dim=-1)
    raise NotImplementedError(l)
