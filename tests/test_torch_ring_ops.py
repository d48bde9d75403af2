"""The port's ring gather / scatter against the reference's (CPU).

The reference's `ring_gather` / `ring_scatter_add` run once, in one
subprocess with 4 fake XLA devices on a (2, 2) mesh (as
tests/test_ring_ops.py does: the device count must be set before jax
initializes), on a seeded table, ids with -1 pads and values: forward
and VJP of each.  The port's ops run here on P in-process ranks joined
by a thread ring: `ring_group` and `ring_shift` are replaced by a
barrier exchange between P threads, so the ops' own code runs as it
does on a mesh, each rank in its own thread (its backward too).  The
real collective on 4 gloo ranks is held against the same reference in
tests/test_torch_sharded.py's 4-rank spawn (`ring_reference` is shared).
Tolerances: the gather's forward bitwise, the scatter and both VJPs
within the reference test's rtol / atol 1e-5 (tests/test_ring_ops.py).
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models.gnn import ring_gather as rg

ROOT = Path(__file__).resolve().parents[1]
E, D, T = 64, 16, 200
_SNIPPET = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.models.gnn.ring_gather import ring_gather, ring_scatter_add
from repro.utils.sharding import make_mesh_compat
try:
    from jax import shard_map
    kw = dict(check_vma=False)
except ImportError:
    from jax.experimental.shard_map import shard_map
    kw = dict(check_rep=False)
mesh = make_mesh_compat((2, 2), ("data", "model"))
AX = ("data", "model")
E, D, T = %d, %d, %d
rng = np.random.default_rng(0)
table = rng.normal(size=(E, D)).astype(np.float32)
idx = rng.integers(-1, E, (T,)).astype(np.int32)
vals = rng.normal(size=(T, D)).astype(np.float32)
def gat(t, i):
    return shard_map(lambda a, b: ring_gather(a, b, AX), mesh=mesh,
                     in_specs=(P(AX, None), P(AX)), out_specs=P(AX, None),
                     **kw)(t, i)
def sca(v, i):
    return shard_map(lambda a, b: ring_scatter_add(a, b, AX, E // 4),
                     mesh=mesh, in_specs=(P(AX, None), P(AX)),
                     out_specs=P(AX, None), **kw)(v, i)
out = jax.jit(gat)(table, idx)
g_table = jax.jit(jax.grad(lambda t: jnp.sum(gat(t, idx) ** 2)))(table)
s = jax.jit(sca)(vals, idx)
g_vals = jax.jit(jax.grad(lambda v: jnp.sum(sca(v, idx) ** 2)))(vals)
np.savez(sys.argv[1], table=table, idx=idx, vals=vals, out=out,
         g_table=g_table, s=s, g_vals=g_vals)
""" % (E, D, T)


def ring_reference(path) -> dict:
    """The reference's ring ops on a (2, 2) mesh of 4 fake devices, run
    in a subprocess: {table, idx, vals (inputs), out, g_table (the
    gather's forward and the gradient of sum(out^2)), s, g_vals (the
    scatter's, likewise)} as numpy."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SNIPPET, str(path)], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return ring_reference(tmp_path_factory.mktemp("ring") / "ref.npz")


class ThreadRing:
    """P ranks as P threads of this process, each its ring position; one
    ring step is a barrier exchange."""

    def __init__(self, p: int):
        self.p = p
        self.slots = [None] * p
        self.barrier = threading.Barrier(p)
        self.me = threading.local()
        self.shifts = 0

    def group(self, mesh, axes):
        return None, self.me.rank, self.p

    def shift(self, x, mesh, axes):
        me = self.me.rank
        if me == 0:
            self.shifts += 1
        self.slots[(me + 1) % self.p] = x.clone()
        self.barrier.wait()
        out = self.slots[me]
        self.barrier.wait()
        return out

    def run(self, fn) -> list:
        out, errs = [None] * self.p, []

        def one(r):
            self.me.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 -- reraised below
                errs.append(e)
                self.barrier.abort()

        ts = [threading.Thread(target=one, args=(r,)) for r in range(self.p)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        if errs:
            raise errs[0]
        return out


def _on_ring(monkeypatch, p):
    ring = ThreadRing(p)
    monkeypatch.setattr(rg, "ring_group", ring.group)
    monkeypatch.setattr(rg, "ring_shift", ring.shift)
    return ring


def _blocks(a, p, r):
    n = a.shape[0] // p
    return torch.from_numpy(a[r * n:(r + 1) * n].copy())


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_gather_fwd_and_vjp(ref, monkeypatch, p):
    ring = _on_ring(monkeypatch, p)

    def rank(r):
        tab = _blocks(ref["table"], p, r).requires_grad_(True)
        out = rg.ring_gather(tab, _blocks(ref["idx"], p, r), None, "ring")
        (out ** 2).sum().backward()
        return out.detach().numpy(), tab.grad.numpy()

    res = ring.run(rank)
    out = np.concatenate([o for o, _ in res])
    np.testing.assert_array_equal(out, ref["out"])
    np.testing.assert_allclose(np.concatenate([g for _, g in res]),
                               ref["g_table"], rtol=1e-5, atol=1e-5)
    # P - 1 rotations forward, P back
    assert ring.shifts == 2 * p - 1


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_scatter_fwd_and_vjp(ref, monkeypatch, p):
    ring = _on_ring(monkeypatch, p)

    def rank(r):
        v = _blocks(ref["vals"], p, r).requires_grad_(True)
        s = rg.ring_scatter_add(v, _blocks(ref["idx"], p, r), None, "ring",
                                E // p)
        (s ** 2).sum().backward()
        return s.detach().numpy(), v.grad.numpy()

    res = ring.run(rank)
    np.testing.assert_allclose(np.concatenate([s for s, _ in res]),
                               ref["s"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g for _, g in res]),
                               ref["g_vals"], rtol=1e-5, atol=1e-5)


def test_ring_keeps_dtypes_and_sums_in_f32(monkeypatch):
    """bf16 values: the f32 accumulator is cast back to bf16 at the end,
    and the gather's VJP comes back in the table's dtype."""
    p = 4
    ring = _on_ring(monkeypatch, p)
    g = torch.Generator().manual_seed(1)
    vals = torch.randn(64, 8, generator=g).to(torch.bfloat16)
    idx = torch.randint(-1, 16, (64,), generator=g)

    def rank(r):
        v = vals[r * 16:(r + 1) * 16].clone().requires_grad_(True)
        s = rg.ring_scatter_add(v, idx[r * 16:(r + 1) * 16], None, "ring",
                                4)
        s.float().sum().backward()
        return s, v.grad

    res = ring.run(rank)
    got = torch.cat([s for s, _ in res])
    want = torch.zeros(17, 8).index_add_(
        0, torch.where(idx >= 0, idx, 16), torch.where(
            idx[:, None] >= 0, vals.float(), 0.0))[:16]
    assert got.dtype == torch.bfloat16
    # the f32 sums may add in another order: within one bf16 ulp
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=0)
    assert all(gr.dtype == torch.bfloat16 for _, gr in res)
