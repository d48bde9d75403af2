"""Meshes: the host device grid that serving places onto (port of
`repro.launch.mesh.make_host_mesh`), and the ranks that the sharded
paths run on.

`HostMesh` is a grid of `torch.device`s with the reference's axis names
("data", "model"); serving (`serve.runtime.placement`) flattens it into
one worker per device, in one process.

The sharded paths are SPMD, one process a rank: `run_ranks` starts
`world` ranks, joins them in a `torch.distributed` process group (gloo
for CPU ranks and for ranks that share one card, which NCCL refuses;
NCCL where each rank has its own card), builds a `DeviceMesh` of the
given shape and axis names (`device_mesh`), runs a module-level
function on every rank and returns rank 0's result.  Collectives take
the ranks' tensors on their device, over gloo on the card too; one that
the backend refuses raises on every rank.  `make_production_mesh`
gives the reference's production meshes (256 and 512 chips) over the
current process group: the dry run (`launch.dryrun`) builds them on a
fake group of that size, one process standing for rank 0.

Functions, not module constants: importing this module never touches
device state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import queue
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device
from ..utils import sharding


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A (data, model) grid of devices."""
    devices: np.ndarray                     # (data, model) of torch.device
    axis_names: tuple = ("data", "model")


def make_host_mesh(model: int = 1, data: int | None = None,
                   device=None) -> HostMesh:
    """Small mesh over whatever devices exist (tests / examples).

    `device=None` (or "cuda" without an index) spans every CUDA device and
    raises without one; an indexed CUDA device spans that device alone;
    "cpu" one CPU device, as a JAX CPU host has.

    The factorization is validated up front: `model` larger than the
    device count used to silently derive a 0-sized data axis
    (`data = n // model`), surfacing later as an opaque mesh-shape error.
    """
    dev = resolve_device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" and dev.index is None else [dev])
    n = len(devices)
    if model < 1:
        raise ValueError(f"make_host_mesh: model={model}; axis sizes must "
                         f"be >= 1")
    if model > n:
        raise ValueError(
            f"make_host_mesh: model={model} exceeds the {n} available "
            f"device(s) -- the derived data axis n // model would be "
            f"zero-sized.  Shrink model or run on more devices.")
    if data is None:
        data = n // model
    if data < 1:
        raise ValueError(f"make_host_mesh: data={data}; axis sizes must "
                         f"be >= 1")
    if data * model > n:
        raise ValueError(
            f"make_host_mesh: a ({data}, {model}) mesh needs "
            f"{data * model} devices but only {n} exist")
    grid = np.empty((data, model), object)
    for i, d in enumerate(devices[:data * model]):
        grid[i // model, i % model] = d
    return HostMesh(devices=grid)


# ---------------------------------------------------------------------------
# Ranks: one process each, joined in a process group and a DeviceMesh
# ---------------------------------------------------------------------------
def device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                device_type: str) -> DeviceMesh:
    """A `DeviceMesh` over ranks 0 .. prod(shape) - 1 of the current
    process group, in row-major order, with one process group a mesh dim
    (every rank of the group must call it)."""
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ("data", "model") = 256 ranks, or (2, 16, 16) ("pod",
    "data", "model") = 512, the pod axis carrying cross-pod data
    parallelism; over the current process group, which must have that
    many ranks (every rank calls).  A CPU mesh: the dry run's, whose
    ranks hold meta tensors."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes, "cpu")


def backend_for(device_type: str, world: int) -> str:
    """NCCL where every rank has its own card; gloo for CPU ranks and for
    ranks that share a card (NCCL refuses two ranks on one device)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank, shape, axis_names, device, init_method, timeout,
               threads, inbox, results):
    """One rank: take (fn, args) from `inbox`, join the group, build the
    mesh, run fn(mesh, *args) and report to the parent (rank 0's result,
    the others' None)."""
    try:
        fn, args = inbox.get(timeout=timeout)
        if threads:
            torch.set_num_threads(threads)
        world = math.prod(shape)
        dev = torch.device(device)
        backend = backend_for(dev.type, world)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank if backend == "nccl" else
                               (dev.index or 0))
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        mesh = device_mesh(shape, axis_names, dev.type)
        sharding.comm_log.reset()
        out = fn(mesh, *args)
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:
        results.put(("err", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def _thread_env(threads: int | None):
    """The BLAS / OpenMP thread counts that spawned ranks inherit (numpy's
    BLAS reads them once, when it loads), set to `threads` while they
    start; this process's own are left as they are."""
    if not threads:
        yield
        return
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(threads) for k in _THREAD_VARS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_ranks(fn: Callable, shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "model"), *,
              device: str, init_method: str, args: tuple = (),
              timeout: float = 600.0, threads: int | None = None):
    """Run `fn(mesh, *args)` on prod(shape) ranks, one spawned process
    each, over a `DeviceMesh` of `shape` and `axis_names`; return rank
    0's result (it and `args` cross by pickle, so `fn` is a module-level
    function of a module the ranks can import).

    device: "cpu" (gloo) or "cuda" (NCCL, one card a rank, where there
    are enough; else every rank on that one card, over gloo).
    init_method: the group's rendezvous, given explicitly
    ("file:///path" or "tcp://localhost:port").  `threads` sets each
    rank's torch threads and its BLAS / OpenMP threads (`_thread_env`).
    Raises RuntimeError with the traceback of the
    first rank that fails (or dies), TimeoutError when the ranks have not
    all finished within `timeout` seconds (the group's own timeout too);
    either way every rank still running is stopped."""
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    for _ in range(world):
        # through a queue (its feeder thread writes), not the spawn pipe:
        # a rank that dies while starting cannot block the parent's write
        inbox.put((fn, args))
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, tuple(shape), tuple(axis_names), device, init_method, timeout,
        threads, inbox, results)) for r in range(world)]
    with _thread_env(threads):
        for p in procs:
            p.start()
    deadline = time.monotonic() + timeout
    out, done = None, set()
    try:
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - done)}"
                                   f" did not finish within {timeout} s")
            try:
                kind, rank, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} without a result")
                continue
            if kind == "err":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            done.add(rank)
            if rank == 0:
                out = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(done) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in (inbox, results):
            q.cancel_join_thread()
            q.close()
    return out
