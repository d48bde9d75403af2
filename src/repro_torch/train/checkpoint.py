"""Checkpointing: atomic, async, in the reference's format (port of
`repro.train.checkpoint`).

Format: one .npz per checkpoint, keyed by the reference's tree paths
("['params']['layers']['wq']", `utils.tree.flatten_with_path`), plus a
JSON manifest {step, leaves: {path: [shape, dtype]}}.  Writes are atomic
(tmp file + os.replace), so a preemption mid-save never corrupts the
latest checkpoint; `latest_step` scans the directory.  A checkpoint that
either package writes, the other restores.

Async: `AsyncCheckpointer` copies the tree to the host on the caller's
thread (the only part that blocks the step) and serializes and writes in
a thread.

The .npz is `np.savez`'s format (an uncompressed zip of .npy members),
written with the members' CRC-32 summed in parallel and their data
written from the arrays' own buffers, and read back by `np.fromfile` at
each member's offset, eight members at a time, with its CRC-32 checked
(a compressed member, which `np.savez_compressed` writes, goes through
`np.load`): `np.savez` and `np.load` sum CRC-32 and copy on one thread,
at half the disk's rate or less on a 15 GB train state (PERF.md §5).

numpy has no bfloat16: a bf16 leaf raises (the train state's
parameters are f32 masters).

Sharded trees (`utils.sharding` DTensor leaves): every rank of the mesh
calls `save` (or `AsyncCheckpointer.save`) and joins the gather of each
leaf's full tensor, on the caller's thread; the mesh's first rank (every
coordinate 0) writes the same npz and manifest as for an unsharded tree,
and the others wait at a barrier (the async writer's, in its `wait`).
Elastic restore: `restore_sharded` reads the full arrays and cuts each
into the new layout's block (`utils.sharding.shard_leaf`) -- the mesh
and its device count may differ from the saving run's.
"""
from __future__ import annotations

import io
import json
import os
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from ..utils.sharding import axis_names, barrier, full_tensor, shard_leaf
from ..utils.tree import flatten_with_path, leaves, unflatten


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array that owns its memory (a later
    in-place update of the tensor does not reach it)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype; checkpoint "
                            "the f32 master weights (or cast the tree)")
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


_SLICE = 1 << 28          # bytes a file write takes at once
_THREADS = 8              # members read or CRC-summed at once


def _write_npz(f, arrays: dict) -> None:
    """`np.savez`'s format: an uncompressed zip (zip64 records) of one
    .npy member per array.  Each member's CRC-32 is summed first, eight
    members at a time, so that its local header can precede its data;
    the data is then written from the array's own buffer."""
    members = []
    for k, a in arrays.items():
        a = np.asarray(a, order="C")            # keeps 0-d arrays 0-d
        head = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            head, np.lib.format.header_data_from_array_1_0(a))
        members.append(((k + ".npy").encode(), head.getvalue(),
                        memoryview(a.reshape(-1)).cast("B")))
    with ThreadPoolExecutor(max_workers=_THREADS) as pool:
        crcs = list(pool.map(lambda m: zlib.crc32(m[2], zlib.crc32(m[1])),
                             members))
    central = []
    for (name, head, data), crc in zip(members, crcs):
        size = len(head) + len(data)
        offset = f.tell()
        # local header: sizes in its zip64 extra field; 1980-01-01 00:00
        f.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, 0, 0, 0, 0x21,
                            crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name), 20)
                + name + struct.pack("<HHQQ", 1, 16, size, size) + head)
        for i in range(0, len(data), _SLICE):
            f.write(data[i:i + _SLICE])
        central.append(
            struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45, 0, 0, 0,
                        0x21, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name), 28, 0,
                        0, 0, 0, 0xFFFFFFFF)
            + name + struct.pack("<HHQQQ", 1, 24, size, size, offset))
    cd_offset = f.tell()
    f.write(b"".join(central))
    cd_size = f.tell() - cd_offset
    end64 = f.tell()
    n = len(members)
    f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n, n,
                        cd_size, cd_offset)
            + struct.pack("<IIQI", 0x07064B50, 0, end64, 1)
            + struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF),
                          min(n, 0xFFFF), 0xFFFFFFFF, 0xFFFFFFFF, 0))


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored .npy member of the zip at `path`: the array read in
    place from its offset, its CRC-32 checked."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        head_len = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(head_len))
        count = int(np.prod(shape))
        a = np.fromfile(f, dtype=dtype, count=count)
    if a.size != count or zlib.crc32(a, crc) != info.CRC:
        raise ValueError(f"{path}: member {info.filename} is truncated or "
                         f"corrupt (CRC-32 mismatch)")
    return (a.reshape(shape[::-1]).T if fortran else a.reshape(shape))


def _read_npz(path: str, keys) -> dict:
    """{key: array} of the .npz at `path` for `keys` (all present)."""
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename[:-4]: i for i in zf.infolist()
                 if i.filename.endswith(".npy")}
    stored = [k for k in keys if infos[k].compress_type == zipfile.ZIP_STORED]
    with ThreadPoolExecutor(max_workers=_THREADS) as pool:
        out = dict(zip(stored, pool.map(
            lambda k: _read_member(path, infos[k]), stored)))
    rest = [k for k in keys if k not in out]
    if rest:
        with np.load(path) as z:
            out.update((k, z[k]) for k in rest)
    return out


def _mesh_of(flat: list):
    """The mesh of the first sharded leaf, or None."""
    return next((x.device_mesh for x in flat if isinstance(x, DTensor)),
                None)


def _writes(mesh) -> bool:
    """Whether this rank writes: no mesh, or the mesh's first rank."""
    return mesh is None or all(mesh.get_local_rank(a) == 0
                               for a in axis_names(mesh))


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic checkpoint write. Returns the final path.  A sharded tree:
    every rank of its mesh calls, the first rank writes (above)."""
    flat = flatten_with_path(tree)
    mesh = _mesh_of([v for _, v in flat])
    if mesh is not None:
        host = {}
        for k, v in flat:          # gathered a leaf at a time, every rank
            full = full_tensor(v)
            if _writes(mesh):
                host[k] = _host(full)
            del full
        path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
        if _writes(mesh):
            _write(ckpt_dir, step, host)
        barrier(mesh)
        return path
    return _write(ckpt_dir, step, {k: _host(v) for k, v in flat})


def _write(ckpt_dir: str, step: int, host: dict) -> str:
    """Write the npz of host arrays and the manifest, atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_npz(f, host)
    os.replace(tmp, path)
    manifest = {"step": step,
                "leaves": {k: [list(v.shape), str(v.dtype)]
                           for k, v in host.items()}}
    mtmp = os.path.join(ckpt_dir, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, "manifest.json"))
    return path


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(f[5:13]) for f in os.listdir(ckpt_dir)
                  if f.startswith("ckpt_") and f.endswith(".npz"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """Load a checkpoint into the structure of `like`: each tensor leaf
    comes back on its `like` leaf's device and in its dtype, any other
    leaf as a host numpy array.  Returns (tree, step).

    The leaf set must match exactly -- a changed model structure is an
    error, not a silent partial restore.
    """
    like_flat, arrays, step = _read(ckpt_dir, like, step)
    out = [_leaf(arrays.pop(k), ref) for k, ref in like_flat]
    return unflatten(like, out), step


def _read(ckpt_dir: str, like: Any, step: Optional[int]):
    """(like's [(path, leaf)], {path: host array}, step) of the checkpoint
    at `step` (None: the latest); the leaf sets must match."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    like_flat = flatten_with_path(like)
    with zipfile.ZipFile(path) as zf:
        files = [n[:-4] for n in zf.namelist() if n.endswith(".npy")]
    paths = [k for k, _ in like_flat]
    missing = [k for k in paths if k not in set(files)]
    extra = [k for k in files if k not in set(paths)]
    if missing or extra:
        raise ValueError(f"checkpoint/model mismatch: missing="
                         f"{missing[:5]} extra={extra[:5]}")
    return like_flat, _read_npz(path, paths), step


def _leaf(a: np.ndarray, ref):
    """A stored array on `ref`'s device and in its dtype (a tensor `ref`),
    else the host array."""
    if not torch.is_tensor(ref):
        return a
    return torch.from_numpy(a).to(device=ref.device, dtype=ref.dtype)


def _aligned(like: Any, shardings: Any) -> list:
    """The leaf of `shardings` at each leaf position of `like`, in
    `flatten_with_path`'s order (None where `shardings` has None)."""
    out = []

    def walk(t, s):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], None if s is None else s[k])
        elif isinstance(t, (list, tuple)):
            for i, c in enumerate(t):
                walk(c, None if s is None else s[i])
        else:
            out.append(s)

    walk(like, shardings)
    return out


def restore_sharded(ckpt_dir: str, like: Any, shardings,
                    step: Optional[int] = None):
    """Elastic restore: each leaf read whole and laid out by its
    `utils.sharding.NamedSharding` in `shardings` (a tree like `like`;
    None: a plain tensor), on `like`'s devices and dtypes -- the mesh and
    its device count may differ from the run that saved.  No
    communication: every rank reads the npz.  Returns (tree, step)."""
    like_flat, arrays, step = _read(ckpt_dir, like, step)
    out = []
    for (k, ref), s in zip(like_flat, _aligned(like, shardings)):
        x = _leaf(arrays.pop(k), ref)
        out.append(x if s is None else shard_leaf(s.mesh, s.spec, x))
    return unflatten(like, out), step


class AsyncCheckpointer:
    """Snapshot on the caller's thread (a host copy), write in a thread,
    keep the last `keep` checkpoints.

    A CUDA leaf is copied into a pinned host buffer that the checkpointer
    keeps for the next save of a tree of the same shapes (the copy runs
    at the link's rate, not pageable memory's); the writer reads the
    buffers, and the next save waits for it before it copies again."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: list = []
        self._mesh = None

    def _snapshot(self, flat: list) -> list:
        """Host copies of the leaves, CUDA ones through the pinned
        buffers (allocated again when the leaves' shapes change).  A
        sharded tree is gathered leaf by leaf (every rank joins); only
        the writing rank keeps the copies."""
        if self._mesh is not None:
            full = []
            for x in flat:
                x = full_tensor(x)
                full.append(_host(x) if _writes(self._mesh) else None)
            return full
        cuda = [torch.is_tensor(x) and x.is_cuda
                and x.dtype != torch.bfloat16 for x in flat]
        if len(self._pinned) != len(flat) or any(
                c and (b is None or (b.shape, b.dtype) != (x.shape, x.dtype))
                for b, x, c in zip(self._pinned, flat, cuda)):
            self._pinned = [torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True) if c else None
                            for x, c in zip(flat, cuda)]
        out = []
        for x, buf in zip(flat, self._pinned):
            if buf is None:
                out.append(_host(x))
            else:
                buf.copy_(x.detach())
                out.append(buf.numpy())
        return out

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        flat = leaves(tree)
        self._mesh = _mesh_of(flat)
        host = unflatten(tree, self._snapshot(flat))
        if not _writes(self._mesh):
            return

        def write():
            try:
                save(self.ckpt_dir, step, host)
                self._gc()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the pending write is done; re-raise its error.  After
        a sharded save, every rank waits here for the writer."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            barrier(self._mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[:-self.keep]:
            try:
                os.remove(os.path.join(self.ckpt_dir, f"ckpt_{s:08d}.npz"))
            except FileNotFoundError:
                pass
