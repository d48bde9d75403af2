"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

At first use, every source in `csrc/` is compiled for `sm_90a` by its own
`nvcc` process (all started together), and the objects are linked into one
shared library with a plain C interface under `<repo>/build/kernels/`
(git-ignored).  The library's name carries a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.
The wrappers (`kernels/*/ops.py`) launch through `launch`: on PyTorch's
current stream of the tensors' device, under torch's device guard, raising
on any nonzero `cudaGetLastError()`; nothing falls back to the plain
versions when a build or a launch fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232448

BACKENDS = ("auto", "cuda", "ref")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "pq_adc_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "pq_adc_rowwise_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "beam_hops_adc_launch": (_I, [_P] * 14 + [_I] * 6 + [_P]),
    "beam_hops_adc_smem_bytes": (ctypes.c_size_t, [_I] * 4),
    "beam_hops_l2_launch": (_I, [_P] * 16 + [_I] * 5 + [_P]),
    "beam_hops_l2_smem_bytes": (ctypes.c_size_t, [_I] * 3),
    "kernel_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return nvcc


def _digest() -> str:
    """Hash of the flags and of every source and header in `csrc/`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(lib: Path) -> str:
    """Compile every source in parallel, link them into `lib`; returns the
    compiler's output (ptxas register and shared-memory report)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        out = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(out), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out, lib)        # atomic: concurrent builds agree
    log = "".join(logs) + link.stdout
    lib.with_suffix(".log").write_text(log)
    return log


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if not lib_path.exists():
        t0 = time.perf_counter()
        _compile(lib_path)
        build_info.update(seconds=time.perf_counter() - t0)
    build_info.update(path=str(lib_path),
                      log=lib_path.with_suffix(".log").read_text())
    lib = ctypes.CDLL(str(lib_path))
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


# what the last build did: path, seconds (absent when a build was reused),
# and the compiler's report
build_info: dict = {}


def use_kernel(backend: str, t: torch.Tensor, name: str) -> bool:
    """Dispatch rule of every wrapper: "ref" takes the plain version,
    "cuda" the kernel (a CPU tensor raises), "auto" the kernel for a CUDA
    tensor and the plain version for a CPU tensor."""
    if backend not in BACKENDS:
        raise ValueError(f"{name} backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError(f"{name} backend='cuda' needs CUDA tensors, "
                         f"got a tensor on {t.device}")
    return backend != "ref" and t.is_cuda


_COUNT_LOCK = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one to the wrapper's launch counter `attr`, under a lock: the
    build stages launch from two host threads (`build.chunking`)."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` with `args` and the current stream of
    `device`, with `device` made current for the call and the caller's
    device restored after it; raise if the launch failed."""
    with torch.cuda.device(device):
        err = getattr(library(), entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
