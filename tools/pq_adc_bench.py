"""Time the PQ ADC kernels (`csrc/pq_adc.cu`) at `chip_smoke.py` phase 3's
shapes, each built straight from its sources by nvcc, and hold every build
to the plain versions (`pq_adc_ref`, `pq_adc_rowwise_ref`) bitwise.

Shapes: entry scoring, `pq_adc` at B = 64, E = 256, M = 16, K = 256; hop
scoring, `pq_adc_rowwise` at B = 64, R = 32, M = 16, K = 256; and `pq_adc`
at B = 3, N = 70,000, M = 16 (phase 3's large-N case).  A time ("ms") is
the median of 10 windows of CUDA events around 20 back-to-back calls;
"device" is torch.profiler's kernel time a call.

    python3 tools/pq_adc_bench.py [--parent CSRC] [--split [V,...]]
        [--floor] [--host] [--sweep] [--out FILE]

--parent CSRC  builds another tree's `pq_adc.cu` (with the headers beside
               it) and times it against this tree's, in the order parent,
               this, this, parent, in one process.
--split [V,..] text-patched builds (all by default).  Of the --parent
               tree's kernel in its first design (one block stages a
               query's table in shared memory, a thread reads its codes a
               byte at a time), by -DMODE: "a" as shipped; "b" no staging, the
               table read from global memory in the same order; "c" each
               code row read by one 16-byte load; "d" M fixed at 16 at
               compile time; "e" b, c and d together (these assume M = 16
               and 16-byte aligned rows, as at these shapes).  Of this
               tree's kernel: "ldcg" table loads cached in L2 only; not
               bitwise: "nolut" no table loads (an estimate sums its
               codes); "nocodes" no code load (codes made from the row's
               address; K = 256 only).
--floor        an empty kernel (`pq_adc_floor_launch`) at each shape's
               planned geometry, at one block of it, and at the first
               design's grids.
--host         the wrapper's host time a call (time.perf_counter over
               2,000 calls, median of 5 windows), split: as it is; with the
               ctypes call replaced by a no-op; `_build.launch` alone; the
               ctypes call alone.
--sweep        both forms of this tree's kernels, forced, at B = 3 and 64
               over N from 256 to 131,072 (and R = 32 and 256 rowwise):
               the gather form in blocks of 32, 64, 128 and 256 threads,
               the staged form at 1, 2 and 4 CTAs an SM; the measurements
               behind `plan`'s cut and block sizes.

Needs an NVIDIA GPU and nvcc.  Build outputs go to `build/bench_adc/`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pq_adc import (pq_adc_ref,  # noqa: E402
                                        pq_adc_rowwise_ref)
from repro_torch.kernels.pq_adc.ops import (FORMS, Plan,  # noqa: E402
                                            pq_adc, pq_adc_rowwise, plan,
                                            staged_plan)

OUT = ROOT / "build" / "bench_adc"
SEED = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
SHAPES = {"entry": (64, 256, 16, 256, False),      # b, n or r, m, k, rowwise
          "hop": (64, 32, 16, 256, True),
          "large": (3, 70_000, 16, 256, False)}

# The first design's kernel taken apart by -DMODE bits: 1 no staging,
# 2 one 16-byte code load, 4 M fixed at 16; (old, new, occurrences)
_SPLIT_PATCHES = [
    ("  stage_table(s_tab, tables + (size_t)b * m * k, m * k);\n"
     "  __syncthreads();\n",
     "#if MODE & 1\n"
     "  const float* src = tables + (size_t)b * m * k;\n"
     "#else\n"
     "  stage_table(s_tab, tables + (size_t)b * m * k, m * k);\n"
     "  __syncthreads();\n"
     "  const float* src = s_tab;\n"
     "#endif\n", 2),
    ("adc_sum(s_tab, ", "adc_sum(src, ", 2),
    ("  float acc = 0.f;\n"
     "  for (int j = 0; j < m; ++j) acc += s_tab[j * k + c[j]];\n",
     "#if MODE & 4\n"
     "  constexpr int mm = 16;\n"
     "#else\n"
     "  const int mm = m;\n"
     "#endif\n"
     "#if MODE & 2\n"
     "  const uint4 u = __ldg(reinterpret_cast<const uint4*>(c));\n"
     "#define CODE(j) ((((j) < 4 ? u.x : (j) < 8 ? u.y : (j) < 12 ? u.z : u.w)"
     " >> (8 * ((j) & 3))) & 0xffu)\n"
     "#else\n"
     "#define CODE(j) c[j]\n"
     "#endif\n"
     "  float acc = 0.f;\n"
     "  for (int j = 0; j < mm; ++j) acc += s_tab[j * k + CODE(j)];\n"
     "#undef CODE\n", 1),
]
SPLIT_MODES = {"a": 0, "b": 1, "c": 2, "d": 4, "e": 7}
# this design taken apart (not bitwise): "nolut" codes loaded, no table
# loads (an estimate sums its codes); "nocodes" no code load (codes made
# from the row's address: in bounds for K = 256 only); and changed
# (bitwise): "ldcg" table loads cached in L2 only, not in L1
_LUT_LOAD = "    v[j] = kL2 ? __ldg(tab + j * k + c[j]) : tab[j * k + c[j]];\n"
_THIS_PATCHES = {
    "nolut": [(_LUT_LOAD, "    v[j] = (float)c[j];\n", 1)],
    "ldcg": [(_LUT_LOAD, _LUT_LOAD.replace("__ldg", "__ldcg"), 1)],
    "nocodes": [("  c.load(p);\n",
                 "  for (auto& x : c.w)\n"
                 "    x = ((uint32_t)reinterpret_cast<uintptr_t>(p)"
                 " * 2654435761u) & (V == 1 ? 0xffu : 0xffffffffu);\n", 1)],
}


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(libs: dict) -> dict:
    """libs: name -> (list of .cu, include dir, extra flags); all nvcc
    processes run at once.  Returns name -> (CDLL, ptxas lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (srcs, inc, extra) in libs.items():
        so = OUT / f"lib_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *extra,
             "-I", str(inc), "-o", str(so), *map(str, srcs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas = [ln.strip().removeprefix("ptxas info    : ")
                 for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        out[name] = (ctypes.CDLL(str(so)), ptxas)
    return out


def split_copy(src_dir: Path, patches: list, name: str) -> Path:
    """src_dir's sources under build/bench_adc/<name>, `pq_adc.cu` with
    `patches` ((old, new, occurrences)) applied."""
    dst = OUT / name
    dst.mkdir(parents=True, exist_ok=True)
    for src in src_dir.glob("*.cu*"):
        text = src.read_text()
        if src.name == "pq_adc.cu":
            for old, new, count in patches:
                if text.count(old) != count:
                    raise RuntimeError(f"patch anchor not found {count} "
                                       f"times in pq_adc.cu: {old!r}")
                text = text.replace(old, new)
        (dst / src.name).write_text(text)
    return dst


def median_ms(fn, calls=20, windows=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)


def device_ms(fn, calls=20) -> float | None:
    """The card's kernel time a call, from the profiler's CUDA activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(a.self_device_time_total for a in prof.key_averages())
    return us / 1e3 / calls if us > 0 else None


def host_us(fn, calls=2000, windows=5) -> float:
    """Median host µs a call over `windows` windows, the card synced at
    each window's end."""
    fn()
    torch.cuda.synchronize()
    per = calls // windows
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / per * 1e6)
    return statistics.median(times)


def case(shape, dev, gen):
    b, n, m, k, rowwise = shape
    tables = torch.rand((b, m, k), device=dev, generator=gen) * 16
    codes = torch.randint(0, k, (b, n, m) if rowwise else (n, m),
                          dtype=torch.uint8, device=dev, generator=gen)
    want = (pq_adc_rowwise_ref if rowwise else pq_adc_ref)(tables, codes)
    return tables, codes, want


def is_planned(lib) -> bool:
    """A library built from this design's source, whose entry points take
    the geometry `plan` chose; the first design's took none (the kernel
    picked its own grid)."""
    return hasattr(lib, "pq_adc_floor_launch")


def adc_call(lib, tables, codes, rowwise, p=None):
    """A call of the library's entry point on fixed inputs and output; p
    is a `Plan` (the wrapper's when None) for this design's entry points."""
    name = "pq_adc_rowwise_launch" if rowwise else "pq_adc_launch"
    fn = getattr(lib, name)
    b, m, k = tables.shape
    n = codes.shape[-2]
    out = torch.empty((b, n), device=tables.device)
    args = (tables.data_ptr(), codes.data_ptr(), out.data_ptr(), b, n, m, k)
    if is_planned(lib):
        fn.restype, fn.argtypes = _build._SIGNATURES[name]
        p = p or plan(b, n, m, k, codes.data_ptr())
        args += (FORMS.index(p.form), p.vec, *p.grid, p.threads)
    else:
        fn.restype, fn.argtypes = _I, [_P] * 3 + [_I] * 4 + [_P]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} failed: CUDA error {err}")
        return out
    return call


def floor_call(lib, grid, threads, smem):
    fn = lib.pq_adc_floor_launch
    fn.restype, fn.argtypes = _build._SIGNATURES["pq_adc_floor_launch"]

    def call():
        err = fn(*grid, threads, smem, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"floor launch failed: CUDA error {err}")
    return call


def timed(call):
    return {"ms": median_ms(call), "device": device_ms(call)}


def fmt(t) -> str:
    dev = "not seen" if t["device"] is None else f"{t['device']:.5f}"
    return f"{t['ms']:.5f} ms (device {dev})"


class _NoOpLibrary:
    """Stands in for the kernels' library: every entry point returns 0."""
    def __getattr__(self, attr):
        return lambda *a: 0


def host_split(dev, gen) -> dict:
    """The wrapper's host µs a call, split (see --host)."""
    res = {}
    for tag in ("entry", "hop"):
        tables, codes, _ = case(SHAPES[tag], dev, gen)
        wrapper = pq_adc_rowwise if SHAPES[tag][4] else pq_adc
        seen = []
        launch, library = _build.launch, _build.library
        _build.launch = lambda *a: seen.append(a) or launch(*a)
        try:
            wrapper(tables, codes)
        finally:
            _build.launch = launch
        name, entry, d, *args = seen[0]
        fn = getattr(_build.library(), entry)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {"wrapper": host_us(lambda: wrapper(tables, codes)),
               "launch": host_us(lambda: _build.launch(name, entry, d, *args)),
               "ctypes": host_us(lambda: fn(*args, stream))}
        _build.library = _NoOpLibrary
        try:
            row["wrapper_noop_ctypes"] = host_us(
                lambda: wrapper(tables, codes))
        finally:
            _build.library = library
        res[tag] = row
        print(f"host µs a call, {tag}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in row.items()), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--split", nargs="?",
                    const=",".join([*SPLIT_MODES, *_THIS_PATCHES]), default="")
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pq_adc_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    split = [v for v in args.split.split(",") if v]
    for v in split:
        if v not in SPLIT_MODES and v not in _THIS_PATCHES:
            raise SystemExit(f"unknown variant {v!r}")
        if v in SPLIT_MODES and not args.parent:
            raise SystemExit(f"--split {v} patches the --parent tree's "
                             f"first-design kernel")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"card": nvidia_smi(), "ms": {}, "device": {}, "bitwise": {},
           "ptxas": {}}
    print("card:", res["card"], flush=True)

    here = ROOT / "src" / "repro_torch" / "csrc"
    libs = {"this": ([here / "pq_adc.cu"], here, [])}
    if args.parent:
        libs["parent"] = ([args.parent / "pq_adc.cu"], args.parent, [])
    for v in split:
        if v in SPLIT_MODES:
            d = split_copy(args.parent, _SPLIT_PATCHES, "split")
            libs[f"split_{v}"] = ([d / "pq_adc.cu"], d,
                                  [f"-DMODE={SPLIT_MODES[v]}"])
        else:
            d = split_copy(here, _THIS_PATCHES[v], v)
            libs[f"split_{v}"] = ([d / "pq_adc.cu"], d, [])
    built = build(libs)
    for name, (_, ptxas) in built.items():
        res["ptxas"][name] = ptxas
        for line in ptxas:
            print(f"  ptxas {name}: {line}")
    this = built["this"][0]

    def record(key, call, want=None):
        if want is not None:
            got = call()
            torch.cuda.synchronize()
            res["bitwise"][key] = torch.equal(got, want)
        t = timed(call)
        res["ms"].setdefault(key, []).append(t["ms"])
        res["device"].setdefault(key, []).append(t["device"])
        print(f"{key}: {fmt(t)}, bitwise {res['bitwise'].get(key)}",
              flush=True)

    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    for tag, shape in SHAPES.items():
        tables, codes, want = case(shape, dev, gen)
        rowwise = shape[4]
        p = plan(*shape[:4], codes.data_ptr())
        res[f"plan_{tag}"] = repr(p)
        print(f"{tag} plan: {p}", flush=True)
        for side in order + [f"split_{v}" for v in split]:
            exact = side.removeprefix("split_") not in ("nolut", "nocodes")
            record(f"{tag}_{side}", adc_call(built[side][0], tables, codes,
                                             rowwise), want if exact else None)
        if args.floor:
            b, n = shape[:2]
            old = ((b, 1) if rowwise
                   else (b, min(65535, max(1, -(-n // 256)))), 256,
                   shape[2] * shape[3] * 4)
            for key, (grid, threads, smem) in (
                    ("floor", (p.grid, p.threads, p.smem)),
                    ("floor_one_block", ((1, 1), p.threads, p.smem)),
                    ("floor_first_grid", old)):
                record(f"{tag}_{key}", floor_call(this, grid, threads, smem))
        del tables, codes, want

    if args.sweep:
        sweep = [(b, n, False) for b in (3, 64)
                 for n in (256, 1024, 4096, 16384, 70_000, 131_072)]
        sweep += [(64, r, True) for r in (32, 256)]
        for b, n, rowwise in sweep:
            tables, codes, want = case((b, n, 16, 256, rowwise), dev, gen)
            forms = {f"gather{t}": Plan("gather", (-(-b * n // t), 1), t, 0,
                                        16) for t in (32, 64, 128, 256)}
            for per_sm in (1, 2, 4):
                forms[f"staged{per_sm}"] = staged_plan(b, n, 16, 256, 16,
                                                       per_sm * 132)
            for form, p in forms.items():
                key = f"sweep_B{b}_{'R' if rowwise else 'N'}{n}_{form}"
                record(key, adc_call(this, tables, codes, rowwise, p), want)
                if form.startswith("staged"):   # rows a block / K
                    res[f"{key}_lookups_per_staged_entry"] = \
                        -(-n // p.grid[1]) / 256
            del tables, codes, want

    if args.host:
        res["host_us"] = host_split(dev, gen)
    print(json.dumps(res), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0 if all(res["bitwise"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
