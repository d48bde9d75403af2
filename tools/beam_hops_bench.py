"""Time the beam-hop kernels at `chip_smoke.py` phase 3's main shapes,
each built straight from its sources by nvcc, and hold every build to the
plain version (`beam_hops_ref`) bitwise.

Shapes: ADC B = 64, N = 1M, R = 32, L = 64, M = 16, K = 256, 32 hops;
exact L2 B = 256, N = 1M, R = 32, D = 128, L = 96, 66 hops (the
construction frontier's chunk of 256 build nodes).  A time is the median
of 10 windows of CUDA events around 20 back-to-back calls.

    python3 tools/beam_hops_bench.py [--parent CSRC] [--old-l2 CSRC]
        [--chain] [--split [V,...]] [--knn N] [--out FILE]

--parent CSRC  builds another tree's `beam_hops_adc.cu` and
               `beam_hops_l2.cu` (with the headers beside them) and times
               it against this tree's, in the order parent, this, this,
               parent, in one process.
--old-l2 CSRC  takes an exact-L2 kernel whose loop lives in
               `beam_hops.cuh` (the serial loop before the shared hop loop)
               and builds it four ways: (a) as it is; (b) de-duplication and
               merge ranks skipped (pool slot t stays where t < L - R, and
               candidate t goes to slot L - R + t); (c) scoring replaced by
               a score computed from the id; (bc) both.  The patches are
               text edits of a copy; the sources are not touched.
--chain        times a latency chain: 66 dependent steps of (an adjacency
               row, then its 32 neighbours' 512-byte rows and norms, all in
               flight at once) for 256 rows, one warp a row; the exact-L2
               hop loop's design floor.  Also with no rows (adjacency
               only), for 64 rows, with 36 or 100 KB of (unused) shared
               memory a CTA, and with each row brought in by a bulk copy
               (TMA) into shared memory and summed from there.
--split [V,..] builds this tree's exact-L2 kernel with text patches (all
               of them by default; "a+b" joins two): "nosum" rows staged
               but not summed; "nofetch" neither staged nor summed;
               "probe_first" probe first and stage only the kept
               candidates' rows; "cpasync16" the warp copies each row in
               turn by 16-byte cp.async in place of each lane's bulk copy,
               and on top of it: "ca" cp.async.ca in place of .cg, "ldg"
               each 16 bytes loaded to a register and stored, "ldg32" at
               D = 128 the 32 rows loaded to registers at once, then
               stored, "unroll" the copy loop unrolled whole; "sumloop" the
               sum's loop not unrolled whole for a whole chunk; "nofence"
               no proxy fence before a bulk copy; "pfbest" the best kept
               candidate's adjacency row prefetched into L2 before the
               merge (the ADC kernel timed too); "onebar" one mbarrier a
               warp, armed once by lane 0; "stamps" clock64
               stamps, printed as mean cycles a hop of the phases pick and
               read-back, issue, probe, score, rank, merge ("adjwait" on
               top of it moves the adjacency row's wait into the first
               phase); "carveN" the
               kernel's preferred shared-memory carveout set to N%.
--knn N        also times the exact-L2 builds on the frontier's first
               chunk of 256 nodes over the exact 32-NN graph of N
               SIFT-like points (chip_smoke.py phase 5's graph).

Needs an NVIDIA GPU and nvcc.  Build outputs go to `build/bench/`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.build.pool import pool_merge  # noqa: E402
from repro_torch.core.distances import knn_graph, medoid  # noqa: E402
from repro_torch.data.synthetic import paper_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.beam_fused import beam_hops_ref  # noqa: E402
from repro_torch.kernels.beam_fused.ref import l2_score, sq_norms  # noqa: E402
from repro_torch.kernels.pq_adc import pq_adc_ref  # noqa: E402

OUT = ROOT / "build" / "bench"
SEED = 0
_P, _I = ctypes.c_void_p, ctypes.c_int

CHAIN_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// One warp a row, D = 128: `steps` dependent steps of (adj[v, :] by its 32
// lanes, then the first `rows` of its 32 neighbours' 512-byte rows, all in
// flight at once, lane i taking 16 bytes of each, and their norms); the
// next v depends on every load.
__global__ void chain(const int* __restrict__ adj, const float* __restrict__ x,
                      const float* __restrict__ n2, int n, int steps, int rows,
                      int* out) {
  const int lane = threadIdx.x;
  int v = (int)(((long long)blockIdx.x * 7919) % n);
  for (int s = 0; s < steps; ++s) {
    const int c = __ldg(adj + (size_t)v * 32 + lane);
    const int cc = c < 0 ? v : c;
    float part = __ldg(n2 + cc);
    float4 f[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int id = __shfl_sync(0xffffffffu, cc, j);
      f[j] = j < rows ? __ldg(reinterpret_cast<const float4*>(
                                  x + (size_t)id * 128) + lane)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) part += (f[j].x + f[j].y) + (f[j].z + f[j].w);
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    v = __shfl_sync(0xffffffffu, cc, (__float_as_uint(part) >> 7) & 31);
  }
  if (lane == 0) out[blockIdx.x] = v;
}
// The same chain with each lane's neighbour row brought into shared memory
// by a bulk copy (TMA) on the lane's own mbarrier, as the exact-L2 kernel
// stages its rows, then read back from there.
__device__ __forceinline__ unsigned sa(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__global__ void chain_tma(const int* __restrict__ adj,
                          const float* __restrict__ x,
                          const float* __restrict__ n2, int n, int steps,
                          int* out) {
  __shared__ __align__(16) float rows[32 * 132];
  __shared__ __align__(8) unsigned long long bars[32];
  const int lane = threadIdx.x;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(sa(bars + lane)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  unsigned parity = 0;
  int v = (int)(((long long)blockIdx.x * 7919) % n);
  for (int s = 0; s < steps; ++s) {
    const int c = __ldg(adj + (size_t)v * 32 + lane);
    const int cc = c < 0 ? v : c;
    float part = __ldg(n2 + cc);
    float* row = rows + lane * 132;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 512;\n"
                 :: "r"(sa(bars + lane)) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], 512, [%2];\n"
                 :: "r"(sa(row)), "l"(x + (size_t)cc * 128), "r"(sa(bars + lane))
                 : "memory");
    asm volatile("{\n.reg .pred p;\nWAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra WAIT;\n}\n" :: "r"(sa(bars + lane)), "r"(parity)
                 : "memory");
    parity ^= 1;
#pragma unroll
    for (int i = 0; i < 128; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(row + i);
      part += (f.x + f.y) + (f.z + f.w);
    }
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    v = __shfl_sync(0xffffffffu, cc, (__float_as_uint(part) >> 7) & 31);
  }
  if (lane == 0) out[blockIdx.x] = v;
}
extern "C" int chain_tma_launch(const int* adj, const float* x,
                                const float* n2, int n, int steps, int* out,
                                int b, void* stream) {
  chain_tma<<<b, 32, 0, (cudaStream_t)stream>>>(adj, x, n2, n, steps, out);
  return (int)cudaGetLastError();
}
extern "C" int chain_launch(const int* adj, const float* x, const float* n2,
                            int n, int steps, int rows, int* out, int b,
                            int smem, void* stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  chain<<<b, 32, smem, (cudaStream_t)stream>>>(adj, x, n2, n, steps, rows,
                                               out);
  return (int)cudaGetLastError();
}
"""

# (b): the serial de-duplication and both merge-rank loops of the old loop
# skipped; (c): L2Score returns a score computed from the id
_OLD_PATCHES = {
    "beam_hops.cuh": [
        ("      for (int i = 0; keep && i < l; ++i) keep = ids[i] != c;\n"
         "      for (int i = 0; keep && i < t; ++i) keep = s_cid[i] != c;\n",
         "#if !(MODE & 1)\n"
         "      for (int i = 0; keep && i < l; ++i) keep = ids[i] != c;\n"
         "      for (int i = 0; keep && i < t; ++i) keep = s_cid[i] != c;\n"
         "#endif\n"),
        ("      int pos = t;\n"
         "      for (int i = 0; i < r; ++i) pos += lex_lt(s_cd[i], "
         "rank_key(s_cid[i]), pd, pk);\n",
         "      int pos = t;\n"
         "#if MODE & 1\n"
         "      pos = t < l - r ? t : l;\n"
         "#else\n"
         "      for (int i = 0; i < r; ++i) pos += lex_lt(s_cd[i], "
         "rank_key(s_cid[i]), pd, pk);\n"
         "#endif\n"),
        ("      int pos = 0;\n"
         "      for (int i = 0; i < l; ++i) pos += !lex_lt(cd, ck, d[i], "
         "rank_key(ids[i]));\n",
         "      int pos = 0;\n"
         "#if MODE & 1\n"
         "      pos = l - r + t;\n"
         "      if (0)\n"
         "#endif\n"
         "      for (int i = 0; i < l; ++i) pos += !lex_lt(cd, ck, d[i], "
         "rank_key(ids[i]));\n"
         "#if MODE & 1\n"
         "      if (0)\n"
         "#endif\n"),
    ],
    "beam_hops_l2.cu": [
        ("    const float* xv = x + (size_t)c * d;\n",
         "#if MODE & 2\n"
         "    return (float)(((unsigned)c * 2654435761u) >> 12);\n"
         "#endif\n"
         "    const float* xv = x + (size_t)c * d;\n"),
    ],
}


def _carveout(pct: int) -> dict:
    """The exact-L2 kernel's preferred shared-memory carveout set to pct%."""
    return {"beam_hops_l2.cu": [
        ("  if (err != cudaSuccess) return (int)err;\n"
         "  const beam::Outputs out{",
         "  if (err != cudaSuccess) return (int)err;\n"
         "  cudaFuncSetAttribute((const void*)beam_hops_l2_kernel,\n"
         f"      cudaFuncAttributePreferredSharedMemoryCarveout, {pct});\n"
         "  const beam::Outputs out{")]}


# this tree's exact-L2 kernel taken apart or changed, by text patches (see
# --split); "ca", "ldg", "ldg32" and "unroll" apply on top of "cpasync16"
_SPLIT_PATCHES = {
    "nosum": {"beam_hops_l2.cu": [
        ("      if (c < 0) continue;   // no row staged\n",
         "      continue;\n")]},
    "nofetch": {"beam_hops_l2.cu": [
        ("      if (c < 0) continue;   // no row staged\n",
         "      continue;\n"),
        ("      if (c >= 0)\n        bulk_copy(", "      if (false)\n        bulk_copy("),
        ("        if (c >= 0) {\n          bar_wait(", "        if (false) {\n          bar_wait(")]},
    # the warp's 32 lanes copy each candidate's row in turn by 16-byte
    # cp.async (its id by shuffle), in place of each lane's bulk copy
    "cpasync16": {"beam_hops_l2.cu": [
        ("    if (vec) {   // the same in every thread\n"
         "      if (c >= 0)\n"
         "        bulk_copy(rows + lane * stride, x + (size_t)c * d + c0, n * 4, bar);\n"
         "      return;\n"
         "    }\n"
         "    for (int j = 0; j < 32; ++j) {\n",
         "#pragma unroll 4\n"
         "    for (int j = 0; j < 32; ++j) {\n"),
        ("        for (int i = lane; i < n; i += 32) beam::cp_async4(dst + i, src + i);\n",
         "        if (vec)\n"
         "          for (int i = 4 * lane; i < n; i += 128)\n"
         "            beam::cp_async16(dst + i, src + i);\n"
         "        else\n"
         "          for (int i = lane; i < n; i += 32) beam::cp_async4(dst + i, src + i);\n"),
        ("      if (vec) {\n        if (c >= 0) {\n          bar_wait(",
         "      if (false) {\n        if (c >= 0) {\n          bar_wait(")]},
    "ca": {"beam_loop.cuh": [
        ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"',
         'asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\\n"')]},
    "ldg": {"beam_hops_l2.cu": [
        ("            beam::cp_async16(dst + i, src + i);\n",
         "            *reinterpret_cast<float4*>(dst + i) =\n"
         "                __ldg(reinterpret_cast<const float4*>(src + i));\n")]},
    "ldg32": {"beam_hops_l2.cu": [
        ("    const int lane = threadIdx.x & 31;\n#pragma unroll 4\n",
         "    const int lane = threadIdx.x & 31;\n"
         "    if (vec && n == 128) {\n"
         "      float4 f[32];\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < 32; ++j) {\n"
         "        const int id = __shfl_sync(beam::kFull, c, j);\n"
         "        f[j] = id >= 0 ? __ldg(reinterpret_cast<const float4*>(\n"
         "                             x + (size_t)id * d + c0) + lane)\n"
         "                       : make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "      }\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < 32; ++j)\n"
         "        *reinterpret_cast<float4*>(rows + j * stride + 4 * lane) = "
         "f[j];\n"
         "      return;\n"
         "    }\n"
         "#pragma unroll 4\n")]},
    "sumloop": {"beam_hops_l2.cu": [
        ("        dot = n == kChunk ? dot4(dot, row, qc, kChunk) : dot4(dot, row, qc, n);\n",
         "        dot = dot4(dot, row, qc, n);\n")]},
    "unroll": {"beam_hops_l2.cu": [
        ("    const int lane = threadIdx.x & 31;\n#pragma unroll 4\n",
         "    const int lane = threadIdx.x & 31;\n#pragma unroll\n")]},
    # clock64 stamps: mean cycles a hop of each phase, written over the
    # first 6 trace dists of each row after the loop
    "stamps": {"beam_loop.cuh": [
        ("  int cur = 0, h = 0;\n",
         "  int cur = 0, h = 0;\n  long long acc[6] = {0, 0, 0, 0, 0, 0};\n"),
        ("    const Entry pick = pool[j];\n",
         "    const Entry pick = pool[j];\n    long long s0 = clock64();\n"),
        ("    const typename Scorer::Issued issued = sc.issue(c);\n",
         "    long long s1 = clock64();\n"
         "    const typename Scorer::Issued issued = sc.issue(c);\n"
         "    long long s2 = clock64();\n"),
        ("    keep &= __ffs(same) - 1 == lane;\n",
         "    keep &= __ffs(same) - 1 == lane;\n    long long s3 = clock64();\n"),
        ("    Entry ce = keep ? Entry{dist, c} : none();\n",
         "    Entry ce = keep ? Entry{dist, c} : none();\n"
         "    long long s4 = clock64();\n"),
        ("    // merge by merge path:",
         "    long long s5 = clock64();\n    // merge by merge path:"),
        ("    jn = block_min(best, s_next + 1 - cur, nt, lane);\n",
         "    jn = block_min(best, s_next + 1 - cur, nt, lane);\n"
         "    long long s6 = clock64();\n"
         "    acc[0] += s1 - s0; acc[1] += s2 - s1; acc[2] += s3 - s2;\n"
         "    acc[3] += s4 - s3; acc[4] += s5 - s4; acc[5] += s6 - s5;\n"),
        ("  if (t == 0) {\n    out.hops[b] = h;\n",
         "  if (t == 0) {\n"
         "    for (int k = 0; k < 6 && k < max_hops; ++k)\n"
         "      out.trace_d[(size_t)b * max_hops + k] = (float)acc[k] / max(h, 1);\n"
         "    out.hops[b] = h;\n")]},
    # one mbarrier a warp: lane 0 announces the warp's bytes in one
    # arrival, then each lane issues its copy; every lane waits on it
    "onebar": {"beam_hops_l2.cu": [
        ("    if (vec) {   // the same in every thread\n"
         "      if (c >= 0)\n"
         "        bulk_copy(rows + lane * stride, x + (size_t)c * d + c0, n * 4, bar);\n"
         "      return;\n"
         "    }\n",
         "    if (vec) {   // the same in every thread\n"
         "      const unsigned all = __popc(__ballot_sync(beam::kFull, c >= 0)) * n * 4;\n"
         "      uint64_t* wbar = bar - lane;\n"
         "      if (lane == 0) {\n"
         "        if (all) asm volatile(\"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n\"\n"
         "                              :: \"r\"(smem_addr(wbar)), \"r\"(all) : \"memory\");\n"
         "        else asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\"\n"
         "                          :: \"r\"(smem_addr(wbar)) : \"memory\");\n"
         "      }\n"
         "      __syncwarp();\n"
         "      if (c >= 0) {\n"
         "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
         "        asm volatile(\"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes \"\n"
         "                     \"[%0], [%1], %2, [%3];\\n\" :: \"r\"(smem_addr(rows + lane * stride)),\n"
         "                     \"l\"(x + (size_t)c * d + c0), \"r\"(n * 4), \"r\"(smem_addr(wbar)) : \"memory\");\n"
         "      }\n"
         "      return;\n"
         "    }\n"),
        ("        if (c >= 0) {\n          bar_wait(bar, parity);\n",
         "        if (true) {\n          bar_wait(bar - (threadIdx.x & 31), parity);\n")]},
    # on top of "stamps": the adjacency row's wait moved out of the issue
    # phase into the first (pick, read-back and adjacency wait)
    "adjwait": {"beam_loop.cuh": [
        ("    long long s1 = clock64();\n",
         "    if (c == -2) asm volatile(\"trap;\");\n"
         "    long long s1 = clock64();\n")]},
    # the adjacency row of the best kept candidate, the likely next pick,
    # brought into L2 before the merge
    "pfbest": {"beam_loop.cuh": [
        ("    // merge by merge path:",
         "    if (nb > 0 && 32 * lane < r)\n"
         "      asm volatile(\"prefetch.global.L2 [%0];\\n\"\n"
         "                   :: \"l\"(adj + (size_t)cs[0].key * r + 32 * lane));\n"
         "    // merge by merge path:")]},
    "nofence": {"beam_hops_l2.cu": [
        ('  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n',
         "")]},
    **{f"carve{pct}": _carveout(pct) for pct in (25, 44, 100)},
    "probe_first": {"beam_loop.cuh": [
        ("    const typename Scorer::Issued issued = sc.issue(c);\n"
         "    bool keep = false;\n", "    bool keep = false;\n"),
        ("    keep &= __ffs(same) - 1 == lane;\n",
         "    keep &= __ffs(same) - 1 == lane;\n"
         "    const typename Scorer::Issued issued = sc.issue(keep ? c : -1);\n"
         ),
        ("    const float dist = sc.score(c, keep, issued);",
         "    const float dist = sc.score(keep ? c : -1, keep, issued);")]},
}


def patched_copy(src_dir: Path, patches: dict, name: str) -> Path:
    """A copy of src_dir's sources under build/bench/<name>, with `patches`
    (file -> [(old, new)]) applied; every anchor must occur once."""
    dst = OUT / name
    dst.mkdir(parents=True, exist_ok=True)
    for src in src_dir.glob("*.cu*"):
        text = src.read_text()
        for old, new in patches.get(src.name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"patch anchor not found once in "
                                   f"{src.name}: {old!r}")
            text = text.replace(old, new)
        (dst / src.name).write_text(text)
    return dst


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


def random_graph(n, r, gen, dev):
    adj = torch.randint(0, n, (n, r), dtype=torch.int32, device=dev,
                        generator=gen)
    adj[torch.rand((n, r), device=dev, generator=gen) < 0.1] = -1
    return adj


def empty_pool(b, l, dev):
    return (torch.full((b, l), -1, dtype=torch.int32, device=dev),
            torch.full((b, l), torch.inf, device=dev),
            torch.zeros((b, l), dtype=torch.bool, device=dev))


def adc_case(dev, gen):
    b, n, r, m, k, l, hops = 64, 1_000_000, 32, 16, 256, 64, 32
    adj = random_graph(n, r, gen, dev)
    codes = torch.randint(0, k, (n, m), dtype=torch.uint8, device=dev,
                          generator=gen)
    tables = torch.rand((b, m, k), device=dev, generator=gen) * 16
    cands = torch.linspace(0, n - 1, 256, device=dev).long()
    sd, si = torch.sort(pq_adc_ref(tables, codes[cands]), dim=1, stable=True)
    pool = pool_merge(*empty_pool(b, l, dev), cands[si[:, :4]].int(),
                      sd[:, :4], l)
    return dict(adj=adj, codes=codes, tables=tables, pool=pool, hops=hops)


def l2_case(dev, gen, knn_n=0):
    """The main shape on a random graph of 1M nodes, or (knn_n > 0) the
    frontier's first chunk on the exact 32-NN graph of knn_n SIFT-like
    points, as phase 5 of chip_smoke.py builds it."""
    b, n, r, d, l, hops = 256, 1_000_000, 32, 128, 96, 66
    if knn_n:
        ds = paper_dataset("sift-like", n=knn_n, nq=1, seed=SEED, device=dev)
        x = torch.from_numpy(ds.base).to(dev)
        adj = knn_graph(x, r).to(torch.int32).contiguous()
        q = x[:b].contiguous()
    else:
        adj = random_graph(n, r, gen, dev)
        x = torch.randn((n, d), device=dev, generator=gen)
        q = x[torch.randperm(n, device=dev, generator=gen)[:b]].contiguous()
    seeds = torch.full((b, 1), medoid(x), dtype=torch.int32, device=dev)
    pool = pool_merge(*empty_pool(b, l, dev), seeds,
                      l2_score(x, sq_norms(x), q, sq_norms(q), seeds), l)
    return dict(adj=adj, x=x, n2=sq_norms(x), q=q, pool=pool, hops=hops)


def outputs(b, l, hops, dev):
    i32, f32 = torch.int32, torch.float32
    return (torch.empty((b, l), dtype=i32, device=dev),
            torch.empty((b, l), dtype=f32, device=dev),
            torch.empty((b, l), dtype=torch.bool, device=dev),
            torch.empty(b, dtype=i32, device=dev),
            torch.empty((b, hops), dtype=i32, device=dev),
            torch.empty((b, hops), dtype=f32, device=dev),
            torch.empty(b, dtype=i32, device=dev),
            torch.empty(b, dtype=torch.bool, device=dev))


def adc_call(lib, c):
    fn = lib.beam_hops_adc_launch
    fn.restype, fn.argtypes = _I, [_P] * 14 + [_I] * 6 + [_P]
    b, l = c["pool"][0].shape
    n, r = c["adj"].shape
    _, m, k = c["tables"].shape
    size = lib.beam_hops_adc_smem_bytes
    size.restype, size.argtypes = ctypes.c_size_t, [_I] * 4
    if size(l, r, m, k) > _build.MAX_SMEM_BYTES:
        raise RuntimeError("ADC shape exceeds shared memory")
    out = outputs(b, l, c["hops"], c["adj"].device)
    args = (c["adj"].data_ptr(), c["codes"].data_ptr(), c["tables"].data_ptr(),
            *(t.data_ptr() for t in c["pool"]),
            *(o.data_ptr() for o in out), b, l, r, m, k, c["hops"])

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ADC launch failed: {err}")
        return out
    return call


def l2_call(lib, c):
    fn = lib.beam_hops_l2_launch
    fn.restype, fn.argtypes = _I, [_P] * 16 + [_I] * 5 + [_P]
    b, l = c["pool"][0].shape
    n, r = c["adj"].shape
    d = c["x"].shape[1]
    qn = sq_norms(c["q"])
    out = outputs(b, l, c["hops"], c["adj"].device)
    args = (c["adj"].data_ptr(), c["x"].data_ptr(), c["n2"].data_ptr(),
            c["q"].data_ptr(), qn.data_ptr(),
            *(t.data_ptr() for t in c["pool"]),
            *(o.data_ptr() for o in out), b, l, r, d, c["hops"])

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"L2 launch failed: {err}")
        return out
    return call


def bitwise(call, want) -> bool:
    got = call()
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--old-l2", type=Path)
    ap.add_argument("--chain", action="store_true")
    ap.add_argument("--split", nargs="?", const=",".join(_SPLIT_PATCHES),
                    default="")
    ap.add_argument("--knn", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("beam_hops_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"card": nvidia_smi(), "ms": {}, "bitwise": {}, "ptxas": {}}
    print("card:", res["card"], flush=True)

    here = ROOT / "src" / "repro_torch" / "csrc"
    libs = {"this": ([here / "beam_hops_adc.cu", here / "beam_hops_l2.cu"],
                     here, [])}
    if args.parent:
        libs["parent"] = ([args.parent / "beam_hops_adc.cu",
                           args.parent / "beam_hops_l2.cu"], args.parent, [])
    if args.old_l2:
        patched = OUT / "old_l2"
        patched.mkdir(parents=True, exist_ok=True)
        for src in args.old_l2.glob("*.cu*"):
            text = src.read_text()
            for old, new in _OLD_PATCHES.get(src.name, []):
                if text.count(old) != 1:
                    raise RuntimeError(f"patch anchor not found once in "
                                       f"{src.name}: {old!r}")
                text = text.replace(old, new)
            (patched / src.name).write_text(text)
        for name, mode in (("old_a", 0), ("old_b", 1), ("old_c", 2),
                           ("old_bc", 3)):
            libs[name] = ([patched / "beam_hops_l2.cu"], patched,
                          [f"-DMODE={mode}"])
    for name in filter(None, args.split.split(",")):
        for one in name.split("+"):
            if one not in _SPLIT_PATCHES:
                raise SystemExit(f"unknown variant {one!r}")
        patches = {}
        for one in name.split("+"):
            for f, ps in _SPLIT_PATCHES[one].items():
                patches.setdefault(f, []).extend(ps)
        d = patched_copy(here, patches, name)
        libs[name] = ([d / "beam_hops_adc.cu", d / "beam_hops_l2.cu"], d, [])
    if args.chain:
        (OUT / "chain.cu").parent.mkdir(parents=True, exist_ok=True)
        (OUT / "chain.cu").write_text(CHAIN_CU)
        libs["chain"] = ([OUT / "chain.cu"], OUT, [])
    built = build(libs)
    for name, (_, ptxas) in built.items():
        res["ptxas"][name] = ptxas
        for line in ptxas:
            print(f"  ptxas {name}: {line}")

    adc = adc_case(dev, gen)
    want = beam_hops_ref(adc["adj"], *adc["pool"], adc["hops"],
                         tables=adc["tables"], codes=adc["codes"])
    order = (["parent", "this", "this", "parent"] if args.parent
             else ["this"])
    split = [k for k in built if k not in ("this", "parent", "chain")
             and not k.startswith("old_")]
    on_loop = [k for k in split if any("beam_loop.cuh" in _SPLIT_PATCHES[v]
                                       for v in k.split("+"))]
    for side in order + on_loop:   # the variants that move the ADC kernel
        call = adc_call(built[side][0], adc)
        if "stamps" not in side:
            res["bitwise"][f"adc_{side}"] = bitwise(call, want)
        ms = median_ms(call)
        res["ms"].setdefault(f"adc_{side}", []).append(ms)
        print(f"adc {side}: {ms:.5f} ms, bitwise "
              f"{res['bitwise'].get(f'adc_{side}')}", flush=True)
    del adc, want

    l2_cases = {"l2": l2_case(dev, gen)}
    if args.knn:
        l2_cases["knn"] = l2_case(dev, gen, args.knn)
    for tag, l2 in l2_cases.items():
        want = beam_hops_ref(l2["adj"], *l2["pool"], l2["hops"], x=l2["x"],
                             n2=l2["n2"], queries=l2["q"])
        res[f"{tag}_hops"] = total = int(want[3].sum())
        b = want[3].numel()
        for side in order + [k for k in built if k not in
                             ("this", "parent", "chain")]:
            call = l2_call(built[side][0], l2)
            if not any(v in side for v in ("nosum", "nofetch", "stamps")) \
                    and side not in ("old_b", "old_c", "old_bc"):
                res["bitwise"][f"{tag}_{side}"] = bitwise(call, want)
            ms = median_ms(call)
            res["ms"].setdefault(f"{tag}_{side}", []).append(ms)
            if "stamps" in side:   # pick+read-back, issue, probe, score,
                got = call()       # rank, merge: cycles a hop
                cyc = got[5][:, :6].mean(0).tolist()
                res[f"{tag}_{side}_cycles"] = cyc
                print(f"{tag} {side} cycles a hop: "
                      + " ".join(f"{v:.0f}" for v in cyc), flush=True)
            print(f"{tag} {side}: {ms:.5f} ms ({ms * 1e3 * b / total:.3f} us a "
                  f"hop), bitwise {res['bitwise'].get(f'{tag}_{side}')}",
                  flush=True)
    l2 = l2_cases["l2"]
    if "chain" in built:
        fn = built["chain"][0].chain_launch
        fn.restype, fn.argtypes = _I, [_P] * 3 + [_I] * 3 + [_P, _I, _I, _P]
        n, d = l2["x"].shape
        if d != 128:
            raise RuntimeError("the chain kernels read 128-float rows")
        out = torch.empty(256, dtype=torch.int32, device=dev)

        def chain(steps, rows, b, smem):
            def call():
                err = fn(l2["adj"].data_ptr(), l2["x"].data_ptr(),
                         l2["n2"].data_ptr(), n, steps, rows, out.data_ptr(),
                         b, smem, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"chain launch failed: {err}")
            return call
        hops = l2["hops"]
        for steps, rows, b, smem in ((0, 32, 256, 0), (hops, 32, 256, 0),
                                     (hops, 0, 256, 0), (hops, 32, 64, 0),
                                     (hops, 32, 256, 36 * 1024),
                                     (hops, 32, 256, 100 * 1024)):
            ms = median_ms(chain(steps, rows, b, smem))
            res["ms"][f"chain_{steps}_rows{rows}_b{b}_smem{smem}"] = [ms]
            print(f"chain {steps} steps, {rows} rows a step, B={b}, "
                  f"{smem} bytes of shared memory a CTA: {ms:.5f} ms",
                  flush=True)
        tma = built["chain"][0].chain_tma_launch
        tma.restype, tma.argtypes = _I, [_P] * 3 + [_I] * 2 + [_P, _I, _P]
        for steps in (0, hops):
            def call():
                err = tma(l2["adj"].data_ptr(), l2["x"].data_ptr(),
                          l2["n2"].data_ptr(), n, steps, out.data_ptr(), 256,
                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"chain launch failed: {err}")
            ms = median_ms(call)
            res["ms"][f"chain_tma_{steps}"] = [ms]
            print(f"chain by bulk copies, {steps} steps, 32 rows a step, "
                  f"B=256: {ms:.5f} ms", flush=True)
    print(json.dumps(res), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0 if all(res["bitwise"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
