// Exact squared-L2 top-k of each query against a shared base, for Hopper
// (sm_90a): tiled in-order distances and an exact radix select.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/l2_topk/kernel.py:67
//   l2_topk_pallas  (body _l2_topk_kernel, kernel.py:22)
// queries (B, D) f32, base (N, D) f32 -> for each query the k smallest
//     d(b, n) = max((|q|^2 + |x|^2) - 2 * q.x, 0)
// ascending by (d, n), with +inf / -1 past N.  The TPU kernel walks the
// base tiles in grid order and carries a running top-k from one step to
// the next, selecting by k argmin steps over an MXU distance tile; it pads
// the base with 1e17 sentinel rows and the batch to tile_b = 8.  None of
// that carries over: CTAs run in no order, so the top-k is found by a
// select over counts that the CTAs merge with atomics.
//
// The key.  After the clamp d >= 0 (with -0.0 and NaN made +0.0), and a
// non-negative f32's bit pattern orders as its value, so
//     key = (u64(bits(d)) << 32) | n
// orders exactly as (d, n), and every key is distinct: the k smallest
// keys are the answer, ties included, whatever order the keys are found
// in.  A missing row (k > N) is the key ~0, decoded to +inf / -1.
//
// Distances.  Each of the three sums runs over i = 0, 1, ... in order and
// every operation rounds on its own (__fmul_rn / __fadd_rn: nothing
// contracts into an FMA), the order the plain version
// (kernels/l2_topk/ref.py) repeats, so the two agree bitwise.  So no
// tensor cores: TF32 would change the distances' bits.
//
// Four launches, whatever the shapes (kernels/l2_topk/ops.py, `plan`),
// issued by one C call after a memset of the per-query workspace:
//  1. scan: a (ceil(B / 8), stripes) grid.  CTA (g, s) stages its stripe
//     of base rows in tiles through shared memory, with 16-byte loads of
//     the tile's flat byte range where it is 16-byte aligned (else 4-byte
//     loads; both coalesced), computes each row's |x|^2 once and scores it
//     against up to 8 queries at once (a thread per row, a sum per query
//     in registers, the queries broadcast from shared memory).  It writes
//     bits(d) to a (B, N) buffer and counts each key's first digit, bits
//     30..20 of bits(d) (2,048 bins: the sign bit is 0), into a per-query
//     histogram in shared memory (16-bit counts, two to a word); the CTA
//     adds its nonzero bins into the query's global histogram with atomics.
//  2. threshold: a CTA per query scans its histogram for the bin t that
//     holds the k-th key: nb keys lie in bins below t, nt in t.
//  3. emit: a grid over (N / 4, B) streams the stored bits and appends
//     each key below t to the query's row of a (B, N) key buffer at
//     [0, nb), and each key in t at [nb, nb + nt), by warp-aggregated
//     atomics.  The buffer holds all N keys a row could emit, so nothing
//     is ever dropped: on a base of identical rows bin t holds all N keys.
//  4. resolve: a CTA per query selects the k - nb smallest of bin t's keys
//     exactly, by an 8-bit radix select over the key's remaining bits --
//     the 20 low bits of bits(d), then the bits the ids use -- a histogram
//     in shared memory per digit, stopping as soon as a digit's bucket is
//     taken whole; then it gathers those keys beside the nb below t,
//     bitonic-sorts the <= k keys, and writes (dist, id).  The atomics'
//     order changes from run to run; the sort by the distinct key makes
//     the output the same every time.
// The work is O(B N D) for the distances and O(B N) for the select; the
// sort is over k keys a query, not over the N keys.
//
// Store or recompute: the emit pass needs every key's distance again.
// Storing the (B, N) distances at B = 64, N = 2^20 writes and reads back
// 268 MB (0.16 ms at 3.35 TB/s); recomputing them would read the base
// once more (75.5 MB, 0.0225 ms) and repeat 2 B N D operations (0.073 ms
// at one rounded operation an instruction, but the scan reaches only
// about a third of that rate).  At B = 1 storing writes and reads 4 MB
// where recomputing reads 75.5 MB.  So this kernel stores, at every
// shape; a recomputing build was slower at all three shapes on the card
// (PERF.md, section 6).
//
// What bounds it: bytes at B = 1 (the base, 75.5 MB, read once: 0.0225
// ms) and at the bench shape (B = 8, N = 100,000, D = 128: 51.2 MB);
// operations at B = 64 (2 B N D = 2.4e9, 0.037 ms at 67 TFLOP/s counting
// an FMA as two; the ordered sums issue one operation an instruction, so
// this design's floor is about 0.073 ms there).  The scan grid splits N
// over about 1,056 CTAs (8 a SM) whatever B, so one query reads the base
// at the card's rate, and the 8 query groups of B = 64 run side by side
// on the same stripe, so the base leaves device memory about once.  At
// B = 64 the scan issues from shared memory (the queries, 32 bytes a row
// and dimension) and stays near 4x its floor.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).
// l2_topk_launch returns the first error of its memset and launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;        // scans: a thread per staged row
constexpr int kQ = 8;                // queries a scan CTA scores a tile against
constexpr int kBins = 2048;          // first digit: bits 30..20 of bits(d)
constexpr int kBinShift = 20;
constexpr int kWs = kBins + 8;       // int32 workspace a query: histogram, meta
constexpr int kT = kBins, kNb = kBins + 1, kNt = kBins + 2;
constexpr int kBelow = kBins + 3, kCand = kBins + 4;     // emit counters
constexpr int kResolveThreads = 512;
constexpr int kMaxK = 1024;
constexpr int kDigit = 8;            // resolve's radix digit
constexpr uint64_t kMissing = ~0ull;

// Row stride of dist_bits: N rounded up to 4, so that rows are 16-byte
// aligned for the emit kernel's loads.
__host__ __device__ __forceinline__ int bits_ld(int n) {
  return n > 0 ? (n + 3) & ~3 : 4;
}

// Copy `count` floats from src (rows of d) into rows of `stride` floats.
// e / d is (e * magic) >> 32 with magic = floor((2^32 - 1) / d) + 1: exact
// for e * d < 2^32 (a tile holds at most 16,384 floats, and d < 2^16).
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int count, int d, int stride,
                                      uint64_t magic,
                                      float* __restrict__ dst) {
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int v = threadIdx.x; v < n4; v += kThreads) {
      const float4 f = __ldg(s4 + v);
      const float vals[4] = {f.x, f.y, f.z, f.w};
      int r = (int)(((uint64_t)(v * 4) * magic) >> 32), c = v * 4 - r * d;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dst[r * stride + c] = vals[u];
        if (++c == d) {
          c = 0;
          ++r;
        }
      }
    }
    e0 = n4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < count; e += kThreads) {
    const int r = (int)(((uint64_t)e * magic) >> 32);
    dst[r * stride + e - r * d] = __ldg(src + e);
  }
}

// Append `key` at out[counter++] for the lanes that `take` it: one atomic
// a warp.  Every lane of the warp calls it.
__device__ __forceinline__ void emit(bool take, uint64_t key, int32_t* counter,
                                     uint64_t* __restrict__ out) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  int first = 0;
  if (lane == leader) first = atomicAdd(counter, __popc(mask));
  first = __shfl_sync(0xffffffffu, first, leader);
  if (take) out[first + __popc(mask & ((1u << lane) - 1))] = key;
}

// The ordered sums of one staged row x against the first Q queries of
// the CTA (Q of 1, 2, 4 or 8: the queries it has, rounded up).
template <int Q>
__device__ __forceinline__ void score_row(const float* __restrict__ x,
                                          const float* __restrict__ s_q,
                                          int d, float& xn,
                                          float (&dot)[kQ]) {
  for (int i = 0; i < d; ++i) {
    const float v = x[i];
    const float* q = s_q + i * kQ;
    xn = __fadd_rn(xn, __fmul_rn(v, v));
    if constexpr (Q >= 4) {
#pragma unroll
      for (int j = 0; j < Q; j += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + j);
        dot[j] = __fadd_rn(dot[j], __fmul_rn(qv.x, v));
        dot[j + 1] = __fadd_rn(dot[j + 1], __fmul_rn(qv.y, v));
        dot[j + 2] = __fadd_rn(dot[j + 2], __fmul_rn(qv.z, v));
        dot[j + 3] = __fadd_rn(dot[j + 3], __fmul_rn(qv.w, v));
      }
    } else {
#pragma unroll
      for (int j = 0; j < Q; ++j)
        dot[j] = __fadd_rn(dot[j], __fmul_rn(q[j], v));
    }
  }
}

// Launch 1: grid (ceil(B / kQ), stripes); CTA (g, s) scores queries
// [g * kQ, g * kQ + nq) against base rows [s * stripe, ...), writes each
// bits(d) to dist_bits (B, bits_ld(N)) and counts its first digit.  The histogram
// counts in 16-bit halves of 32-bit words (two bins a word), so a stripe
// holds at most 65,535 rows.
__global__ void __launch_bounds__(kThreads) l2_topk_scan_kernel(
    const float* __restrict__ queries, const float* __restrict__ base,
    int32_t* __restrict__ ws, uint32_t* __restrict__ dist_bits, int b,
    int n, int d, int stride, int tile, int stripe) {
  constexpr int kWords = kBins / 2;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                          // [i * kQ + j]: query j's x_i
  float* s_qn = s_q + d * kQ;                 // kQ
  float* s_x = s_qn + kQ;                     // tile rows of stride floats
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(s_x + tile * stride);
  const int g0 = blockIdx.x * kQ;
  const int nq = min(kQ, b - g0);
  const int qw = nq > 4 ? 8 : nq > 2 ? 4 : nq;    // 1, 2, 4 or 8
  const uint64_t magic = 0xffffffffull / (uint32_t)d + 1;
  const size_t ld = bits_ld(n);

  for (int e = threadIdx.x; e < d * kQ; e += kThreads) {
    const int i = e / kQ, j = e - i * kQ;
    s_q[e] = j < nq ? queries[(size_t)(g0 + j) * d + i] : 0.f;
  }
  for (int e = threadIdx.x; e < nq * kWords; e += kThreads) s_hist[e] = 0;
  __syncthreads();
  if (threadIdx.x < kQ) {
    float qn = 0.f;
    for (int i = 0; i < d; ++i) {
      const float v = s_q[i * kQ + threadIdx.x];
      qn = __fadd_rn(qn, __fmul_rn(v, v));
    }
    s_qn[threadIdx.x] = qn;
  }
  // s_qn is read after the first tile's barrier

  const long long r_end = min((long long)n,
                              (long long)(blockIdx.y + 1) * stripe);
  for (long long row0 = (long long)blockIdx.y * stripe; row0 < r_end;
       row0 += tile) {
    const int rows = (int)min((long long)tile, r_end - row0);
    stage(base + (size_t)row0 * d, rows * d, d, stride, magic, s_x);
    __syncthreads();
    if ((int)threadIdx.x < rows) {
      float xn = 0.f, dot[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) dot[j] = 0.f;
      const float* x = s_x + threadIdx.x * stride;
      switch (qw) {                           // the same for the whole CTA
        case 1: score_row<1>(x, s_q, d, xn, dot); break;
        case 2: score_row<2>(x, s_q, d, xn, dot); break;
        case 4: score_row<4>(x, s_q, d, xn, dot); break;
        default: score_row<8>(x, s_q, d, xn, dot);
      }
      const size_t id = (size_t)(row0 + threadIdx.x);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (j >= nq) break;
        float dist = __fsub_rn(__fadd_rn(s_qn[j], xn), __fmul_rn(2.f, dot[j]));
        dist = dist > 0.f ? dist : 0.f;       // -0.0 and NaN become +0.0
        const uint32_t bits = __float_as_uint(dist);
        dist_bits[(size_t)(g0 + j) * ld + id] = bits;
        const uint32_t bin = bits >> kBinShift;
        atomicAdd(&s_hist[j * kWords + (bin >> 1)], 1u << ((bin & 1) * 16));
      }
    }
    __syncthreads();                          // s_x is staged anew
  }
  for (int e = threadIdx.x; e < nq * kWords; e += kThreads) {
    const uint32_t h = s_hist[e];
    if (h == 0) continue;
    unsigned* g = reinterpret_cast<unsigned*>(ws) +
                  (size_t)(g0 + e / kWords) * kWs + (e % kWords) * 2;
    if (h & 0xffffu) atomicAdd(g, h & 0xffffu);
    if (h >> 16) atomicAdd(g + 1, h >> 16);
  }
}

// Launch 2: a CTA of 256 threads per query.  t, nb, nt such that nb keys
// lie in bins below t, nt in t, and nb < k <= nb + nt; or, with at most k
// keys in all, t = kBins (every key below it), nb = N, nt = 0.  Sets the
// emit counters: below at 0, bin t's at nb.
__global__ void __launch_bounds__(256) l2_topk_threshold_kernel(
    int32_t* __restrict__ ws, int k) {
  constexpr int kPer = kBins / 256;
  __shared__ int s_warp[8];
  int32_t* h = ws + (size_t)blockIdx.x * kWs;
  int v[kPer], sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    v[u] = h[threadIdx.x * kPer + u];
    sum += v[u];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < 8; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  const int excl = before + incl - sum;
  int t = -1, nb = 0, nt = 0;
  if (total <= k) {
    if (threadIdx.x == 0) t = kBins, nb = total;
  } else if (excl < k && k <= excl + sum) {   // one thread holds bin t
    int c = excl;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (t < 0 && c + v[u] >= k) {
        t = threadIdx.x * kPer + u;
        nb = c;
        nt = v[u];
      }
      c += v[u];
    }
  }
  if (t >= 0) {
    h[kT] = t;
    h[kNb] = nb;
    h[kNt] = nt;
    h[kBelow] = 0;
    h[kCand] = nb;
  }
}

// Launch 3: grid (emit_blocks, B); the CTAs of query row q stride over its
// N keys, 16 bytes a thread.  Keys of bins below t go to [0, nb) of the
// row's key buffer, keys of bin t to [nb, nb + nt); all but a few lie
// above t, and one vote a warp skips them.
__global__ void __launch_bounds__(kThreads) l2_topk_emit_kernel(
    const uint32_t* __restrict__ dist_bits, int32_t* __restrict__ ws,
    uint64_t* __restrict__ keys, int n) {
  int32_t* meta = ws + (size_t)blockIdx.y * kWs;
  const int t = meta[kT];
  const int n4 = bits_ld(n) / 4;
  const uint4* row = reinterpret_cast<const uint4*>(dist_bits) +
                     (size_t)blockIdx.y * n4;
  uint64_t* out = keys + (size_t)blockIdx.y * (n > 0 ? n : 1);
  for (int v0 = blockIdx.x * kThreads; v0 < n4;
       v0 += gridDim.x * kThreads) {          // the same for the CTA
    const int v = v0 + threadIdx.x;
    const uint4 w = v < n4 ? row[v] : make_uint4(0, 0, 0, 0);
    const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = (long long)v * 4 + u;
      const uint32_t bits = i < n ? word[u] : ~0u;  // bin 4095: above any t
      const int bin = (int)(bits >> kBinShift);
      if (__any_sync(0xffffffffu, bin <= t)) {
        const uint64_t key = ((uint64_t)bits << 32) | (uint32_t)i;
        emit(bin < t, key, meta + kBelow, out);
        emit(bin == t, key, meta + kCand, out);
      }
    }
  }
}

__device__ __forceinline__ void bitonic_sort(uint64_t* s, int c) {
  for (int size = 2; size <= c; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (c >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Launch 4: a CTA per query.  The keys of bin t share their top 12 bits;
// below those, a key orders as its reduced form: the 20 low bits of
// bits(d), then the low idb bits of the id (ids < N < 2^idb).
__global__ void __launch_bounds__(kResolveThreads) l2_topk_resolve_kernel(
    const int32_t* __restrict__ ws, const uint64_t* __restrict__ keys,
    float* __restrict__ out_d, int32_t* __restrict__ out_i, int n, int k,
    int sort_len) {
  __shared__ uint64_t s_sel[kMaxK];
  __shared__ uint32_t s_hist[1 << kDigit];
  __shared__ int s_dig, s_cnt, s_rem, s_pos;
  const int32_t* meta = ws + (size_t)blockIdx.x * kWs;
  const int nb = meta[kNb], nt = meta[kNt];
  const uint64_t* row = keys + (size_t)blockIdx.x * (n > 0 ? n : 1);
  const uint64_t* cand = row + nb;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_sel[i] = row[i];
  const int r = min(k - nb, nt);              // keys of bin t to take
  const int idb = n > 1 ? 32 - __clz(n - 1) : 1;
  const uint64_t id_mask = (1ull << idb) - 1;
  auto reduced = [&](uint64_t key) {
    return (((key >> 32) & 0xFFFFFull) << idb) | (key & id_mask);
  };
  // the r-th smallest reduced key of bin t, digit by digit: afterwards the
  // keys taken are those whose reduced key >> s is at most `prefix`
  uint64_t prefix = 0;
  int s = 20 + idb, rem = r;
  if (r > 0 && r < nt) {
    while (s > 0) {
      const int w = min(kDigit, s);
      s -= w;
      for (int i = threadIdx.x; i < (1 << kDigit); i += blockDim.x)
        s_hist[i] = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < nt; j += blockDim.x) {
        const uint64_t rk = reduced(cand[j]);
        if ((rk >> (s + w)) == prefix)
          atomicAdd(&s_hist[(rk >> s) & ((1u << w) - 1)], 1u);
      }
      __syncthreads();
      if (threadIdx.x < 32) {                 // warp 0 scans the 256 bins
        constexpr int kPer = (1 << kDigit) / 32;
        const int lane = threadIdx.x;
        int v[kPer], sum = 0;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          v[u] = (int)s_hist[lane * kPer + u];
          sum += v[u];
        }
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        int c = incl - sum;
        if (c < rem && rem <= incl) {
          bool found = false;
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            if (!found && c + v[u] >= rem) {
              found = true;
              s_dig = lane * kPer + u;
              s_rem = rem - c;
              s_cnt = v[u];
            }
            c += v[u];
          }
        }
      }
      __syncthreads();
      prefix = (prefix << w) | (uint64_t)s_dig;
      rem = s_rem;
      const int cnt = s_cnt;
      __syncthreads();                        // all have read s_dig, s_cnt
      if (cnt == rem) break;                  // the bucket is taken whole
    }
  }
  if (threadIdx.x == 0) s_pos = nb;
  __syncthreads();
  if (r > 0) {
    for (int j = threadIdx.x; j < nt; j += blockDim.x) {
      const uint64_t key = cand[j];
      if ((reduced(key) >> s) <= prefix) s_sel[atomicAdd(&s_pos, 1)] = key;
    }
  }
  for (int i = nb + max(r, 0) + threadIdx.x; i < sort_len; i += blockDim.x)
    s_sel[i] = kMissing;
  __syncthreads();
  bitonic_sort(s_sel, sort_len);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = s_sel[i];
    const size_t o = (size_t)blockIdx.x * k + i;
    if (key == kMissing) {
      out_d[o] = __int_as_float(0x7f800000);          // +inf
      out_i[o] = -1;
    } else {
      out_d[o] = __uint_as_float((uint32_t)(key >> 32));
      out_i[o] = (int32_t)(uint32_t)key;
    }
  }
}

}  // namespace

// Dynamic shared memory of a scan CTA: the queries, a tile of `tile` rows
// of `stride` floats and hist_queries histograms.
extern "C" int l2_topk_bits_ld(int n) { return bits_ld(n); }

extern "C" size_t l2_topk_scan_smem_bytes(int d, int tile, int stride,
                                          int hist_queries) {
  return ((size_t)d * kQ + kQ + (size_t)tile * stride) * 4 +
         (size_t)hist_queries * kBins * 2;
}

// One call's four launches, on `stream`: ws (B, kWs) int32 is zeroed
// first (a memset, not a kernel); dist_bits (B, bits_ld(N)) u32 and keys
// (B, max(N, 1)) u64 scratch; dists (B, k) f32, ids (B, k) int32;
// k <= kMaxK.  Returns the first error.
extern "C" int l2_topk_launch(const float* queries, const float* base,
                              int32_t* ws, uint32_t* dist_bits,
                              uint64_t* keys, float* out_d, int32_t* out_i,
                              int b, int n, int d, int k, int stride,
                              int tile, int stripe, int stripes,
                              int emit_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = l2_topk_scan_smem_bytes(d, tile, stride, min(b, kQ));
  cudaError_t err = prepare((const void*)l2_topk_scan_kernel, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(ws, 0, (size_t)b * kWs * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  l2_topk_scan_kernel<<<dim3((b + kQ - 1) / kQ, stripes), kThreads, smem,
                        st>>>(queries, base, ws, dist_bits, b, n, d, stride,
                              tile, stripe);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  l2_topk_threshold_kernel<<<b, 256, 0, st>>>(ws, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  l2_topk_emit_kernel<<<dim3(emit_blocks, b), kThreads, 0, st>>>(
      dist_bits, ws, keys, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int sort_len = 1;
  while (sort_len < k) sort_len <<= 1;
  l2_topk_resolve_kernel<<<b, kResolveThreads, 0, st>>>(
      ws, keys, out_d, out_i, n, k, sort_len);
  return (int)cudaGetLastError();
}
