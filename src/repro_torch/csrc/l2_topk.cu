// Exact squared-L2 top-k of each query against a shared base, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/l2_topk/kernel.py:
//   l2_topk_pallas  (body _l2_topk_kernel)
// queries (B, D) f32, base (N, D) f32 -> for each query the k smallest
//     d(b, n) = max((|q|^2 + |x|^2) - 2 * q.x, 0)
// ascending by (d, n), with +inf / -1 past N.  The TPU kernel walks the
// base tiles in grid order and carries a running top-k from one step to
// the next, selecting by k argmin steps over an MXU distance tile; it pads
// the base with 1e17 sentinel rows and the batch to tile_b = 8.  None of
// that carries over: here the base is split over a grid of CTAs, and each
// CTA sorts keys.
//
// The key.  After the clamp d >= 0 (with -0.0 and NaN made +0.0), and a
// non-negative f32's bit pattern orders as its value, so
//     key = (u64(bits(d)) << 32) | n
// sorts ascending in exactly (d, n) order: ties need no extra code.  A
// missing row is the key ~0 (after every real key), decoded to +inf / -1.
//
// Passes.  Pass 1 runs a (B, S) grid: CTA (b, s) computes the keys of
// rows [s*C, s*C + C) in shared memory, bitonic-sorts them and writes its
// first k.  Each later pass sorts chunks of C of those keys the same way,
// until one chunk per row remains; the last pass decodes its first k keys
// into (dist, id).  Each pass's C is a power of two at least 2k, so every
// pass cuts the keys by C / k; the wrapper (kernels/l2_topk/ops.py,
// `plan`) chooses it (at most 8,192, no more than the keys left need) and
// counts the passes.
//
// Distances.  Each of the three sums runs over i = 0, 1, ... in order and
// every operation rounds on its own (__fmul_rn / __fadd_rn: nothing
// contracts into an FMA), the order the plain version
// (kernels/l2_topk/ref.py) repeats, so the two agree bitwise.
//
// What bounds it: at the retrieval shapes (D = 18, N = 2^20) bytes at
// B = 1 (the base, 75.5 MB, read once) and f32 operations at B = 64.  The
// design reaches neither: a thread walks its base row alone (72-byte rows
// are not 16-byte aligned, so no vector loads), and the bitonic sort does
// O(C log^2 C) shared-memory compare-exchanges per chunk.  A tiled,
// tensor-core distance pass and a radix select are later work.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  Each entry
// point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr uint64_t kMissing = ~0ull;

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

// Write the first `keep` (= k) sorted keys of chunk (b, blockIdx.y): as
// keys for the next pass, or decoded into dists and ids on the last pass.
__device__ __forceinline__ void write_keep(const uint64_t* s, int keep,
                                           uint64_t* __restrict__ out_keys,
                                           float* __restrict__ out_d,
                                           int32_t* __restrict__ out_i) {
  const size_t row = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
  for (int i = threadIdx.x; i < keep; i += blockDim.x) {
    const uint64_t key = s[i];
    if (out_keys != nullptr) {
      out_keys[row * keep + i] = key;
    } else if (key == kMissing) {
      out_d[row * keep + i] = __int_as_float(0x7f800000);   // +inf
      out_i[row * keep + i] = -1;
    } else {
      out_d[row * keep + i] = __uint_as_float((uint32_t)(key >> 32));
      out_i[row * keep + i] = (int32_t)(uint32_t)key;
    }
  }
}

// Pass 1: grid (B, S); chunk s holds base rows [s*c, s*c + c).
__global__ void __launch_bounds__(1024) l2_topk_rows_kernel(
    const float* __restrict__ queries, const float* __restrict__ base,
    uint64_t* __restrict__ out_keys, float* __restrict__ out_d,
    int32_t* __restrict__ out_i, int n, int d, int c, int keep) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_key = smem;                                    // c
  float* s_q = reinterpret_cast<float*>(smem + c);           // d
  const float* q = queries + (size_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s_q[i] = q[i];
  __syncthreads();
  float qn = 0.f;
  for (int i = 0; i < d; ++i) qn = __fadd_rn(qn, __fmul_rn(s_q[i], s_q[i]));
  const size_t first = (size_t)blockIdx.y * c;
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    const size_t row = first + t;
    uint64_t key = kMissing;
    if (row < (size_t)n) {
      const float* x = base + row * d;
      float xn = 0.f, dot = 0.f;
      for (int i = 0; i < d; ++i) {
        const float v = x[i];
        xn = __fadd_rn(xn, __fmul_rn(v, v));
        dot = __fadd_rn(dot, __fmul_rn(s_q[i], v));
      }
      float dist = __fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot));
      dist = dist > 0.f ? dist : 0.f;           // -0.0 and NaN become +0.0
      key = ((uint64_t)__float_as_uint(dist) << 32) | (uint32_t)row;
    }
    s_key[t] = key;
  }
  __syncthreads();
  bitonic_sort(s_key, c);
  write_keep(s_key, keep, out_keys, out_d, out_i);
}

// Later passes: grid (B, S); chunk s holds keys [s*c, s*c + c) of the
// row's m keys from the previous pass.
__global__ void __launch_bounds__(1024) l2_topk_keys_kernel(
    const uint64_t* __restrict__ in_keys, uint64_t* __restrict__ out_keys,
    float* __restrict__ out_d, int32_t* __restrict__ out_i, int m, int c,
    int keep) {
  extern __shared__ uint64_t smem[];
  const uint64_t* in = in_keys + (size_t)blockIdx.x * m;
  const size_t first = (size_t)blockIdx.y * c;
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    const size_t j = first + t;
    smem[t] = j < (size_t)m ? in[j] : kMissing;
  }
  __syncthreads();
  bitonic_sort(smem, c);
  write_keep(smem, keep, out_keys, out_d, out_i);
}

int threads_for(int c) { return c / 2 < 1024 ? c / 2 : 1024; }

}  // namespace

extern "C" size_t l2_topk_smem_bytes(int c, int d) {
  return (size_t)c * 8 + (size_t)d * 4;
}

// One pass over base rows.  out_keys == nullptr makes it the last pass:
// then it writes out_d / out_i (B, keep) instead of out_keys (B, S, keep).
extern "C" int l2_topk_rows_launch(const float* queries, const float* base,
                                   uint64_t* out_keys, float* out_d,
                                   int32_t* out_i, int b, int n, int d, int c,
                                   int s, int keep, void* stream) {
  const size_t smem = l2_topk_smem_bytes(c, d);
  cudaError_t err = prepare((const void*)l2_topk_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  l2_topk_rows_kernel<<<dim3(b, s), threads_for(c), smem,
                        (cudaStream_t)stream>>>(queries, base, out_keys,
                                                out_d, out_i, n, d, c, keep);
  return (int)cudaGetLastError();
}

// One pass over the (B, m) keys of the previous pass; out_keys as above.
extern "C" int l2_topk_keys_launch(const uint64_t* in_keys,
                                   uint64_t* out_keys, float* out_d,
                                   int32_t* out_i, int b, int m, int c, int s,
                                   int keep, void* stream) {
  const size_t smem = l2_topk_smem_bytes(c, 0);
  cudaError_t err = prepare((const void*)l2_topk_keys_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  l2_topk_keys_kernel<<<dim3(b, s), threads_for(c), smem,
                        (cudaStream_t)stream>>>(in_keys, out_keys, out_d,
                                                out_i, m, c, keep);
  return (int)cudaGetLastError();
}
