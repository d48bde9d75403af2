// PQ asymmetric distance computation (ADC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in repro/kernels/pq_adc/kernel.py:
//   pq_adc_launch          <- pq_adc_pallas (body _adc_kernel)
//       est[b, n] = sum_m tables[b, m, codes[n, m]]
//   pq_adc_rowwise_launch  <- pq_adc_rowwise_pallas (body _adc_rowwise_kernel)
//       est[b, r] = sum_m tables[b, m, cand[b, r, m]]
//
// The TPU computes each lookup as a one-hot @ LUT matmul because it has no
// fast gather; Hopper gathers natively, from L2 or from shared memory.
//
// What bounds it on this card.  At the serving shapes (B = 64 queries,
// E = 256 entry candidates or R = 32 neighbours, M = 16, K = 256) a call is
// a few thousand lookups into 1 MB of tables that the engine has just
// written, so they sit in the 50 MB L2: the bytes take a fraction of a
// microsecond, and the time is the launch plus a chain of dependent round
// trips (a row's codes, then its M table entries).  At many rows per query
// (N = 70,000 for B = 3) each table entry is looked up many times, and the
// gathers themselves bound the call.
//
// Two forms, chosen by `plan` in kernels/pq_adc/ops.py:
//   gather  one thread per estimate over the flat B*N (or B*R) index,
//           consecutive threads on consecutive rows of one query, a grid
//           sized to the 132 SMs.  A thread reads its code row by the
//           widest aligned vector load (one 16-byte load at M = 16), issues
//           all M table loads (__ldg, from L2) before the first add, and
//           writes its estimate: two dependent round trips, no shared
//           memory, no barrier.
//   staged  a block copies one query's (M, K) table into shared memory by
//           16-byte loads all in flight, then its threads walk that
//           query's rows with a grid stride, reading codes as above and
//           gathering from shared memory.
// `plan` stages where a block would look each table entry up twice or more
// (the measured cut).  On one H100 80GB HBM3 at 700 W the gather form takes
// 1.76 and 1.54 us of device time at the two serving shapes, against 0.87
// for an empty kernel at the same grid: the two round trips are the rest
// (tools/pq_adc_bench.py, PERF.md).
// Both sum m = 0, 1, ... from 0.f in order, each add rounded: the plain
// version's order (kernels/pq_adc/ref.py), so they agree bit for bit.  M is
// a template parameter for 8, 16, 32 and 64 (all M loads in flight), with a
// loop over a runtime M, a vector of codes at a time, as the fallback.
//
// pq_adc_floor_launch launches an empty kernel at a given geometry: the
// least any launch of that geometry takes, the design floor that
// chip_smoke.py and tools/pq_adc_bench.py report beside the kernels.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  Each entry
// point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

enum Form { kGather = 0, kStaged = 1 };   // kernels/pq_adc/ops.py FORMS

// The N codes of a row, read V bytes a load (V = 16, 8, 4 or 1; N % V == 0
// where V > 1) and kept as 32-bit words; c[j] is code j.
template <int N, int V>
struct Codes {
  uint32_t w[V == 1 ? N : N / 4];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ p) {
    if constexpr (V == 16) {
#pragma unroll
      for (int q = 0; q < N / 16; ++q) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
        w[4 * q] = u.x;
        w[4 * q + 1] = u.y;
        w[4 * q + 2] = u.z;
        w[4 * q + 3] = u.w;
      }
    } else if constexpr (V == 8) {
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + q);
        w[2 * q] = u.x;
        w[2 * q + 1] = u.y;
      }
    } else if constexpr (V == 4) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        w[q] = __ldg(reinterpret_cast<const unsigned int*>(p) + q);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) w[j] = __ldg(p + j);
    }
  }

  __device__ __forceinline__ int operator[](int j) const {
    return V == 1 ? (int)w[j] : (int)((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
  }
};

// acc + the N lookups of one row's codes at p into the (N, k) table tab:
// every load issued before the first add, the adds in ascending order.
// kL2: tab is in global memory (read through __ldg); else shared memory.
template <int N, int V, bool kL2>
__device__ __forceinline__ float adc_chunk(float acc, const float* tab,
                                           const uint8_t* __restrict__ p,
                                           int k) {
  Codes<N, V> c;
  c.load(p);
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    v[j] = kL2 ? __ldg(tab + j * k + c[j]) : tab[j * k + c[j]];
#pragma unroll
  for (int j = 0; j < N; ++j) acc += v[j];
  return acc;
}

// One estimate: M > 0 is M fixed at compile time; M == 0 loops over the
// runtime m, V codes at a time.
template <int M, int V, bool kL2>
__device__ __forceinline__ float adc_sum(const float* tab,
                                         const uint8_t* __restrict__ row,
                                         int m, int k) {
  if constexpr (M > 0) {
    return adc_chunk<M, V, kL2>(0.f, tab, row, k);
  } else {
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < m; j += V)
      acc = adc_chunk<V, V, kL2>(acc, tab + j * k, row + j, k);
    return acc;
  }
}

// Gather form: thread i of the flat index (i < total < 2^31) scores query
// b = i / n against code row i % n (shared codes) or row i (rowwise).
template <int M, int V>
__global__ void __launch_bounds__(256)
    adc_gather_kernel(const float* __restrict__ tables,
                      const uint8_t* __restrict__ codes,
                      float* __restrict__ out, int total, int n, int m, int k,
                      bool shared_codes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / n;
  const int row = shared_codes ? i - b * n : i;
  out[i] = adc_sum<M, V, true>(tables + (size_t)b * m * k,
                               codes + (size_t)row * m, m, k);
}

// Copy `count` elements (float4 where the table is 16-byte aligned, else
// float) from global to shared memory, kU loads in flight a thread before
// the first store.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int count) {
  constexpr int kU = 8;
  for (int i0 = threadIdx.x; i0 < count; i0 += kU * blockDim.x) {
    T v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) dst[i] = v[u];
    }
  }
}

// Staged form: grid (B, gy); block (b, y) stages table b, then scores rows
// y * blockDim.x + threadIdx.x, stepping by gy * blockDim.x.
template <int M, int V>
__global__ void __launch_bounds__(256)
    adc_staged_kernel(const float* __restrict__ tables,
                      const uint8_t* __restrict__ codes,
                      float* __restrict__ out, int n, int m, int k,
                      bool shared_codes) {
  extern __shared__ float4 s_tab4[];
  float* s_tab = reinterpret_cast<float*>(s_tab4);
  const int b = blockIdx.x;
  const int mk = m * k;
  const float* tab = tables + (size_t)b * mk;
  if ((reinterpret_cast<uintptr_t>(tab) & 15) == 0 && (mk & 3) == 0)
    stage(s_tab4, reinterpret_cast<const float4*>(tab), mk / 4);
  else
    stage(s_tab, tab, mk);
  __syncthreads();
  const uint8_t* rows = shared_codes ? codes : codes + (size_t)b * n * m;
  float* o = out + (size_t)b * n;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < n;
       i += gridDim.y * blockDim.x)
    o[i] = adc_sum<M, V, false>(s_tab, rows + (size_t)i * m, m, k);
}

__global__ void adc_empty_kernel() {}

struct Launch {
  const float* tables;
  const uint8_t* codes;
  float* out;
  int b, n, m, k, form;
  dim3 grid;
  int threads;
  bool shared_codes;
};

template <int M, int V>
cudaError_t launch_mv(const Launch& a, cudaStream_t stream) {
  if (a.form == kGather) {
    adc_gather_kernel<M, V><<<a.grid, a.threads, 0, stream>>>(
        a.tables, a.codes, a.out, a.b * a.n, a.n, a.m, a.k, a.shared_codes);
  } else {
    const size_t smem = (size_t)a.m * a.k * sizeof(float);
    const cudaError_t err = prepare((const void*)adc_staged_kernel<M, V>,
                                    smem);
    if (err != cudaSuccess) return err;
    adc_staged_kernel<M, V><<<a.grid, a.threads, smem, stream>>>(
        a.tables, a.codes, a.out, a.n, a.m, a.k, a.shared_codes);
  }
  return cudaGetLastError();
}

// the code-load width: every width that divides M (any, for runtime M)
template <int M>
cudaError_t launch_m(const Launch& a, int vec, cudaStream_t stream) {
  switch (vec) {
    case 16:
      if constexpr (M % 16 == 0) return launch_mv<M, 16>(a, stream);
      break;
    case 8:
      if constexpr (M % 8 == 0) return launch_mv<M, 8>(a, stream);
      break;
    case 4:
      if constexpr (M % 4 == 0) return launch_mv<M, 4>(a, stream);
      break;
    case 1:
      return launch_mv<M, 1>(a, stream);
  }
  return cudaErrorInvalidValue;
}

int launch(const Launch& a, int vec, void* stream) {
  // a vector width the codes' address or M does not allow would fault
  if (vec < 1 || a.m % vec || reinterpret_cast<uintptr_t>(a.codes) % vec ||
      (a.form == kGather && (long long)a.b * a.n >= (1ll << 31)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a.m) {
    case 8: return (int)launch_m<8>(a, vec, s);
    case 16: return (int)launch_m<16>(a, vec, s);
    case 32: return (int)launch_m<32>(a, vec, s);
    case 64: return (int)launch_m<64>(a, vec, s);
    default: return (int)launch_m<0>(a, vec, s);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// form, vec, grid and threads as kernels/pq_adc/ops.py `plan` gives them
extern "C" int pq_adc_launch(const float* tables, const uint8_t* codes,
                             float* out, int b, int n, int m, int k, int form,
                             int vec, int gx, int gy, int threads,
                             void* stream) {
  return launch({tables, codes, out, b, n, m, k, form, dim3(gx, gy), threads,
                 true}, vec, stream);
}

extern "C" int pq_adc_rowwise_launch(const float* tables, const uint8_t* cand,
                                     float* out, int b, int r, int m, int k,
                                     int form, int vec, int gx, int gy,
                                     int threads, void* stream) {
  return launch({tables, cand, out, b, r, m, k, form, dim3(gx, gy), threads,
                 false}, vec, stream);
}

extern "C" int pq_adc_floor_launch(int gx, int gy, int threads, int smem,
                                   void* stream) {
  const cudaError_t err = prepare((const void*)adc_empty_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adc_empty_kernel<<<dim3(gx, gy), threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
