// PQ asymmetric distance computation (ADC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in repro/kernels/pq_adc/kernel.py:
//   pq_adc_launch          <- pq_adc_pallas (body _adc_kernel)
//       est[b, n] = sum_m tables[b, m, codes[n, m]]
//   pq_adc_rowwise_launch  <- pq_adc_rowwise_pallas (body _adc_rowwise_kernel)
//       est[b, r] = sum_m tables[b, m, cand[b, r, m]]
//
// The TPU computes each lookup as a one-hot @ LUT matmul because it has no
// fast gather.  Hopper gathers natively from shared memory, so each block
// stages one query's (M, K) f32 table there (16 KB at M = 16, K = 256) and
// every thread sums its row's lookups for m = 0, 1, ... in order: the
// summation order of the plain PyTorch version (kernels/pq_adc/ref.py), so
// the two agree bit for bit.
//
// What bounds it: memory.  The least traffic is the tables (B*M*K*4 bytes)
// plus the codes and the output; the arithmetic is M adds per estimate.
// The design reads each table once per block from device memory; at the
// serving shapes (E = 256 candidates, R = 32 neighbours) the launch
// latency and the table staging dominate, which a later kernel can cut by
// reading the LUT entries straight from L2 instead of staging them.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  Each entry
// point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void stage_table(float* s_tab,
                                            const float* __restrict__ tab,
                                            int mk) {
  for (int i = threadIdx.x; i < mk; i += blockDim.x) s_tab[i] = tab[i];
}

__device__ __forceinline__ float adc_sum(const float* s_tab,
                                         const uint8_t* __restrict__ c,
                                         int m, int k) {
  float acc = 0.f;
  for (int j = 0; j < m; ++j) acc += s_tab[j * k + c[j]];
  return acc;
}

// grid (B, ceil(N / kThreads) capped): block (b, y) stages table b and its
// threads walk the N axis with a grid stride.
__global__ void pq_adc_kernel(const float* __restrict__ tables,
                              const uint8_t* __restrict__ codes,
                              float* __restrict__ out, int n, int m, int k) {
  extern __shared__ float s_tab[];
  const int b = blockIdx.x;
  stage_table(s_tab, tables + (size_t)b * m * k, m * k);
  __syncthreads();
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < n;
       i += gridDim.y * blockDim.x) {
    out[(size_t)b * n + i] = adc_sum(s_tab, codes + (size_t)i * m, m, k);
  }
}

// grid (B,): block b stages table b and its threads walk row b's R axis.
__global__ void pq_adc_rowwise_kernel(const float* __restrict__ tables,
                                      const uint8_t* __restrict__ cand,
                                      float* __restrict__ out, int r, int m,
                                      int k) {
  extern __shared__ float s_tab[];
  const int b = blockIdx.x;
  stage_table(s_tab, tables + (size_t)b * m * k, m * k);
  __syncthreads();
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const size_t row = (size_t)b * r + i;
    out[row] = adc_sum(s_tab, cand + row * m, m, k);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int pq_adc_launch(const float* tables, const uint8_t* codes,
                             float* out, int b, int n, int m, int k,
                             void* stream) {
  const size_t smem = (size_t)m * k * sizeof(float);
  cudaError_t err = prepare((const void*)pq_adc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int gy = (n + kThreads - 1) / kThreads;
  gy = gy < 1 ? 1 : (gy > 65535 ? 65535 : gy);
  pq_adc_kernel<<<dim3(b, gy), kThreads, smem, (cudaStream_t)stream>>>(
      tables, codes, out, n, m, k);
  return (int)cudaGetLastError();
}

extern "C" int pq_adc_rowwise_launch(const float* tables, const uint8_t* cand,
                                     float* out, int b, int r, int m, int k,
                                     void* stream) {
  const size_t smem = (size_t)m * k * sizeof(float);
  cudaError_t err = prepare((const void*)pq_adc_rowwise_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pq_adc_rowwise_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      tables, cand, out, r, m, k);
  return (int)cudaGetLastError();
}
