// The fused ADC beam-hop loop of the batched BAMG query path, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels in repro/kernels/beam_fused/kernel.py:
//   beam_hops_adc_pallas  (body _beam_adc_kernel via _hop_loop,
//                          _merge_ranked, _adc_score_from)
//   beam_hops_adc_stream  (body _beam_adc_stream_kernel, _gather_rows_stream)
// Both compute one function; the TPU needed two because its fast memory
// (VMEM) could hold the corpus only for small shards.  Hopper reads the
// corpus from device memory with native gathers, so one kernel serves both.
//
// The hop loop (pick, adjacency gather, ranked merge, trace) is
// beam_hops.cuh's, shared with the exact-L2 kernel (beam_hops_l2.cu).  This
// file adds ADC scoring: the row's (M, K) table is staged in shared memory
// once, and a valid neighbour c scores sum_m table[m][codes[c][m]] for
// m = 0, 1, ... in order, as the plain version (kernels/pq_adc/ref.py) does.
//
// What bounds it: memory.  The least traffic is the tables, the pool in and
// out, the traces, and per hop one adjacency row (R*4 bytes) plus the codes
// of its valid neighbours (M bytes each).  Each hop waits on two dependent
// device-memory round trips (adjacency, then codes), so at B = 64 rows
// (64 of 132 SMs busy) latency, not bandwidth, sets the time.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  The entry
// point returns cudaGetLastError() after its launch.
#include "beam_hops.cuh"
#include "launch.cuh"

namespace {

struct AdcScore {
  const uint8_t* __restrict__ codes;  // (N, M) device memory
  const float* tab;                   // (M, K) shared memory
  int m, k;
  __device__ __forceinline__ float operator()(int c) const {
    const uint8_t* cc = codes + (size_t)c * m;
    float s = 0.f;
    for (int q = 0; q < m; ++q) s += tab[q * k + cc[q]];
    return s;
  }
};

__global__ void __launch_bounds__(1024) beam_hops_adc_kernel(
    const int32_t* __restrict__ adj, const uint8_t* __restrict__ codes,
    const float* __restrict__ tables, const int32_t* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const uint8_t* __restrict__ pool_exp,
    beam::Outputs out, int l, int r, int m, int k, int max_hops) {
  extern __shared__ float smem[];
  float* s_tab = smem;                                       // m * k
  const float* tab = tables + (size_t)blockIdx.x * m * k;
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) s_tab[i] = tab[i];
  const AdcScore score{codes, s_tab, m, k};
  beam::hop_loop(adj, score, pool_ids, pool_d, pool_exp, out, s_tab + m * k,
                 l, r, max_hops);
}

}  // namespace

extern "C" size_t beam_hops_adc_smem_bytes(int l, int r, int m, int k) {
  return (size_t)m * k * 4 + beam::pool_smem_bytes(l, r);
}

extern "C" int beam_hops_adc_launch(
    const int32_t* adj, const uint8_t* codes, const float* tables,
    const int32_t* pool_ids, const float* pool_d, const uint8_t* pool_exp,
    int32_t* out_ids, float* out_d, uint8_t* out_exp, int32_t* out_hops,
    int32_t* trace_ids, float* trace_d, int32_t* next_id, uint8_t* done, int b,
    int l, int r, int m, int k, int max_hops, void* stream) {
  const size_t smem = beam_hops_adc_smem_bytes(l, r, m, k);
  cudaError_t err = prepare((const void*)beam_hops_adc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const beam::Outputs out{out_ids, out_d,  out_exp, out_hops,
                          trace_ids, trace_d, next_id, done};
  beam_hops_adc_kernel<<<b, beam::threads_for(l, r), smem,
                         (cudaStream_t)stream>>>(
      adj, codes, tables, pool_ids, pool_d, pool_exp, out, l, r, m, k,
      max_hops);
  return (int)cudaGetLastError();
}
