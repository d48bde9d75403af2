// The fused exact-L2 beam-hop loop of batched BAMG construction (the
// NSG / Vamana candidate frontier), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in repro/kernels/beam_fused/kernel.py:
//   beam_hops_l2_pallas  (body _beam_l2_kernel via _hop_loop,
//                         _merge_ranked, _l2_score_from)
//   beam_hops_l2_stream  (body _beam_l2_stream_kernel, _gather_rows_stream)
// One function, as for the ADC pair: the TPU split resident from streamed
// corpora for VMEM, and carried vectors and norms as one (N, D+1) f32
// array; here the kernel reads x (N, D) and n2 (N,) from device memory.
//
// The hop loop (pick, adjacency gather, ranked merge, trace) is
// beam_hops.cuh's, shared with the ADC kernel (beam_hops_adc.cu).  This
// file adds exact-L2 scoring: the row's query is staged in shared memory
// once, and a valid neighbour c scores
//     max((n2[c] - 2 * dot) + |q|^2, 0),  dot = sum_i x[c][i] * q[i]
// with the dot summed over i = 0, 1, ... in order and every operation
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: nothing contracts
// into an FMA), the order the plain version (kernels/beam_fused/ref.py,
// `l2_score`) repeats, so the two agree bitwise.  |q|^2 comes from the
// wrapper, computed by the plain version's function.
//
// What bounds it: memory.  The least traffic is the queries, the pool in
// and out, the traces, and per hop one adjacency row (R*4 bytes) plus the
// vector and norm of each valid neighbour ((D+1)*4 bytes).  Each hop waits
// on two dependent device-memory round trips (adjacency, then vectors), and
// each thread walks its neighbour's row alone, so latency, not bandwidth,
// sets the time; a coalesced warp-per-row layout is later work.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  The entry
// point returns cudaGetLastError() after its launch.
#include "beam_hops.cuh"
#include "launch.cuh"

namespace {

struct L2Score {
  const float* __restrict__ x;   // (N, D) device memory
  const float* __restrict__ n2;  // (N,) device memory
  const float* q;                // (D,) shared memory
  float qn;                      // |q|^2
  int d;
  __device__ __forceinline__ float operator()(int c) const {
    const float* xv = x + (size_t)c * d;
    float dot = 0.f;
    for (int i = 0; i < d; ++i) dot = __fadd_rn(dot, __fmul_rn(xv[i], q[i]));
    return fmaxf(__fadd_rn(__fsub_rn(n2[c], __fmul_rn(2.f, dot)), qn), 0.f);
  }
};

__global__ void __launch_bounds__(1024) beam_hops_l2_kernel(
    const int32_t* __restrict__ adj, const float* __restrict__ x,
    const float* __restrict__ n2, const float* __restrict__ queries,
    const float* __restrict__ qn, const int32_t* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const uint8_t* __restrict__ pool_exp,
    beam::Outputs out, int l, int r, int d, int max_hops) {
  extern __shared__ float smem[];
  float* s_q = smem;                                         // d
  const float* q = queries + (size_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s_q[i] = q[i];
  const L2Score score{x, n2, s_q, qn[blockIdx.x], d};
  beam::hop_loop(adj, score, pool_ids, pool_d, pool_exp, out, s_q + d, l, r,
                 max_hops);
}

}  // namespace

extern "C" size_t beam_hops_l2_smem_bytes(int l, int r, int d) {
  return (size_t)d * 4 + beam::pool_smem_bytes(l, r);
}

extern "C" int beam_hops_l2_launch(
    const int32_t* adj, const float* x, const float* n2, const float* queries,
    const float* qn, const int32_t* pool_ids, const float* pool_d,
    const uint8_t* pool_exp, int32_t* out_ids, float* out_d, uint8_t* out_exp,
    int32_t* out_hops, int32_t* trace_ids, float* trace_d, int32_t* next_id,
    uint8_t* done, int b, int l, int r, int d, int max_hops, void* stream) {
  const size_t smem = beam_hops_l2_smem_bytes(l, r, d);
  cudaError_t err = prepare((const void*)beam_hops_l2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const beam::Outputs out{out_ids, out_d,  out_exp, out_hops,
                          trace_ids, trace_d, next_id, done};
  beam_hops_l2_kernel<<<b, beam::threads_for(l, r), smem,
                        (cudaStream_t)stream>>>(
      adj, x, n2, queries, qn, pool_ids, pool_d, pool_exp, out, l, r, d,
      max_hops);
  return (int)cudaGetLastError();
}
