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
// It is bitwise equal to the plain version (kernels/beam_fused/ref.py,
// `beam_hops_ref`) on all eight outputs.
//
// The hop loop (pick, adjacency gather, hashed de-duplication, merge-path
// merge, trace) is beam_loop.cuh's, shared with the exact-L2 kernel
// (beam_hops_l2.cu).  This file adds ADC scoring: the row's (M, K) table is
// staged in shared memory by cp.async, and a valid neighbour c scores
// sum_m table[m][codes[c][m]] over m = 0, 1, ... in order (as
// kernels/pq_adc/ref.py does).  The sum starts at +0, so it is never -0, as
// the loop's 63-bit rank keys need.
//
// What bounds it: a dependent latency chain, not bytes (beam_loop.cuh).
// On an H100 one chain of 32 adjacency-then-code loads takes 0.0167 ms,
// the floor for 32 hops; the bytes a row moves (about 2 KB a hop) would
// take nanoseconds.  A code row is one 16-byte load where M % 16 == 0 and
// the codes are aligned (4-byte or byte loads otherwise), issued before the
// hash probe so that the probe runs under it.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  The entry
// point returns cudaGetLastError() after its launch.
#include "beam_loop.cuh"
#include "launch.cuh"

namespace {

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// s + tab[i][byte i of w] for i = 0..3, in order (one rounded add a term)
__device__ __forceinline__ float add4(float s, unsigned w, const float* tab,
                                      int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s += tab[i * k + ((w >> (8 * i)) & 0xffu)];
  return s;
}

__device__ __forceinline__ float add16(float s, uint4 w, const float* tab,
                                       int k) {
  s = add4(s, w.x, tab, k);
  s = add4(s, w.y, tab + 4 * k, k);
  s = add4(s, w.z, tab + 8 * k, k);
  return add4(s, w.w, tab + 12 * k, k);
}

// sum_q tab[q][row[q]] for q = 0..m-1 in order; `first` holds row's first
// 16 bytes when vec == 16.
__device__ __forceinline__ float adc_score(const uint8_t* row, uint4 first,
                                           const float* tab, int m, int k,
                                           int vec) {
  float s = 0.f;
  if (vec == 16) {
    s = add16(s, first, tab, k);
    for (int q = 16; q < m; q += 16)
      s = add16(s, load16(row + q), tab + q * k, k);
  } else if (vec == 4) {
    for (int q = 0; q < m; q += 4)
      s = add4(s, __ldg(reinterpret_cast<const unsigned*>(row + q)),
               tab + q * k, k);
  } else {
    for (int q = 0; q < m; ++q) s += tab[q * k + row[q]];
  }
  return s;
}

struct AdcScorer {
  const uint8_t* __restrict__ codes;   // (N, M) device memory
  const float* __restrict__ table;     // the row's (M, K) in device memory
  float* tab;                          // its copy in shared memory
  int m, k, vec;

  struct Issued {
    const uint8_t* row;
    uint4 first;   // the code row's first 16 bytes when vec == 16
  };

  __device__ __forceinline__ void stage() const {
    beam::copy_to_shared(tab, table, m * k);
  }

  __device__ __forceinline__ Issued issue(int c) const {
    Issued is{codes + (size_t)max(c, 0) * m, make_uint4(0, 0, 0, 0)};
    if (c >= 0 && vec == 16) is.first = load16(is.row);
    return is;
  }

  __device__ __forceinline__ float score(int, bool keep,
                                         const Issued& is) const {
    return keep ? adc_score(is.row, is.first, tab, m, k, vec) : 0.f;
  }
};

inline size_t smem_bytes(int l, int r, int m, int k) {
  return beam::loop_smem_bytes(l, r) + (size_t)m * k * 4;
}

__global__ void __launch_bounds__(256, 1) beam_hops_adc_kernel(
    const int32_t* __restrict__ adj, const uint8_t* __restrict__ codes,
    const float* __restrict__ tables, const int32_t* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const uint8_t* __restrict__ pool_exp,
    beam::Outputs out, int l, int r, int m, int k, int max_hops, int log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vec = m % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0
                      ? 16
                      : m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0
                            ? 4 : 1;
  AdcScorer sc{
      codes, tables + (size_t)blockIdx.x * m * k,
      reinterpret_cast<float*>(smem + beam::loop_smem_bytes(l, r)), m, k, vec};
  beam::hop_loop(adj, sc, pool_ids, pool_d, pool_exp, out, smem, l, r,
                 max_hops, log2);
}

}  // namespace

extern "C" size_t beam_hops_adc_smem_bytes(int l, int r, int m, int k) {
  return smem_bytes(l, r, m, k);
}

extern "C" int beam_hops_adc_launch(
    const int32_t* adj, const uint8_t* codes, const float* tables,
    const int32_t* pool_ids, const float* pool_d, const uint8_t* pool_exp,
    int32_t* out_ids, float* out_d, uint8_t* out_exp, int32_t* out_hops,
    int32_t* trace_ids, float* trace_d, int32_t* next_id, uint8_t* done, int b,
    int l, int r, int m, int k, int max_hops, void* stream) {
  const size_t smem = smem_bytes(l, r, m, k);
  cudaError_t err = prepare((const void*)beam_hops_adc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const beam::Outputs out{out_ids, out_d,  out_exp, out_hops,
                          trace_ids, trace_d, next_id, done};
  beam_hops_adc_kernel<<<b, beam::threads_for(l, r), smem,
                         (cudaStream_t)stream>>>(
      adj, codes, tables, pool_ids, pool_d, pool_exp, out, l, r, m, k,
      max_hops, beam::table_log2(l));
  return (int)cudaGetLastError();
}
