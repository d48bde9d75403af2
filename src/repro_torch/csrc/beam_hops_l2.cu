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
// The hop loop (pick, adjacency gather, hashed de-duplication, merge-path
// merge, trace) is beam_loop.cuh's, shared with the ADC kernel
// (beam_hops_adc.cu).  This file adds exact-L2 scoring: the row's query is
// staged whole in shared memory, and a valid neighbour c scores
//     max((n2[c] - 2 * dot) + |q|^2, 0),  dot = sum_i x[c][i] * q[i]
// with the dot summed over i = 0, 1, ... in order and every operation
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: nothing contracts
// into an FMA), the order the plain version (kernels/beam_fused/ref.py,
// `l2_score`) repeats, so the two agree bitwise.  |q|^2 comes from the
// wrapper, computed by the plain version's function (`sq_norms`), so it is
// +0 or positive; a rounded sum is -0 only if both terms are, so no
// distance is -0, as the loop's 63-bit rank keys need.
//
// What bounds it: a dependent latency chain (beam_loop.cuh).  A hop waits
// on an adjacency row, then on its neighbours' vector rows (x is far larger
// than the 50 MB L2 cache, so both come from device memory), then on a
// D-step chain of dependent adds that the summation order fixes.  So the
// rows are all asked for at once, before the hash probe so that the probe
// runs under the load: each lane hands its own candidate's row to the copy
// engine (TMA) as one bulk copy into the warp's rows in shared memory,
// completing on the lane's own mbarrier, and then sums that row from
// there.  (On an H100 a warp that copied its 32 rows by 16-byte cp.async,
// one row a warp instruction, spent most of a hop issuing the copies.)  A
// row is staged in chunks of at most 128 floats, so that shared memory per
// warp does not grow with D; the stride between staged rows is an odd
// number of 16-byte units, so that each quarter-warp's 16-byte reads fall
// on distinct banks.  Where D % 4 != 0 or x is not 16-byte aligned, the
// warp copies each row in turn by 4-byte cp.async (the ids by shuffle),
// and the stride is an odd number of floats.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  The entry
// point returns cudaGetLastError() after its launch.
#include "beam_loop.cuh"
#include "launch.cuh"

namespace {

constexpr int kChunk = 128;             // floats of a row staged at a time
constexpr size_t kMaxSmem = 232448;     // kernels/_build.py MAX_SMEM_BYTES

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A one-thread mbarrier: the thread arrives once a phase, announcing the
// bytes its bulk copy will bring; the phase completes when they have come.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes from global src to shared dst by the copy engine (TMA), completing
// on *bar; both ends 16-byte aligned, bytes a multiple of 16.  The proxy
// fence orders the thread's earlier reads of dst before the copy's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// dot + row[i] * q[i] for i = 0 .. n-1 in order, every operation rounded
// on its own; 16-byte reads (n % 4 == 0, both 16-byte aligned)
__device__ __forceinline__ float dot4(float dot, const float* row,
                                      const float* q, int n) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + i);
    const float4 w = *reinterpret_cast<const float4*>(q + i);
    dot = __fadd_rn(dot, __fmul_rn(a.x, w.x));
    dot = __fadd_rn(dot, __fmul_rn(a.y, w.y));
    dot = __fadd_rn(dot, __fmul_rn(a.z, w.z));
    dot = __fadd_rn(dot, __fmul_rn(a.w, w.w));
  }
  return dot;
}

struct L2Scorer {
  const float* __restrict__ x;       // (N, D) device memory
  const float* __restrict__ n2;      // (N,) device memory
  const float* __restrict__ query;   // the row's (D,) in device memory
  float* q;                          // its copy in shared memory
  float* rows;                       // the warp's 32 rows, `stride` apart
  uint64_t* bar;                     // the thread's mbarrier (vec)
  float qn;                          // |q|^2
  int d, chunk, stride;
  bool vec;                          // bulk copies, 16-byte reads
  unsigned parity = 0;               // of the thread's next phase (vec)

  struct Issued {
    float n2;   // n2[c] of the lane's candidate
  };

  __device__ __forceinline__ void stage() {
    beam::copy_to_shared(q, query, d);
    if (vec) bar_init(bar);
  }

  // x[c][c0, c0 + n) of the warp's 32 candidates into their rows (lane j's
  // candidate into row j).  vec: each lane's bulk copy of its own row;
  // else the warp copies each row in turn, 4 bytes a lane.  Called by
  // every lane.
  __device__ __forceinline__ void fetch(int c, int c0, int n) {
    const int lane = threadIdx.x & 31;
    if (vec) {   // the same in every thread
      if (c >= 0)
        bulk_copy(rows + lane * stride, x + (size_t)c * d + c0, n * 4, bar);
      return;
    }
    for (int j = 0; j < 32; ++j) {
      const int id = __shfl_sync(beam::kFull, c, j);
      if (id >= 0) {   // the same in every lane
        const float* src = x + (size_t)id * d + c0;
        float* dst = rows + j * stride;
        for (int i = lane; i < n; i += 32) beam::cp_async4(dst + i, src + i);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  __device__ __forceinline__ Issued issue(int c) {
    fetch(c, 0, min(d, chunk));
    return Issued{c >= 0 ? __ldg(n2 + c) : 0.f};
  }

  __device__ __forceinline__ float score(int c, bool, const Issued& is) {
    const float* row = rows + (threadIdx.x & 31) * stride;
    float dot = 0.f;
    for (int c0 = 0; c0 < d; c0 += chunk) {
      const int n = min(chunk, d - c0);
      if (c0 > 0) {   // every lane has summed the last chunk
        __syncwarp();
        fetch(c, c0, n);
      }
      if (vec) {
        if (c >= 0) {
          bar_wait(bar, parity);
          parity ^= 1;
        }
      } else {
        beam::cp_async_wait_all();
        __syncwarp();
      }
      if (c < 0) continue;   // no row staged
      const float* qc = q + c0;
      if (vec)   // a whole chunk's loop unrolled whole
        dot = n == kChunk ? dot4(dot, row, qc, kChunk) : dot4(dot, row, qc, n);
      else
        for (int i = 0; i < n; ++i)
          dot = __fadd_rn(dot, __fmul_rn(row[i], qc[i]));
    }
    return fmaxf(__fadd_rn(__fsub_rn(is.n2, __fmul_rn(2.f, dot)), qn), 0.f);
  }
};

// Floats between staged rows: an odd count of 16-byte units, or of floats
// on the 4-byte path.
inline int stride_for(int chunk, bool vec) {
  if (vec) return chunk / 4 % 2 ? chunk : chunk + 4;
  return chunk % 2 ? chunk : chunk + 1;
}

// The scorer's region: the query, one mbarrier a thread, the rows.
__host__ __device__ inline size_t bars_at(int d) {
  return (size_t)(d + 3) / 4 * 16;
}

__host__ __device__ inline size_t rows_at(int l, int r, int d) {
  return bars_at(d) + (size_t)beam::threads_for(l, r) * 8;
}

inline size_t smem_for(int l, int r, int d, int chunk) {
  const size_t warps = (size_t)(r + 31) / 32;
  return beam::loop_smem_bytes(l, r) + rows_at(l, r, d)
         + warps * 32 * (chunk + 4) * 4;
}

// The chunk: kChunk floats, or D if less, halved (to no less than 32)
// while shared memory would exceed the limit.
inline int chunk_for(int l, int r, int d) {
  int chunk = d < kChunk ? d : kChunk;
  while (chunk > 32 && smem_for(l, r, d, chunk) > kMaxSmem)
    chunk = chunk / 2 / 4 * 4 > 32 ? chunk / 2 / 4 * 4 : 32;
  return chunk;
}

__global__ void __launch_bounds__(256, 1) beam_hops_l2_kernel(
    const int32_t* __restrict__ adj, const float* __restrict__ x,
    const float* __restrict__ n2, const float* __restrict__ queries,
    const float* __restrict__ qn, const int32_t* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const uint8_t* __restrict__ pool_exp,
    beam::Outputs out, int l, int r, int d, int chunk, int stride, int vec,
    int max_hops, int log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* own = smem + beam::loop_smem_bytes(l, r);
  float* s_rows = reinterpret_cast<float*>(own + rows_at(l, r, d));
  L2Scorer sc{x,
              n2,
              queries + (size_t)blockIdx.x * d,
              reinterpret_cast<float*>(own),
              s_rows + (threadIdx.x >> 5) * 32 * stride,
              reinterpret_cast<uint64_t*>(own + bars_at(d)) + threadIdx.x,
              qn[blockIdx.x],
              d,
              chunk,
              stride,
              vec != 0};
  beam::hop_loop(adj, sc, pool_ids, pool_d, pool_exp, out, smem, l, r,
                 max_hops, log2);
}

}  // namespace

extern "C" size_t beam_hops_l2_smem_bytes(int l, int r, int d) {
  return smem_for(l, r, d, chunk_for(l, r, d));
}

extern "C" int beam_hops_l2_launch(
    const int32_t* adj, const float* x, const float* n2, const float* queries,
    const float* qn, const int32_t* pool_ids, const float* pool_d,
    const uint8_t* pool_exp, int32_t* out_ids, float* out_d, uint8_t* out_exp,
    int32_t* out_hops, int32_t* trace_ids, float* trace_d, int32_t* next_id,
    uint8_t* done, int b, int l, int r, int d, int max_hops, void* stream) {
  const int chunk = chunk_for(l, r, d);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = smem_for(l, r, d, chunk);
  cudaError_t err = prepare((const void*)beam_hops_l2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const beam::Outputs out{out_ids, out_d,  out_exp, out_hops,
                          trace_ids, trace_d, next_id, done};
  beam_hops_l2_kernel<<<b, beam::threads_for(l, r), smem,
                        (cudaStream_t)stream>>>(
      adj, x, n2, queries, qn, pool_ids, pool_d, pool_exp, out, l, r, d,
      chunk, stride_for(chunk, vec), vec, max_hops, beam::table_log2(l));
  return (int)cudaGetLastError();
}
