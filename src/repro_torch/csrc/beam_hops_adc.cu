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
// Nor does it carry ids as exact f32 (the TPU's N < 2^24 cap): ids are
// int32 throughout.
//
// One CTA per query row, one thread per pool slot (blockDim = max(L, R)
// rounded up to a warp).  Shared memory holds the row's (M, K) ADC table,
// a double-buffered (L) pool of ids, dists and expanded flags, and the (R)
// candidates.  Each hop:
//   1. pick the first unexpanded, valid, finite slot -- the pool is sorted
//      by (dist, id), so this is the reference's argmin -- and mark it;
//   2. read adj[v, :] from device memory (-1 pads stay -1);
//   3. score each valid neighbour: sum_m table[m][code[m]] for m = 0, 1, ...
//      in order, as the plain version (kernels/pq_adc/ref.py) does;
//   4. merge by the rank rules of pool_merge_ranked (build/pool.py): drop
//      duplicates of the pool and of earlier candidates, rank by (dist, id)
//      with -1 as INT32_MAX, and write each entry to its rank's slot of the
//      other pool buffer (ranks are a bijection onto [0, L + R));
//   5. record the trace id and dist.
// A row with no frontier left stops: every later hop would be a no-op, so
// its trace tail is (-1, +inf).  After the loop the kernel emits the next
// pick and the done flag.
//
// What bounds it: memory.  The least traffic is the tables, the pool in and
// out, the traces, and per hop one adjacency row (R*4 bytes) plus the codes
// of its valid neighbours (M bytes each).  Each hop waits on two dependent
// device-memory round trips (adjacency, then codes), so at B = 64 rows
// (64 of 132 SMs busy) latency, not bandwidth, sets the time.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  The entry
// point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kSent = 0x7fffffff;   // -1 ids rank after every valid id

__device__ __forceinline__ int rank_key(int id) { return id < 0 ? kSent : id; }

// (da, ka) < (db, kb) lexicographically
__device__ __forceinline__ bool lex_lt(float da, int ka, float db, int kb) {
  return da < db || (da == db && ka < kb);
}

// Index of the first unexpanded, valid, finite pool slot, or l if none.
__device__ __forceinline__ int pick(const int32_t* ids, const float* d,
                                    const int32_t* ex, int l, int* s_pick) {
  const int t = threadIdx.x;
  __syncthreads();   // every thread has read the previous pick
  if (t == 0) *s_pick = l;
  __syncthreads();
  if (t < l && !ex[t] && ids[t] >= 0 && d[t] < INFINITY) atomicMin(s_pick, t);
  __syncthreads();
  return *s_pick;
}

__global__ void __launch_bounds__(1024) beam_hops_adc_kernel(
    const int32_t* __restrict__ adj, const uint8_t* __restrict__ codes,
    const float* __restrict__ tables, const int32_t* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const uint8_t* __restrict__ pool_exp,
    int32_t* __restrict__ out_ids, float* __restrict__ out_d,
    uint8_t* __restrict__ out_exp, int32_t* __restrict__ out_hops,
    int32_t* __restrict__ trace_ids, float* __restrict__ trace_d,
    int32_t* __restrict__ next_id, uint8_t* __restrict__ done, int l, int r,
    int m, int k, int max_hops) {
  extern __shared__ float smem[];
  float* s_tab = smem;                                       // m * k
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_tab + m * k);  // 2 * l
  float* s_d = reinterpret_cast<float*>(s_ids + 2 * l);        // 2 * l
  int32_t* s_ex = reinterpret_cast<int32_t*>(s_d + 2 * l);     // 2 * l
  int32_t* s_cid = s_ex + 2 * l;                               // r
  float* s_cd = reinterpret_cast<float*>(s_cid + r);           // r
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* tab = tables + (size_t)b * m * k;
  for (int i = t; i < m * k; i += blockDim.x) s_tab[i] = tab[i];
  if (t < l) {
    const size_t at = (size_t)b * l + t;
    s_ids[t] = pool_ids[at];
    s_d[t] = pool_d[at];
    s_ex[t] = pool_exp[at] != 0;
  }
  __syncthreads();

  int cur = 0;   // which half of the double-buffered pool is current
  int h = 0;
  for (; h < max_hops; ++h) {
    int32_t* ids = s_ids + cur * l;
    float* d = s_d + cur * l;
    int32_t* ex = s_ex + cur * l;
    int32_t* nids = s_ids + (1 - cur) * l;
    float* nd = s_d + (1 - cur) * l;
    int32_t* nex = s_ex + (1 - cur) * l;
    if (t < l) {   // nothing reads the other buffer before the merge
      nids[t] = -1;
      nd[t] = INFINITY;
      nex[t] = 0;
    }

    // 1. frontier pick (block-uniform: every thread reads the same slot)
    const int j = pick(ids, d, ex, l, &s_pick);
    if (j >= l) break;
    const int v = ids[j];
    if (t == 0) {
      ex[j] = 1;
      trace_ids[(size_t)b * max_hops + h] = v;
      trace_d[(size_t)b * max_hops + h] = d[j];
    }

    // 2-3. adjacency gather and ADC score
    int c = -1;
    float cd = INFINITY;
    if (t < r) {
      c = adj[(size_t)v * r + t];
      if (c >= 0) {
        const uint8_t* cc = codes + (size_t)c * m;
        cd = 0.f;
        for (int q = 0; q < m; ++q) cd += s_tab[q * k + cc[q]];
      }
      s_cid[t] = c;
    }
    __syncthreads();

    // 4a. drop candidates duplicating the pool or an earlier candidate
    if (t < r && c >= 0) {
      bool keep = true;
      for (int i = 0; keep && i < l; ++i) keep = ids[i] != c;
      for (int i = 0; keep && i < t; ++i) keep = s_cid[i] != c;
      if (!keep) {
        c = -1;
        cd = INFINITY;
      }
    }
    __syncthreads();
    if (t < r) {
      s_cid[t] = c;
      s_cd[t] = cd;
    }
    __syncthreads();

    // 4b. merge ranks, then write each entry to its slot
    if (t < l) {
      const float pd = d[t];
      const int pk = rank_key(ids[t]);
      int pos = t;
      for (int i = 0; i < r; ++i) pos += lex_lt(s_cd[i], rank_key(s_cid[i]), pd, pk);
      if (pos < l) {
        nids[pos] = ids[t];
        nd[pos] = pd;
        nex[pos] = ex[t];
      }
    }
    if (t < r) {
      const int ck = rank_key(c);
      int pos = 0;
      for (int i = 0; i < l; ++i) pos += !lex_lt(cd, ck, d[i], rank_key(ids[i]));
      for (int i = 0; i < r; ++i) {
        const float od = s_cd[i];
        const int ok = rank_key(s_cid[i]);
        pos += od < cd || (od == cd && (ok < ck || (ok == ck && i < t)));
      }
      if (pos < l) {
        nids[pos] = c;
        nd[pos] = cd;
        nex[pos] = 0;
      }
    }
    __syncthreads();
    cur = 1 - cur;
  }

  // rows that ran out of frontier at hop h: the trace tail is (-1, +inf)
  for (int hh = h + t; hh < max_hops; hh += blockDim.x) {
    trace_ids[(size_t)b * max_hops + hh] = -1;
    trace_d[(size_t)b * max_hops + hh] = INFINITY;
  }
  const int32_t* ids = s_ids + cur * l;
  const int32_t* ex = s_ex + cur * l;
  const float* d = s_d + cur * l;
  const int j = pick(ids, d, ex, l, &s_pick);
  if (t < l) {
    const size_t at = (size_t)b * l + t;
    out_ids[at] = ids[t];
    out_d[at] = d[t];
    out_exp[at] = (uint8_t)ex[t];
  }
  if (t == 0) {
    out_hops[b] = h;
    next_id[b] = j < l ? ids[j] : -1;
    done[b] = j >= l;
  }
}

}  // namespace

extern "C" size_t beam_hops_adc_smem_bytes(int l, int r, int m, int k) {
  return ((size_t)m * k + 6 * (size_t)l + 2 * (size_t)r) * 4;
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
  const int width = l > r ? l : r;
  const int threads = (width + 31) / 32 * 32;
  beam_hops_adc_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      adj, codes, tables, pool_ids, pool_d, pool_exp, out_ids, out_d, out_exp,
      out_hops, trace_ids, trace_d, next_id, done, l, r, m, k, max_hops);
  return (int)cudaGetLastError();
}
