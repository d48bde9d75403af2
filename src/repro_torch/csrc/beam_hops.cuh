// The fused beam-hop loop shared by the ADC (serving) and exact-L2
// (construction) kernels, for Hopper (sm_90a).  Each kernel stages its own
// scoring operands in shared memory and hands `hop_loop` a scorer; the
// pick, the adjacency gather, the merge and the trace are this file's.
//
// It is the body of the Pallas `_hop_loop` (repro/kernels/beam_fused/
// kernel.py) with `_merge_ranked`: one CTA per query row, one thread per
// pool slot (blockDim = max(L, R) rounded up to a warp).  Shared memory
// holds a double-buffered (L) pool of ids, dists and expanded flags, and
// the (R) candidates.  Each hop:
//   1. pick the first unexpanded, valid, finite slot -- the pool is sorted
//      by (dist, id), so this is the reference's argmin -- and mark it;
//   2. read adj[v, :] from device memory (-1 pads stay -1);
//   3. thread t < R scores its valid neighbour with the scorer;
//   4. merge by the rank rules of pool_merge_ranked (build/pool.py): drop
//      duplicates of the pool and of earlier candidates, rank by (dist, id)
//      with -1 as INT32_MAX, and write each entry to its rank's slot of the
//      other pool buffer (ranks are a bijection onto [0, L + R));
//   5. record the trace id and dist.
// A row with no frontier left stops: every later hop would be a no-op, so
// its trace tail is (-1, +inf).  After the loop it emits the next pick and
// the done flag.  Ids are int32 throughout (no N < 2^24 cap).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace beam {

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

// Bytes of shared memory `hop_loop` uses (the caller adds its scorer's).
inline size_t pool_smem_bytes(int l, int r) {
  return (6 * (size_t)l + 2 * (size_t)r) * 4;
}

// The eight outputs, each indexed by the CTA's row.
struct Outputs {
  int32_t* ids;        // (B, L)
  float* d;            // (B, L)
  uint8_t* exp;        // (B, L)
  int32_t* hops;       // (B,)
  int32_t* trace_ids;  // (B, max_hops)
  float* trace_d;      // (B, max_hops)
  int32_t* next_id;    // (B,)
  uint8_t* done;       // (B,)
};

// Run `max_hops` hops for row blockIdx.x.  `score(c)` returns the distance
// of valid corpus id c; the caller has staged its operands in shared
// memory (the first __syncthreads here publishes them).  `smem` is this
// loop's region of pool_smem_bytes(l, r) bytes.
template <class Score>
__device__ __forceinline__ void hop_loop(
    const int32_t* __restrict__ adj, const Score& score,
    const int32_t* __restrict__ pool_ids, const float* __restrict__ pool_d,
    const uint8_t* __restrict__ pool_exp, const Outputs& out, float* smem,
    int l, int r, int max_hops) {
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);           // 2 * l
  float* s_d = reinterpret_cast<float*>(s_ids + 2 * l);        // 2 * l
  int32_t* s_ex = reinterpret_cast<int32_t*>(s_d + 2 * l);     // 2 * l
  int32_t* s_cid = s_ex + 2 * l;                               // r
  float* s_cd = reinterpret_cast<float*>(s_cid + r);           // r
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
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
      out.trace_ids[(size_t)b * max_hops + h] = v;
      out.trace_d[(size_t)b * max_hops + h] = d[j];
    }

    // 2-3. adjacency gather and score
    int c = -1;
    float cd = INFINITY;
    if (t < r) {
      c = adj[(size_t)v * r + t];
      if (c >= 0) cd = score(c);
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
    out.trace_ids[(size_t)b * max_hops + hh] = -1;
    out.trace_d[(size_t)b * max_hops + hh] = INFINITY;
  }
  const int32_t* ids = s_ids + cur * l;
  const int32_t* ex = s_ex + cur * l;
  const float* d = s_d + cur * l;
  const int j = pick(ids, d, ex, l, &s_pick);
  if (t < l) {
    const size_t at = (size_t)b * l + t;
    out.ids[at] = ids[t];
    out.d[at] = d[t];
    out.exp[at] = (uint8_t)ex[t];
  }
  if (t == 0) {
    out.hops[b] = h;
    out.next_id[b] = j < l ? ids[j] : -1;
    out.done[b] = j >= l;
  }
}

// Threads per CTA: one per pool slot and per candidate, a whole warp count.
inline int threads_for(int l, int r) {
  const int width = l > r ? l : r;
  return (width + 31) / 32 * 32;
}

}  // namespace beam
