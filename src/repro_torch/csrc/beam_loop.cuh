// The fused beam-hop loop of both beam-hop kernels, for Hopper (sm_90a):
// beam_hops_adc.cu (ADC scores, the batched query path) and beam_hops_l2.cu
// (exact L2, the construction frontier).  `hop_loop` is a template over a
// scorer, the only difference between the two.
//
// It is the body of the Pallas `_hop_loop` with `_merge_ranked`
// (repro/kernels/beam_fused/kernel.py), and is bitwise equal to the plain
// version (kernels/beam_fused/ref.py, `beam_hops_ref`) on all eight outputs.
// One CTA per query row.  Each hop picks the first unexpanded, valid,
// finite pool slot (the pool is sorted by (dist, id), so this is the
// reference's argmin), reads adj[v, :], scores each valid neighbour, and
// merges the neighbours into the pool by the rank rules of
// pool_merge_ranked (build/pool.py): a neighbour whose id is in the pool or
// at an earlier candidate is dropped; a pool entry moves to its index plus
// the count of candidates below it, a candidate to the count of candidates
// below it plus the count of pool entries at or below it, with (dist, id)
// compared lexicographically and -1 ranked as INT32_MAX; ranks >= L fall
// off.  A row with no frontier left stops: its trace tail is (-1, +inf).
//
// What bounds it: a dependent latency chain, not bytes.  Every hop waits
// on the last: the pick, then an adjacency row, then the neighbours' rows
// (codes or vectors), then the merge that sets the next pick.  At the main
// shapes a CTA is one warp, so the latency of every dependent step between
// the loads shows; the design keeps those steps few and parallel:
//   1. De-duplication by hash.  Each pool id is written into two direct-
//      mapped tables in shared memory (power-of-two sizes >= 8 L, or 4 L
//      past L = 512; a slot is one 8-byte word (hop << 32) | id, so a slot
//      from an earlier hop reads as free and nothing is cleared) as the
//      merge writes it.  Under the next adjacency load each id reads its
//      two slots back; one that lost both to other ids goes to its warp's
//      overflow list.  A candidate reads its two slots under its scoring
//      operands' loads (the overflow lists only when other ids hold both),
//      in place of the L + R comparisons of a serial scan.  Copies among
//      the candidates: __match_any_sync keeps the lowest lane of a warp;
//      with more than one warp of candidates, a later warp's copy of an id
//      that an earlier warp holds is dropped after a first ranking.  Which
//      copy survives does not matter: copies have equal (dist, id).  No
//      shared-memory atomics: on an H100 a warp's atomicCAS on 32 addresses
//      took about 500 cycles.
//   2. Merge ranks in log time.  A warp's candidates are ranked among
//      themselves in one step (each compares its (dist, id), packed into a
//      63-bit integer, with all 32) and stored sorted; then each thread
//      finds by merge path (a binary search over at most R entries) where
//      its own pool slots fall in the merged order, and writes them: pool
//      entries go first on a tie.
//   3. The next pick falls out of the merge (the least new slot of an entry
//      still to expand); where the CTA is one warp (R <= 32, L <= 128: the
//      main paths) it stays in registers and every barrier is a __syncwarp.
//
// The scorer's hooks, each called by every thread of the CTA, outside any
// condition (a warp-wide intrinsic that some lanes skip hangs the card):
//   stage()          at the start: copy the row's operands to shared
//                    memory (the loop waits on cp.async and a barrier);
//   issue(c)         before the hash probe, so that the probe runs under
//                    the load: start loading candidate c's operands (c is
//                    -1 for a lane without a valid neighbour);
//   score(c, keep, issued)  after the probe: c's distance, used only where
//                    `keep`.  A distance must never be -0 (see order_key).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace beam {

constexpr int kSent = 0x7fffffff;   // rank key of the -1 id
constexpr int kMaxSlots = 4;        // pool slots a thread owns
constexpr int kMaxWarps = 8;        // 256 threads
constexpr unsigned kFull = 0xffffffffu;

// A pool entry or candidate: its dist and its rank key (the id, or kSent).
struct Entry {
  float d;
  int key;
};

__device__ __forceinline__ Entry none() { return Entry{INFINITY, kSent}; }

// (a.d, a.key) < (b.d, b.key), without branches: a data-dependent branch
// splits the warp, and its halves then run one after the other
__device__ __forceinline__ bool lt(Entry a, Entry b) {
  return (a.d < b.d) | ((a.d == b.d) & (a.key < b.key));
}

// Threads a CTA: enough for one candidate each and at most kMaxSlots pool
// slots each, a whole number of warps.
__host__ __device__ inline int threads_for(int l, int r) {
  const int slots = (l + kMaxSlots - 1) / kMaxSlots;
  const int need = r > slots ? r : slots;
  return need > 32 ? (need + 31) / 32 * 32 : 32;
}

// log2 of each id table's slots: a power of two >= 8 L (>= 4 L from
// L = 513 on, to fit shared memory), at least 64.
__host__ __device__ inline int table_log2(int l) {
  int s = 6;
  while ((1 << s) < 8 * l && s < 12) ++s;
  return s;
}

// Bytes of shared memory the loop uses, a multiple of 16; the scorer's
// region follows.
__host__ __device__ inline size_t loop_smem_bytes(int l, int r) {
  const size_t segs = (size_t)(r + 31) / 32 * 32;
  const size_t bytes =
      (2 * (size_t)l + 2 * segs) * sizeof(Entry)  // pools, candidates
      + ((size_t)2 << table_log2(l)) * 8          // the id tables
      + (size_t)threads_for(l, r) * kMaxSlots * 4 // overflow lists
      + 2 * (size_t)l;                            // expanded flags
  return (bytes + 15) / 16 * 16;
}

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

__device__ __forceinline__ void block_sync(int nt) {
  if (nt == 32) __syncwarp();
  else __syncthreads();
}

// The id tables: one 64-bit word a slot, (hop << 32) | id, written and
// read whole (one 8-byte access).  An id has a slot in each of the two.
__device__ __forceinline__ unsigned slot1(int key, int log2) {
  return ((unsigned)key * 0x9E3779B1u) >> (32 - log2);
}

__device__ __forceinline__ unsigned slot2(int key, int log2) {
  return ((unsigned)key * 0x85EBCA6Bu) >> (32 - log2);
}

__device__ __forceinline__ void put(long long* tab, unsigned at, int key,
                                    int hop) {
  tab[at] =
      (long long)((unsigned long long)(unsigned)hop << 32 | (unsigned)key);
}

__device__ __forceinline__ int2 get(const long long* tab, unsigned at) {
  const long long v = tab[at];
  return make_int2((int)(unsigned)v, (int)(v >> 32));   // (id, hop)
}

// A candidate's (d, key) as one 63-bit integer in the same order: the
// bits of d made monotone, then the key.  Exact only if no candidate's d
// is -0 (whose order would differ from +0's): each scorer says why its
// distances never are.
__device__ __forceinline__ unsigned long long order_key(Entry e) {
  const unsigned u = __float_as_uint(e.d);
  const unsigned o = u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
  return (unsigned long long)o << 31 | (unsigned)e.key;
}

// Entries of a sorted warp of candidates below e, by binary search.
__device__ __forceinline__ int count_lt32(const Entry* seg, Entry e) {
  int n = 0;   // min(count, 31) after the halving steps
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    n += lt(seg[n + step - 1], e) ? step : 0;
  return n + lt(seg[n], e);
}

__device__ __forceinline__ bool to_expand(Entry e, uint8_t x) {
  return !x && e.key != kSent && e.d < INFINITY;
}

// The least v of the CTA; *word holds at most that of every v beforehand
// (it is used only when the CTA has several warps).  Ends with a barrier.
__device__ __forceinline__ int block_min(int v, int* word, int nt, int lane) {
  v = __reduce_min_sync(kFull, v);
  if (nt == 32) {
    __syncwarp();
    return v;
  }
  if (lane == 0) atomicMin(word, v);
  __syncthreads();
  return *word;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(at), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(at), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The CTA copies n floats to shared memory: 16-byte cp.async where both
// ends allow (dst is 16-byte aligned), plain loads otherwise.
__device__ __forceinline__ void copy_to_shared(float* dst, const float* src,
                                               int n) {
  const int t = threadIdx.x;
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = 4 * t; i < n; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = t; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Run `max_hops` hops for row blockIdx.x.  `smem` holds loop_smem_bytes(l,
// r) bytes for the loop; the scorer's own region lies beyond them.
template <class Scorer>
__device__ __forceinline__ void hop_loop(
    const int32_t* __restrict__ adj, Scorer& sc,
    const int32_t* __restrict__ pool_ids, const float* __restrict__ pool_d,
    const uint8_t* __restrict__ pool_exp, const Outputs& out,
    unsigned char* smem, int l, int r, int max_hops, int log2) {
  const int nt = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nseg = (r + 31) / 32, cap = 1 << log2;
  const int ovf_at = warp * 32 * kMaxSlots;
  Entry* s_pool = reinterpret_cast<Entry*>(smem);               // 2 * l
  Entry* s_seg = s_pool + 2 * l;        // nseg * 32: each warp's, sorted
  Entry* s_cand = s_seg + nseg * 32;    // nseg * 32: scratch, then sorted
  long long* s_ids = reinterpret_cast<long long*>(s_cand + nseg * 32);
  long long* s_ids2 = s_ids + cap;                              // 2 * cap
  int* s_ovf = reinterpret_cast<int*>(s_ids2 + cap);     // nt * kMaxSlots
  uint8_t* s_ex = reinterpret_cast<uint8_t*>(s_ovf + nt * kMaxSlots);  // 2 l
  __shared__ int s_next[2];   // the next pick of each pool buffer (> 1 warp)
  __shared__ int s_novf[kMaxWarps];    // ids in each warp's overflow list
  __shared__ int s_nvalid[kMaxWarps];  // candidates each warp keeps
  const int b = blockIdx.x;
  // thread t owns the pool slots [d0, d0 + own): it hashes their ids and
  // writes them in the merge
  const int per = (l + nt - 1) / nt;
  const int d0 = min(t * per, l), own = min(per, l - d0);

  sc.stage();
  for (int i = t; i < 2 * cap; i += nt) put(s_ids, i, kSent, -1);
  for (int i = t; i < l; i += nt) {
    const size_t at = (size_t)b * l + i;
    const int id = pool_ids[at];
    s_pool[i] = Entry{pool_d[at], id < 0 ? kSent : id};
    s_ex[i] = pool_exp[at] != 0;
  }
  if (t == 0) s_next[0] = l;
  cp_async_wait_all();
  __syncthreads();
  Entry pe[kMaxSlots];   // the entries of the thread's slots
  int first = l;
#pragma unroll
  for (int q = 0; q < kMaxSlots; ++q) {
    pe[q] = q < own ? s_pool[d0 + q] : none();
    if (q < own && to_expand(pe[q], s_ex[d0 + q])) first = min(first, d0 + q);
    if (pe[q].key != kSent) {   // hash the ids for hop 0
      put(s_ids, slot1(pe[q].key, log2), pe[q].key, 0);
      put(s_ids2, slot2(pe[q].key, log2), pe[q].key, 0);
    }
  }
  int jn = block_min(first, s_next, nt, lane);   // the next pick

  int cur = 0, h = 0;
  for (; h < max_hops; ++h) {
    const int j = jn;
    if (j >= l) break;   // no frontier left: every later hop is a no-op
    const Entry* pool = s_pool + cur * l;
    Entry* npool = s_pool + (1 - cur) * l;
    uint8_t* ex = s_ex + cur * l;
    uint8_t* nex = s_ex + (1 - cur) * l;
    const Entry pick = pool[j];

    // the hop's dependent chain starts: the adjacency row
    int c = -1;
    if (t < r) c = __ldg(adj + (size_t)pick.key * r + t);
    if (t == 0) {
      ex[j] = 1;
      s_next[1 - cur] = l;
      out.trace_ids[(size_t)b * max_hops + h] = pick.key;
      out.trace_d[(size_t)b * max_hops + h] = pick.d;
    }

    // under it: the pool's ids were hashed at the end of the last hop; an
    // id that lost both its slots goes to the warp's overflow list
    int novf = 0;
#pragma unroll
    for (int q = 0; q < kMaxSlots; ++q) {
      if (q == per) break;   // at the same q in every lane
      const int key = pe[q].key;
      const bool lose = (q < own) & (key != kSent) &
                        (get(s_ids, slot1(key, log2)).x != key) &
                        (get(s_ids2, slot2(key, log2)).x != key);
      const unsigned who = __ballot_sync(kFull, lose);
      if (lose) s_ovf[ovf_at + novf + __popc(who & ((1u << lane) - 1))] = key;
      novf += __popc(who);
    }
    if (lane == 0) s_novf[warp] = novf;
    block_sync(nt);

    // the candidates' scoring operands, and under them the probes
    const typename Scorer::Issued issued = sc.issue(c);
    bool keep = false;
    if (c >= 0) {
      const int2 e1 = get(s_ids, slot1(c, log2));
      const int2 e2 = get(s_ids2, slot2(c, log2));
      // a slot no pool id stamped this hop: c is not in the pool
      const bool hit = ((e1.y == h) & (e1.x == c)) | ((e2.y == h) & (e2.x == c));
      keep = !hit;
      if (!hit && e1.y == h && e2.y == h)   // c may have lost both slots
        for (int w = 0; w < nt / 32; ++w)
          for (int q = 0; q < s_novf[w]; ++q)
            keep &= s_ovf[w * 32 * kMaxSlots + q] != c;
    }
    const unsigned same = __match_any_sync(kFull, c);   // every lane
    keep &= __ffs(same) - 1 == lane;
    const float dist = sc.score(c, keep, issued);        // every lane
    Entry ce = keep ? Entry{dist, c} : none();

    // rank the warp's candidates among themselves (all 32 keys compared at
    // once) and store them sorted; with several warps, drop a later warp's
    // copy of an id, rank again, and sort all warps' candidates into one run
    int rank = 0;
    for (int pass = 0;; ++pass) {
      if (warp < nseg) {
        const unsigned long long key = order_key(ce);
        unsigned long long* keys =
            reinterpret_cast<unsigned long long*>(s_cand + 32 * warp);
        keys[lane] = key;
        __syncwarp();
        unsigned part[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < 16; ++q) {   // 63-bit keys: the borrow is bit 63
          const ulonglong2 two = reinterpret_cast<const ulonglong2*>(keys)[q];
          part[q & 3] += (unsigned)((two.x - key) >> 63) +
                         (unsigned)((two.y - key) >> 63);
        }
        rank = (int)(part[0] + part[1] + part[2] + part[3]);
        const unsigned unused = __ballot_sync(kFull, ce.key == kSent);
        if (ce.key == kSent)   // equal entries: these take the tail by lane
          rank = 32 - __popc(unused) + __popc(unused & ((1u << lane) - 1));
        s_seg[32 * warp + rank] = ce;
        if (lane == 0) s_nvalid[warp] = 32 - __popc(unused);
      }
      block_sync(nt);
      if (nseg == 1 || pass == 1) break;
      bool dup = false;
      if (warp < nseg && ce.key != kSent)
        for (int w = 0; w < warp; ++w) {
          const int n = count_lt32(s_seg + 32 * w, ce);
          dup |= (n < 32) & (s_seg[32 * w + min(n, 31)].key == ce.key);
        }
      block_sync(nt);   // every warp has read the segments
      if (dup) ce = none();
    }
    const Entry* cs = s_seg;   // the kept candidates, sorted
    int nb = 0;
    for (int w = 0; w < nseg; ++w) nb += s_nvalid[w];
    if (nseg > 1) {
      if (warp < nseg && ce.key != kSent) {
        int at = rank;
        for (int w = 0; w < nseg; ++w)
          if (w != warp) at += count_lt32(s_seg + 32 * w, ce);
        s_cand[at] = ce;
      }
      block_sync(nt);
      cs = s_cand;
    }

    // merge by merge path: of the merged run's first d0 entries, ia come
    // from the pool (which goes first on a tie); then the thread writes
    // its slots in order, and hashes their ids for the next hop
    int ia = max(0, d0 - nb);
    for (int step = nb > 0 ? 1 << (31 - __clz(nb)) : 0; step > 0; step >>= 1) {
      const int mid = ia + step;   // the pool's entry mid - 1 goes before
      const bool ok = (mid <= d0) &  // the candidate d0 - mid
                      !lt(cs[max(d0 - mid, 0)], pool[min(mid, l) - 1]);
      ia = ok ? mid : ia;
    }
    int ib = d0 - ia;
    int best = l;
#pragma unroll
    for (int q = 0; q < kMaxSlots; ++q) {
      if (q < own) {
        const Entry a = ia < l ? pool[ia] : none();
        const Entry e = ib < nb ? cs[ib] : none();
        const bool from_pool = !lt(e, a);
        const uint8_t x = from_pool ? ex[ia] : 0;
        pe[q] = from_pool ? a : e;
        ia += from_pool;
        ib += !from_pool;
        npool[d0 + q] = pe[q];
        nex[d0 + q] = x;
        if (to_expand(pe[q], x)) best = min(best, d0 + q);
        if (pe[q].key != kSent) {
          put(s_ids, slot1(pe[q].key, log2), pe[q].key, h + 1);
          put(s_ids2, slot2(pe[q].key, log2), pe[q].key, h + 1);
        }
      }
    }
    jn = block_min(best, s_next + 1 - cur, nt, lane);
    cur = 1 - cur;
  }

  // rows that ran out of frontier at hop h: the trace tail is (-1, +inf)
  for (int hh = h + t; hh < max_hops; hh += nt) {
    out.trace_ids[(size_t)b * max_hops + hh] = -1;
    out.trace_d[(size_t)b * max_hops + hh] = INFINITY;
  }
  const Entry* pool = s_pool + cur * l;
  for (int i = t; i < l; i += nt) {
    const size_t at = (size_t)b * l + i;
    const Entry e = pool[i];
    out.ids[at] = e.key == kSent ? -1 : e.key;
    out.d[at] = e.d;
    out.exp[at] = s_ex[cur * l + i];
  }
  if (t == 0) {
    out.hops[b] = h;
    out.next_id[b] = jn < l ? pool[jn].key : -1;
    out.done[b] = jn >= l;
  }
}

}  // namespace beam
