// One-token GQA decode attention over a KV cache (split-KV flash-decode),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in repro/kernels/flash_decode/kernel.py:
//   flash_decode_pallas  (body _flash_decode_kernel)
// q (B, H, Dh) f32 or bf16; k, v (B, S, Hkv, Dh) f32 or bf16 (the cache);
// cache_len (B,) int32 -> out (B, H, Dh) f32:
//     out[b, h] = sum_j softmax_j(scale * q[b, h] . k[b, j, h / G]) v[b, j, h / G]
// over positions j < min(cache_len[b], S), G = H / Hkv; a row with no
// position gives zeros (masked scores are -1e30, their weights 0, and the
// sum is divided by max(l, 1e-30), as in the TPU kernel).  The TPU kernel
// walks a sequential (B, S / ts) grid, carries (m, l, acc) in VMEM scratch
// from one KV chunk to the next, pads S to a multiple of ts and loops over
// the Hkv heads with MXU products.  None of that carries over: CTAs run in
// no order, so the positions are split over CTAs and warps, and their
// partial softmax states merged afterwards.
//
// What bounds it: bytes.  Every cache row a row's cache_len reaches is
// read once (one decode_32k layer, B = 8, S = 32,768, Hkv = 16, Dh = 128,
// bf16: 2.15 GB of K and V, 0.64 ms at 3.35 TB/s), against 4 B H S Dh
// f32 operations (2.1 GFLOP, 0.03 ms at 67 TFLOP/s).  Keeping 3.35 TB/s
// busy at about 1 us of latency takes some 25 KB in flight on every SM at
// all times, and the loads must never wait for the math.  A design that
// stages a tile with the whole block, then computes behind barriers,
// keeps no load in flight while it computes; this one keeps the loads in
// flight and the math off their path:
//
// Split-KV.  A grid of (B * Hkv * ceil(G / 4), n_split) CTAs of 4 warps:
// CTA (x, sp) takes up to 4 query heads of one kv head of one batch row,
// and the positions [sp * chunk, (sp + 1) * chunk) below that row's
// length.  The wrapper (kernels/flash_decode/ops.py, `split_plan`) picks
// n_split from the shapes alone so that the grid is two whole waves of
// the CTAs that fit on the H100's 132 SMs (4 per SM: the rings' 48 KB of
// shared memory binds, and __launch_bounds__ holds the registers to it).
//
// A ring per warp.  The split's positions go out in stages of
// kPasses * 32 / lpr rows, stage i to warp i % 4.  A row of Dh values is
// held by lpr lanes, 16 bytes each (lpr the power of two at or above
// Dh * sizeof / 16, at most 32; 16 lanes at Dh = 128 in bf16, so a warp
// takes two rows per pass and 8 per stage).  Each lane copies exactly the
// 16-byte pieces of K and V that it will read itself, with cp.async.cg
// into its own slots of a kStages-deep ring in shared memory, in the
// cache's type.  So a lane waits only on its own copy groups
// (cp.async.wait_group) and no barrier of any kind sits in the loop:
// while a warp computes stage i, its stages i + 1 and i + 2 are in flight
// (8 KB a warp, 128 KB an SM at Dh = 128 in bf16).  A Dh or a base
// pointer that does not allow 16-byte copies fills the same ring by
// element loads (no overlap; not a serving case).
//
// Compute, per stage.  Each lane widens its K piece to f32 in registers
// and dots it with its piece of each query head (kept in registers,
// scaled), then lpr lanes sum by shuffles: one shuffle tree scores
// 32 / lpr rows.  The warp keeps (m, l, acc) per head, m warp-uniform
// (max over the stage's rows by shuffles), l and acc per group of lpr
// lanes; weights are expf(s - m), masked rows weigh 0 and their V is
// never read.  At the end of the split the groups are summed by shuffles,
// and the 4 warps merge their (m, l, acc) once through shared memory (the
// only two CTA-wide barriers) into the CTA's unnormalised partial.
//
// Combine.  A second launch, one CTA per (b, h), merges the splits by the
// log-sum-exp rule the reference writes for its sequence-sharded cache
// (models/attention.py, decode_attention_seqsharded):
//     m* = max m_i, l* = sum l_i e^(m_i - m*),
//     out = sum acc_i e^(m_i - m*) / max(l*, 1e-30).
// An empty split or warp has m = -1e30, l = 0, acc = 0 and weighs nothing.
//
// cache_len is read on the device: the wrapper never synchronises.  expf,
// not __expf, and no fast-math flag.  Dh <= 256; any G.  Tensor-core
// products for G >= 4 are later work.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  Each entry
// point returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPasses = 4;             // row passes of a warp per stage
constexpr int kStages = 3;             // depth of each warp's ring
constexpr int kMinCtas = 4;            // CTAs per SM the rings' memory allows
constexpr int kHeads = 4;              // query heads of one kv head per CTA
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

// The cache's element as raw bits, and the 16-byte piece's values.
template <typename KT>
struct Elem {
  using Bits = uint32_t;
  static constexpr int kPerVec = 4;
  __device__ static void widen(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  __device__ static float load(const void* p, size_t i) {
    return static_cast<const float*>(p)[i];
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int kPerVec = 8;
  __device__ static void widen(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // bf16 -> f32 is exact: bits << 16
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const void* p, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
};

__device__ __forceinline__ void cp_async16(uint4* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte pieces of one Dh row (host and device).
__host__ __device__ __forceinline__ int row_pieces(int dh, int per_vec) {
  return (dh + per_vec - 1) / per_vec;
}

// Partials are laid out (B, H, n_split) for m and l, (B, H, n_split, Dh)
// for acc.
template <typename KT, bool kVec16, int GC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
flash_decode_split(const void* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v,
                   const int32_t* __restrict__ cache_len,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int s, int h, int hkv,
                   int dh, int g, int n_gc, int n_split, int chunk,
                   int q_bf16, float scale) {
  using E = Elem<KT>;
  constexpr int kPer = E::kPerVec;              // values in a 16-byte piece
  constexpr int kMaxNv = sizeof(KT) == 4 ? 2 : 1;
  constexpr int kVals = kPer * kMaxNv;          // values a lane holds a row
  extern __shared__ uint4 ring[];

  const int x = blockIdx.x;
  const int gchunk = x % n_gc;
  const int n = (x / n_gc) % hkv;
  const int b = x / (n_gc * hkv);
  const int g0 = gchunk * kHeads;
  const int gc = min(kHeads, g - g0);
  const int h0 = n * g + g0;               // first query head of this CTA
  const int sp = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // lane geometry: nv pieces per lane, lpr lanes per row, 32 / lpr rows a pass
  const int pieces = row_pieces(dh, kPer);
  const int nv = pieces > 32 ? 2 : 1;
  int lpr = 32;
  if (nv == 1) {
    lpr = 1;
    while (lpr < pieces) lpr <<= 1;
  }
  const int rows_pass = 32 / lpr;
  const int rows_stage = kPasses * rows_pass;
  const int grp = lane / lpr;
  const int sub = lane - grp * lpr;

  const int len = min(max(cache_len[b], 0), s);
  const int start = sp * chunk;
  const int end = min(start + chunk, len);
  const int n_st = end > start ? (end - start + rows_stage - 1) / rows_stage
                               : 0;
  // this warp takes the split's stages warp, warp + kWarps, ...
  const int n_mine = n_st > warp ? (n_st - warp + kWarps - 1) / kWarps : 0;

  // this lane's piece of each query head, f32, scaled; 0 past Dh
  float qr[GC][kVals];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
    for (int j = 0; j < kVals; ++j) {
      const int c = j / kPer;
      const int d = (c * lpr + sub) * kPer + (j - c * kPer);
      float val = 0.0f;
      if (gi < gc && c < nv && d < dh) {
        const size_t i = ((size_t)b * h + h0 + gi) * dh + d;
        val = q_bf16 ? Elem<__nv_bfloat16>::load(q, i) : Elem<float>::load(q, i);
      }
      qr[gi][j] = val * scale;
    }
  }

  // this warp's ring: [kStages][K, V][kPasses][nv][32 lanes] pieces
  uint4* wring = ring + (size_t)warp * kStages * 2 * kPasses * nv * 32;
  const size_t stride = (size_t)hkv * dh;  // elements from one position to the next
  const KT* kb = k + ((size_t)b * s * hkv + n) * dh;
  const KT* vb = v + ((size_t)b * s * hkv + n) * dh;

  // start the copies of this warp's i-th stage into ring slot i % kStages
  auto fetch = [&](int i) {
    if (i < n_mine) {
      const int row0 = start + (warp + i * kWarps) * rows_stage;
      uint4* slot = wring + (size_t)(i % kStages) * 2 * kPasses * nv * 32;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int pos = row0 + p * rows_pass + grp;
#pragma unroll
        for (int c = 0; c < kMaxNv; ++c) {
          const int piece = c * lpr + sub;
          if (c < nv && pos < end && piece < pieces) {
            const size_t off = pos * stride + (size_t)piece * kPer;
            uint4* dk = slot + (p * nv + c) * 32 + lane;
            uint4* dv = dk + kPasses * nv * 32;
            if constexpr (kVec16) {
              cp_async16(dk, kb + off);
              cp_async16(dv, vb + off);
            } else {
              using Bits = typename E::Bits;
              union {
                uint4 u;
                Bits e[kPer];
              } pk, pv;
              pk.u = make_uint4(0u, 0u, 0u, 0u);
              pv.u = pk.u;
              const Bits* kbits = reinterpret_cast<const Bits*>(kb + off);
              const Bits* vbits = reinterpret_cast<const Bits*>(vb + off);
#pragma unroll
              for (int j = 0; j < kPer; ++j) {
                if (piece * kPer + j < dh) {
                  pk.e[j] = kbits[j];
                  pv.e[j] = vbits[j];
                }
              }
              *dk = pk.u;
              *dv = pv.u;
            }
          }
        }
      }
    }
    cp_async_commit();          // one group per stage, empty or not
  };

  float m[GC], l[GC], acc[GC][kVals];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < kVals; ++j) acc[gi][j] = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);
  for (int i = 0; i < n_mine; ++i) {
    fetch(i + kStages - 1);
    cp_async_wait<kStages - 1>();      // this lane's copies of stage i landed
    const uint4* slot = wring + (size_t)(i % kStages) * 2 * kPasses * nv * 32;
    const int row0 = start + (warp + i * kWarps) * rows_stage;

    // scores: a shuffle tree over the lpr lanes of each row
    float sc[kPasses][GC];
    bool ok[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      ok[p] = row0 + p * rows_pass + grp < end;
      float kf[kVals];
#pragma unroll
      for (int c = 0; c < kMaxNv; ++c) {
        const bool have = c < nv && ok[p] && c * lpr + sub < pieces;
        if (have) {
          E::widen(slot[(p * nv + c) * 32 + lane], kf + c * kPer);
        } else {
#pragma unroll
          for (int j = 0; j < kPer; ++j) kf[c * kPer + j] = 0.0f;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kVals; ++j) dot = fmaf(qr[gi][j], kf[j], dot);
        for (int o = lpr >> 1; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        sc[p][gi] = ok[p] ? dot : kNegInf;
      }
    }

    // online softmax: m over the stage's rows (all groups), weights
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      float mx = sc[0][gi];
#pragma unroll
      for (int p = 1; p < kPasses; ++p) mx = fmaxf(mx, sc[p][gi]);
      for (int o = lpr; o < 32; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m[gi], mx);
      const float corr = expf(m[gi] - m_new);
      m[gi] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        sc[p][gi] = ok[p] ? expf(sc[p][gi] - m_new) : 0.0f;
        psum += sc[p][gi];
      }
      l[gi] = l[gi] * corr + psum;
#pragma unroll
      for (int j = 0; j < kVals; ++j) acc[gi][j] *= corr;
    }

    // acc += p v, V read only for rows that hold a position
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (ok[p]) {
        float vf[kVals];
#pragma unroll
        for (int c = 0; c < kMaxNv; ++c) {
          if (c < nv && c * lpr + sub < pieces) {
            E::widen(slot[(kPasses + p) * nv * 32 + c * 32 + lane],
                     vf + c * kPer);
          } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j) vf[c * kPer + j] = 0.0f;
          }
        }
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
          for (int j = 0; j < kVals; ++j) {
            acc[gi][j] = fmaf(sc[p][gi], vf[j], acc[gi][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // sum the groups of lpr lanes, then merge the warps through shared
  // memory (the rings, free once every warp is past its loop)
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    for (int o = lpr; o < 32; o <<= 1) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], o);
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
      }
    }
  }
  __syncthreads();
  float* mw = reinterpret_cast<float*>(ring);   // [kWarps][GC]
  float* lw = mw + kWarps * GC;                 // [kWarps][GC]
  float* aw = lw + kWarps * GC;                 // [kWarps][GC][dh]
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    if (lane == 0) {
      mw[warp * GC + gi] = m[gi];
      lw[warp * GC + gi] = l[gi];
    }
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int c = j / kPer;
        const int d = (c * lpr + sub) * kPer + (j - c * kPer);
        if (c < nv && d < dh) aw[(warp * GC + gi) * dh + d] = acc[gi][j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gc * dh; i += kThreads) {
    const int gi = i / dh;
    const int d = i - gi * dh;
    float m_star = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_star = fmaxf(m_star, mw[w * GC + gi]);
    float l_sum = 0.0f, a_sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(mw[w * GC + gi] - m_star);
      l_sum += lw[w * GC + gi] * e;
      a_sum += aw[(w * GC + gi) * dh + d] * e;
    }
    const size_t idx = ((size_t)b * h + h0 + gi) * n_split + sp;
    part_acc[idx * dh + d] = a_sum;
    if (d == 0) {
      part_m[idx] = m_star;
      part_l[idx] = l_sum;
    }
  }
}

// One CTA per (b, h): merge its n_split partials, their weights
// e^(m_i - m*) computed once into shared memory.
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ out, int n_split, int dh) {
  extern __shared__ float wt[];           // [n_split]
  const size_t bh = blockIdx.x;
  const float* m = part_m + bh * n_split;
  const float* l = part_l + bh * n_split;
  float m_star = kNegInf;
  for (int i = 0; i < n_split; ++i) m_star = fmaxf(m_star, m[i]);
  for (int i = threadIdx.x; i < n_split; i += kThreads) {
    wt[i] = expf(m[i] - m_star);
  }
  __syncthreads();
  float l_star = 0.0f;
  for (int i = 0; i < n_split; ++i) l_star += l[i] * wt[i];
  const float denom = fmaxf(l_star, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    const float* a = part_acc + bh * n_split * dh + d;
    float o = 0.0f;
    for (int i = 0; i < n_split; ++i) o += a[(size_t)i * dh] * wt[i];
    out[bh * dh + d] = o / denom;
  }
}

template <typename KT, bool kVec16, int GC>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int32_t* cache_len, float* part_m,
                         float* part_l, float* part_acc, int b, int s, int h,
                         int hkv, int dh, int n_split, int chunk, int q_bf16,
                         float scale, cudaStream_t stream) {
  const int g = h / hkv;
  const int n_gc = (g + kHeads - 1) / kHeads;
  const int nv = row_pieces(dh, Elem<KT>::kPerVec) > 32 ? 2 : 1;
  const size_t smem =
      (size_t)kWarps * kStages * 2 * kPasses * nv * 32 * sizeof(uint4);
  auto fn = flash_decode_split<KT, kVec16, GC>;
  cudaError_t err = prepare((const void*)fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((size_t)b * hkv * n_gc), (unsigned)n_split);
  fn<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const KT*>(k), static_cast<const KT*>(v), cache_len,
      part_m, part_l, part_acc, s, h, hkv, dh, g, n_gc, n_split, chunk,
      q_bf16, scale);
  return cudaGetLastError();
}

template <typename KT, bool kVec16>
cudaError_t launch_split_g(const void* q, const void* k, const void* v,
                           const int32_t* cache_len, float* part_m,
                           float* part_l, float* part_acc, int b, int s,
                           int h, int hkv, int dh, int n_split, int chunk,
                           int q_bf16, float scale, cudaStream_t stream) {
  const int gcm = h / hkv < kHeads ? h / hkv : kHeads;  // 1, 2 or 4 heads
  auto go = [&](auto gc) {
    return launch_split<KT, kVec16, decltype(gc)::value>(
        q, k, v, cache_len, part_m, part_l, part_acc, b, s, h, hkv, dh,
        n_split, chunk, q_bf16, scale, stream);
  };
  if (gcm == 1) return go(std::integral_constant<int, 1>{});
  if (gcm == 2) return go(std::integral_constant<int, 2>{});
  return go(std::integral_constant<int, kHeads>{});
}

template <typename KT>
cudaError_t launch_split_kv(const void* q, const void* k, const void* v,
                            const int32_t* cache_len, float* part_m,
                            float* part_l, float* part_acc, int b, int s,
                            int h, int hkv, int dh, int n_split, int chunk,
                            int q_bf16, float scale, cudaStream_t stream) {
  const bool vec16 = (dh * sizeof(KT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec16) {
    return launch_split_g<KT, true>(q, k, v, cache_len, part_m, part_l,
                                    part_acc, b, s, h, hkv, dh, n_split,
                                    chunk, q_bf16, scale, stream);
  }
  return launch_split_g<KT, false>(q, k, v, cache_len, part_m, part_l,
                                   part_acc, b, s, h, hkv, dh, n_split, chunk,
                                   q_bf16, scale, stream);
}

}  // namespace

// q_bf16 / kv_bf16: 1 where q / the cache is bf16, 0 where it is f32.
extern "C" int flash_decode_split_launch(
    const void* q, const void* k, const void* v, const int32_t* cache_len,
    float* part_m, float* part_l, float* part_acc, int b, int s, int h,
    int hkv, int dh, int n_split, int chunk, int q_bf16, int kv_bf16,
    float scale, cudaStream_t stream) {
  if (dh < 1 || dh > kMaxDh || hkv < 1 || h % hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (kv_bf16) {
    return (int)launch_split_kv<__nv_bfloat16>(
        q, k, v, cache_len, part_m, part_l, part_acc, b, s, h, hkv, dh,
        n_split, chunk, q_bf16, scale, stream);
  }
  return (int)launch_split_kv<float>(q, k, v, cache_len, part_m, part_l,
                                     part_acc, b, s, h, hkv, dh, n_split,
                                     chunk, q_bf16, scale, stream);
}

extern "C" int flash_decode_combine_launch(const float* part_m,
                                           const float* part_l,
                                           const float* part_acc, float* out,
                                           int bh, int n_split, int dh,
                                           cudaStream_t stream) {
  const size_t smem = (size_t)n_split * sizeof(float);
  cudaError_t err = prepare((const void*)flash_decode_combine, smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine<<<bh, kThreads, smem, stream>>>(part_m, part_l,
                                                       part_acc, out, n_split,
                                                       dh);
  return (int)cudaGetLastError();
}
