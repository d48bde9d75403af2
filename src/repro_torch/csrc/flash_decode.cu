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
// no order, so the positions are split over CTAs and their partial
// softmax states merged afterwards.
//
// What bounds it: bytes.  Every cache row a row's cache_len reaches is
// read once (one decode_32k layer, B = 8, S = 32,768, Hkv = 16, Dh = 128,
// bf16: 2.15 GB of K and V, 0.64 ms at 3.35 TB/s), against 4 B H S Dh
// f32 operations (2.1 GFLOP, 0.03 ms at 67 TFLOP/s).  So the design is
// about keeping enough loads in flight on every SM:
//
// Split-KV.  A grid of (B * Hkv * ceil(G / 8), n_split) CTAs: CTA (x, sp)
// takes up to 8 query heads of one kv head of one batch row, and the
// positions [sp * chunk, (sp + 1) * chunk) below that row's length.  The
// wrapper (kernels/flash_decode/ops.py, `split_plan`) chooses n_split from
// B * Hkv * ceil(G / 8) and S so that the grid holds about 16 CTAs per SM
// of the H100's 132.  A CTA stages 32 positions at a time: the whole block
// copies their K and V rows into shared memory as f32, with 16-byte loads
// where Dh * sizeof allows (every Dh that is a multiple of 8 in bf16 or 4
// in f32; element loads otherwise).  Rows are found by the cache's strides
// (a position's row is Hkv * Dh elements after the last one), never
// assumed contiguous across positions.  Each warp then takes (head,
// position) dot products, lanes over Dh with a shuffle reduction; one warp
// per head rescales the online softmax (m, l) for the tile; each thread
// owns 1-2 columns of Dh for every head in registers (acc).  The CTA
// writes its unnormalised partial (m, l, acc).
//
// Combine.  A second launch, one CTA per (b, h), merges the splits by the
// log-sum-exp rule the reference writes for its sequence-sharded cache
// (models/attention.py, decode_attention_seqsharded):
//     m* = max m_i, l* = sum l_i e^(m_i - m*),
//     out = sum acc_i e^(m_i - m*) / max(l*, 1e-30).
// An empty split has m = -1e30, l = 0, acc = 0 and weighs nothing.
//
// cache_len is read on the device: the wrapper never synchronises.  expf,
// not __expf, and no fast-math flag.  Dh <= 256; any G.  TMA or cp.async
// pipelines and tensor-core products are later work.
//
// Plain C interface, loaded with ctypes (kernels/_build.py).  Each entry
// point returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;              // positions staged at a time (a warp)
constexpr int kHeads = 8;              // query heads of one kv head per CTA
constexpr int kMaxDh = 256;
constexpr int kCols = kMaxDh / kThreads;   // Dh columns a thread owns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy the Dh-rows of nt positions, `stride` elements apart, from `src`
// into dst[t * dh + c] as f32.
template <typename T, bool kVec16>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           size_t stride, int nt, int dh) {
  if constexpr (kVec16) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = dh / V;
    for (int i = threadIdx.x; i < nt * per_row; i += kThreads) {
      const int t = i / per_row;
      const int c = (i - t * per_row) * V;
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + t * stride + c));
      const T* e = reinterpret_cast<const T*>(&raw);
      float4* out = reinterpret_cast<float4*>(dst + t * dh + c);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        out[j] = make_float4(to_f32(e[4 * j]), to_f32(e[4 * j + 1]),
                             to_f32(e[4 * j + 2]), to_f32(e[4 * j + 3]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < nt * dh; i += kThreads) {
      const int t = i / dh;
      const int c = i - t * dh;
      dst[t * dh + c] = to_f32(src[t * stride + c]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// Partials are laid out (B, H, n_split) for m and l, (B, H, n_split, Dh)
// for acc.
template <typename QT, typename KT, bool kVec16>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const QT* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v,
                   const int32_t* __restrict__ cache_len,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int s, int h, int hkv,
                   int dh, int g, int n_gc, int gcm, int n_split, int chunk,
                   float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // [kTile][dh]
  float* vs = ks + kTile * dh;             // [kTile][dh]
  float* qs = vs + kTile * dh;             // [gcm][dh], scaled
  float* ps = qs + gcm * dh;               // [gcm][kTile]: scores, weights
  float* ms = ps + gcm * kTile;            // [gcm] running max
  float* ls = ms + gcm;                    // [gcm] running normaliser
  float* cs = ls + gcm;                    // [gcm] this tile's rescale

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

  const int len = min(max(cache_len[b], 0), s);
  const int start = sp * chunk;
  const int end = min(start + chunk, len);

  const QT* qrow = q + ((size_t)b * h + h0) * dh;
  for (int i = threadIdx.x; i < gc * dh; i += kThreads) {
    qs[i] = to_f32(qrow[i]) * scale;
  }
  for (int i = threadIdx.x; i < gc; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.0f;
  }
  float acc[kHeads][kCols];
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[gi][j] = 0.0f;
  }
  __syncthreads();

  const size_t stride = (size_t)hkv * dh;  // elements from one position to the next
  for (int t0 = start; t0 < end; t0 += kTile) {
    const int nt = min(kTile, end - t0);
    const size_t row0 = ((size_t)b * s + t0) * hkv + n;
    stage_rows<KT, kVec16>(ks, k + row0 * dh, stride, nt, dh);
    stage_rows<KT, kVec16>(vs, v + row0 * dh, stride, nt, dh);
    __syncthreads();

    // scores: one (head, position) pair per warp at a time
    for (int pi = warp; pi < gc * kTile; pi += kWarps) {
      const int gi = pi / kTile;
      const int t = pi - gi * kTile;
      float dot = 0.0f;
      if (t < nt) {
        for (int d = lane; d < dh; d += 32) {
          dot += qs[gi * dh + d] * ks[t * dh + d];
        }
        dot = warp_sum(dot);
      }
      if (lane == 0) ps[gi * kTile + t] = t < nt ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, a lane per position
    for (int gi = warp; gi < gc; gi += kWarps) {
      const float sc = ps[gi * kTile + lane];
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float p = lane < nt ? expf(sc - m_new) : 0.0f;
      const float psum = warp_sum(p);
      ps[gi * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[gi] = corr;
        ls[gi] = ls[gi] * corr + psum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] v[t][d]
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d < dh) {
#pragma unroll
        for (int gi = 0; gi < kHeads; ++gi) {
          if (gi < gc) {
            float a = acc[gi][j] * cs[gi];
            for (int t = 0; t < nt; ++t) a += ps[gi * kTile + t] * vs[t * dh + d];
            acc[gi][j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
    if (gi < gc) {
      const size_t part = ((size_t)b * h + h0 + gi) * n_split + sp;
      if (threadIdx.x == 0) {
        part_m[part] = ms[gi];
        part_l[part] = ls[gi];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = threadIdx.x + j * kThreads;
        if (d < dh) part_acc[part * dh + d] = acc[gi][j];
      }
    }
  }
}

// One CTA per (b, h): merge its n_split partials.
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ out, int n_split, int dh) {
  const size_t bh = blockIdx.x;
  const float* m = part_m + bh * n_split;
  const float* l = part_l + bh * n_split;
  float m_star = kNegInf;
  for (int i = 0; i < n_split; ++i) m_star = fmaxf(m_star, m[i]);
  float l_star = 0.0f;
  for (int i = 0; i < n_split; ++i) l_star += l[i] * expf(m[i] - m_star);
  const float denom = fmaxf(l_star, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    const float* a = part_acc + bh * n_split * dh + d;
    float o = 0.0f;
    for (int i = 0; i < n_split; ++i) o += a[(size_t)i * dh] * expf(m[i] - m_star);
    out[bh * dh + d] = o / denom;
  }
}

template <typename QT, typename KT, bool kVec16>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int32_t* cache_len, float* part_m,
                         float* part_l, float* part_acc, int b, int s, int h,
                         int hkv, int dh, int n_split, int chunk, float scale,
                         cudaStream_t stream) {
  const int g = h / hkv;
  const int n_gc = (g + kHeads - 1) / kHeads;
  const int gcm = g < kHeads ? g : kHeads;
  const size_t smem =
      (size_t)(2 * kTile * dh + gcm * dh + gcm * kTile + 3 * gcm) *
      sizeof(float);
  auto fn = flash_decode_split<QT, KT, kVec16>;
  cudaError_t err = prepare((const void*)fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((size_t)b * hkv * n_gc), (unsigned)n_split);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), cache_len, part_m, part_l, part_acc, s, h,
      hkv, dh, g, n_gc, gcm, n_split, chunk, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_split_kv(const void* q, const void* k, const void* v,
                            const int32_t* cache_len, float* part_m,
                            float* part_l, float* part_acc, int b, int s,
                            int h, int hkv, int dh, int n_split, int chunk,
                            float scale, cudaStream_t stream) {
  const bool vec16 = (dh * sizeof(KT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec16) {
    return launch_split<QT, KT, true>(q, k, v, cache_len, part_m, part_l,
                                      part_acc, b, s, h, hkv, dh, n_split,
                                      chunk, scale, stream);
  }
  return launch_split<QT, KT, false>(q, k, v, cache_len, part_m, part_l,
                                     part_acc, b, s, h, hkv, dh, n_split,
                                     chunk, scale, stream);
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
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16) {
    return (int)launch_split_kv<bf16, bf16>(q, k, v, cache_len, part_m,
                                            part_l, part_acc, b, s, h, hkv,
                                            dh, n_split, chunk, scale, stream);
  }
  if (q_bf16) {
    return (int)launch_split_kv<bf16, float>(q, k, v, cache_len, part_m,
                                             part_l, part_acc, b, s, h, hkv,
                                             dh, n_split, chunk, scale, stream);
  }
  if (kv_bf16) {
    return (int)launch_split_kv<float, bf16>(q, k, v, cache_len, part_m,
                                             part_l, part_acc, b, s, h, hkv,
                                             dh, n_split, chunk, scale, stream);
  }
  return (int)launch_split_kv<float, float>(q, k, v, cache_len, part_m,
                                            part_l, part_acc, b, s, h, hkv, dh,
                                            n_split, chunk, scale, stream);
}

extern "C" int flash_decode_combine_launch(const float* part_m,
                                           const float* part_l,
                                           const float* part_acc, float* out,
                                           int bh, int n_split, int dh,
                                           cudaStream_t stream) {
  flash_decode_combine<<<bh, kThreads, 0, stream>>>(part_m, part_l, part_acc,
                                                    out, n_split, dh);
  return (int)cudaGetLastError();
}
