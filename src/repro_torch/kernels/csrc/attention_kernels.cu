// Hand-written Hopper (sm_90a) flash attention of the LM serving path.
//
//   flash_attention  <- repro/kernels/flash_attention.py::flash_attention_pallas
//                       (_flash_kernel), with the query offset of the serving
//                       path's repro/models/layers.py::_chunked_attention
//
// out[b,h,i] = sum_j softmax_j(scale * q[b,h,i].k[b,h/g,j]) v[b,h/g,j] over the
// unmasked j (causal: j <= offset[b] + i; j < Skv always).  Online softmax
// with the running max, sum and accumulator in f32 registers; a row with
// every position masked gives 0, as the TPU kernel's finalize does.
//
// What bounds it on an H100: at decode (one query row per head) the bytes of
// the valid K/V prefix; at a 2048-token prefill the two products per tile
// (4 D Hq operations per visible pair, at the tensor cores' 989 TFLOP/s in
// bf16).  Two forms, chosen by the launcher from dtype and Sq:
//   * bf16 with Sq >= 16 (prefill): the products on the tensor cores with
//     mma.sync m16n8k16 (flash_attention_mma_kernel), FlashAttention-2's
//     register reuse of S as the A operand of P V.  No wgmma, TMA or
//     cp.async pipeline yet: loads and products alternate behind a barrier.
//   * otherwise (decode; f32): scalar f32 FMAs from shared-memory tiles
//     (flash_attention_kernel).  Decode has few rows per kv head, so one
//     block per kv head would walk the whole prefix tile by tile, bound by
//     load latency: where the grid would not fill the card the keys are
//     split into chunks of kSplitKeys, one block per chunk, and a combine
//     kernel merges the chunks' (max, sum, accumulator) (split-KV, the
//     "flash-decoding" scheme).  Each warp keeps 4 rows, so one 16-byte K
//     read from shared memory feeds 16 FMAs; padded K rows keep the lanes'
//     reads out of each other's banks.
// In both, one block computes all g = Hq/Hkv query heads of its kv head, so
// each K/V tile is read from memory once per group (the TPU kernel's GQA
// index map, with no repeated K/V), and kv tiles past the causal frontier
// offset[b] + last row are never loaded: decode costs the slot's valid
// length, not the cache's max_len.
//
// Plain C entry point (bound with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query head, query) rows of one block
constexpr int kKeys = 32;                     // keys of one kv tile: one per lane
constexpr int kSplitKeys = 256;               // keys of one split-KV block

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// Grid (ceil(Sq / bq), Hkv, B * splits).  Block row r is query head
// hk*g + r / bq at query q0 + r % bq; warp w keeps rows w, w + 4, w + 8,
// w + 12.  q is [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], out like q, all
// contiguous.  With splits > 1 the block of split s takes the keys
// [s * kv_chunk, (s + 1) * kv_chunk) and writes, per row, its accumulator
// to part_acc [splits, B, Hq, Sq, D] and (max, sum) to part_ml
// [splits, B, Hq, Sq, 2] instead of the output.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       const int32_t* __restrict__ offsets, int offset_scalar, int Hq,
                       int Hkv, int Sq, int Skv, int bq, int splits, int kv_chunk,
                       int causal, float scale) {
  constexpr int kPad = D + 4;                // padded K row: 16-byte reads, no bank collision
  constexpr int kCols = (D + 31) / 32;       // output columns per lane
  __shared__ __align__(16) float qs[kRows][D];
  __shared__ __align__(16) float ks[kKeys][kPad];
  __shared__ __align__(16) float vs[kKeys][D];

  const int g = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, Sq - q0);
  const int nrows = g * bq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int offset = offsets ? offsets[b] : offset_scalar;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * Skv * D;

  // keys [kv_begin, kv_end) are this block's and visible to some of its rows
  int kv_end = Skv;
  if (causal) kv_end = max(0, min(Skv, offset + q0 + nq));
  const int kv_begin = split * kv_chunk;
  kv_end = min(kv_end, kv_begin + kv_chunk);

  if (kv_begin < kv_end) {
    for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float x = 0.f;
      if (r < nrows && r % bq < nq) {
        const int h = hk * g + r / bq;
        x = to_f32(q[((static_cast<int64_t>(b) * Hq + h) * Sq + q0 + r % bq) * D + d]);
      }
      qs[r][d] = x;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int r = warp + kWarps * t;
    live[t] = r < nrows && r % bq < nq;   // the same for every lane of the warp
    qpos[t] = offset + q0 + r % bq;
    m[t] = -INFINITY;
    l[t] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[t][c] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and, first time, qs is written)
    // looped, not unrolled as in the tensor-core kernel: unrolled, the
    // 8-slot decode wave took 0.170 ms against 0.108 ms on an H100
    for (int e = threadIdx.x; e < kKeys * D / 4; e += kThreads) {
      const int j = e / (D / 4), d = (e % (D / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + j < kv_end) {
        const int64_t at = kv_base + static_cast<int64_t>(k0 + j) * D + d;
        kk = load4(k + at);
        vv = load4(v + at);
      }
      *reinterpret_cast<float4*>(&ks[j][d]) = kk;
      *reinterpret_cast<float4*>(&vs[j][d]) = vv;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) s[t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[warp + kWarps * t][d]);
        s[t] = fmaf(qq.x, kk.x, s[t]);
        s[t] = fmaf(qq.y, kk.y, s[t]);
        s[t] = fmaf(qq.z, kk.z, s[t]);
        s[t] = fmaf(qq.w, kk.w, s[t]);
      }
    }

    const int key = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      p[t] = 0.f;
      if (!live[t]) continue;
      const bool visible = key < kv_end && (!causal || key <= qpos[t]);
      const float x = visible ? s[t] * scale : -INFINITY;
      const float m_new = fmaxf(m[t], warp_max(x));
      // a row that has seen no visible key keeps m = -inf and gets 0 weights
      p[t] = visible ? expf(x - m_new) : 0.f;
      const float alpha = m[t] == -INFINITY ? 0.f : expf(m[t] - m_new);
      l[t] = alpha * l[t] + warp_sum(p[t]);
      m[t] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[t][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < D ? vs[j][col] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        if (!live[t]) continue;
        const float pj = __shfl_sync(0xFFFFFFFFu, p[t], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[t][c] = fmaf(pj, vj[c], acc[t][c]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    if (!live[t]) continue;
    const int r = warp + kWarps * t;
    const int h = hk * g + r / bq;
    const int64_t row = (static_cast<int64_t>(b) * Hq + h) * Sq + q0 + r % bq;
    if (splits == 1) {
      const float norm = l[t] > 0.f ? 1.f / l[t] : 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) out[row * D + col] = from_f32<T>(acc[t][c] * norm);
      }
    } else {
      const int64_t rows = static_cast<int64_t>(gridDim.z / splits) * Hq * Sq;   // B Hq Sq
      const int64_t prow = split * rows + row;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) part_acc[prow * D + col] = acc[t][c];
      }
      if (lane == 0) {
        part_ml[2 * prow] = m[t];
        part_ml[2 * prow + 1] = l[t];
      }
    }
  }
}

// The split-KV combine: one thread per output element of rows [B, Hq, Sq].
// out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s;
// 0 where no split saw a key.
template <typename T>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     T* __restrict__ out, int64_t rows, int D, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const int64_t row = i / D;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * (s * rows + row)]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ms = part_ml[2 * (s * rows + row)];
      if (ms == -INFINITY) continue;
      const float w = expf(ms - mx);
      num = fmaf(w, part_acc[s * rows * D + i], num);
      den = fmaf(w, part_ml[2 * (s * rows + row) + 1], den);
    }
  }
  out[i] = from_f32<T>(den > 0.f ? num / den : 0.f);
}

// ---------------------------------------------------------------------------
// bf16 with at least kMmaRows queries (prefill): the two products on the
// tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate).  Each warp owns
// one unit of 16 consecutive queries of one query head; units are numbered
// (query tile, head in group) with the head fastest, 4 per block, so a
// block's warps share their kv head and the block loads each 64-key K/V tile
// into shared memory once for all of them.  S = Q K^T stays in registers in
// the accumulator layout, which is the A-operand layout of P V once rounded
// to bf16 (FlashAttention-2's register reuse); K is read as the B operand
// with 32-bit shared loads, V through ldmatrix.trans.  Row max and sum live
// in the four lanes that share a row.
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16;    // queries of one warp's unit
constexpr int kMmaKeys = 64;    // keys of one kv tile

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid (ceil(units / 4), Hkv, B), units = g * ceil(Sq / 16).
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           const int32_t* __restrict__ offsets, int offset_scalar, int Hq,
                           int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int kSteps = D / 16;        // k-steps of Q K^T over D
  constexpr int kOutTiles = D / 8;      // n-tiles of P V over D
  constexpr int kKeyTiles = kMmaKeys / 8;
  constexpr int kPad = D + 8;           // padded rows: 16-byte aligned, no bank collision
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaKeys][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaKeys][kPad];

  const int g = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int units = g * ((Sq + kMmaRows - 1) / kMmaRows);
  const int unit = blockIdx.x * kMmaWarps + warp;
  const bool live = unit < units;       // the same for every lane of the warp
  const int h = hk * g + unit % g;
  const int q0 = (unit / g) * kMmaRows;
  const int offset = offsets ? offsets[b] : offset_scalar;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * Skv * D;

  // the block's last unit has its largest query
  const int last_unit = min(units, (blockIdx.x + 1) * kMmaWarps) - 1;
  const int q_last = min(Sq, (last_unit / g + 1) * kMmaRows) - 1;
  int kv_end = Skv;
  if (causal) kv_end = max(0, min(Skv, offset + q_last + 1));

  // Q of rows gid and gid + 8 as A fragments, zero past Sq
  uint32_t qa[kSteps][4];
  const int row0 = q0 + gid, row1 = q0 + gid + 8;
  const __nv_bfloat16* qh = q + (static_cast<int64_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const int d = t * 16 + tig * 2;
    qa[t][0] = live && row0 < Sq ? *reinterpret_cast<const uint32_t*>(qh + row0 * D + d) : 0u;
    qa[t][1] = live && row1 < Sq ? *reinterpret_cast<const uint32_t*>(qh + row1 * D + d) : 0u;
    qa[t][2] = live && row0 < Sq ? *reinterpret_cast<const uint32_t*>(qh + row0 * D + d + 8) : 0u;
    qa[t][3] = live && row1 < Sq ? *reinterpret_cast<const uint32_t*>(qh + row1 * D + d + 8) : 0u;
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // rows gid, gid + 8 (log2 units)
  const float sl = scale * kLog2e;

  for (int k0 = 0; k0 < kv_end; k0 += kMmaKeys) {
    // a fixed trip count, unrolled: every load of the tile is in flight
    // before the first store waits on one
    constexpr int kLoads = kMmaKeys * D / 8 / (kMmaWarps * 32);
    uint4 kk[kLoads], vv[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int e = threadIdx.x + it * kMmaWarps * 32;
      const int j = e / (D / 8), d = (e % (D / 8)) * 8;
      kk[it] = vv[it] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < kv_end) {
        const int64_t at = kv_base + static_cast<int64_t>(k0 + j) * D + d;
        kk[it] = *reinterpret_cast<const uint4*>(k + at);
        vv[it] = *reinterpret_cast<const uint4*>(v + at);
      }
    }
    __syncthreads();   // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int e = threadIdx.x + it * kMmaWarps * 32;
      const int j = e / (D / 8), d = (e % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&ks[j][d]) = kk[it];
      *reinterpret_cast<uint4*>(&vs[j][d]) = vv[it];
    }
    __syncthreads();
    if (!live) continue;

    // S = Q K^T for 16 rows x 64 keys
    float sc[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ks[n * 8 + gid][t * 16 + tig * 2]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&ks[n * 8 + gid][t * 16 + 8 + tig * 2]);
        mma_16816(sc[n], qa[t], b0, b1);
      }
    }

    // mask, then the online softmax in log2 units
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + n * 8 + tig * 2 + (c & 1);
        const int row = c < 2 ? row0 : row1;
        const bool visible = key < Skv && (!causal || key <= offset + row);
        sc[n][c] = visible ? sc[n][c] * sl : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
    const float a1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      sc[n][0] = sc[n][0] == -INFINITY ? 0.f : exp2f(sc[n][0] - mn0);
      sc[n][1] = sc[n][1] == -INFINITY ? 0.f : exp2f(sc[n][1] - mn0);
      sc[n][2] = sc[n][2] == -INFINITY ? 0.f : exp2f(sc[n][2] - mn1);
      sc[n][3] = sc[n][3] == -INFINITY ? 0.f : exp2f(sc[n][3] - mn1);
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xFFFFFFFFu, sum0, o_);
      sum1 += __shfl_xor_sync(0xFFFFFFFFu, sum1, o_);
    }
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V: P's accumulator layout is the A layout of 16-key steps
#pragma unroll
    for (int t = 0; t < kMmaKeys / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * t][0], sc[2 * t][1]),
                              pack_bf16(sc[2 * t][2], sc[2 * t][3]),
                              pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                              pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3])};
      const int mat = lane / 8;   // ldmatrix: lanes 8i..8i+7 give the rows of matrix i
      const int key = t * 16 + (mat & 1) * 8 + lane % 8;
#pragma unroll
      for (int n = 0; n < kOutTiles; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &vs[key][n * 8 + (mat >> 1) * 8]);
        mma_16816(o[n], pa, vb[0], vb[1]);
        mma_16816(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  if (!live) return;
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* oh = out + (static_cast<int64_t>(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int d = n * 8 + tig * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row0 * D + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row1 * D + d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

int launch_mma(const void* q, const void* k, const void* v, void* out, const int32_t* offsets,
               int offset_scalar, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
               float scale, cudaStream_t s) {
  const int units = (Hq / Hkv) * ((Sq + kMmaRows - 1) / kMmaRows);
  const dim3 grid((units + kMmaWarps - 1) / kMmaWarps, Hkv, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
#define MMA_CASE(DIM)                                                                         \
  case DIM:                                                                                   \
    flash_attention_mma_kernel<DIM><<<grid, kMmaWarps * 32, 0, s>>>(                          \
        qp, kp, vp, op, offsets, offset_scalar, Hq, Hkv, Sq, Skv, causal, scale);             \
    break;
    MMA_CASE(16) MMA_CASE(32) MMA_CASE(64) MMA_CASE(128)
#undef MMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out, float* part_acc,
                 float* part_ml, const int32_t* offsets, int offset_scalar, int B, int Hq,
                 int Hkv, int Sq, int Skv, int D, int bq, int splits, int causal, float scale,
                 cudaStream_t s) {
  const dim3 grid((Sq + bq - 1) / bq, Hkv, B * splits);
  const int kv_chunk = splits == 1 ? Skv : kSplitKeys;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  switch (D) {
#define FLASH_CASE(DIM)                                                                   \
  case DIM:                                                                               \
    flash_attention_kernel<T, DIM><<<grid, kThreads, 0, s>>>(                             \
        qp, kp, vp, op, part_acc, part_ml, offsets, offset_scalar, Hq, Hkv, Sq, Skv, bq,  \
        splits, kv_chunk, causal, scale);                                                 \
    break;
    FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(64) FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t rows = static_cast<int64_t>(B) * Hq * Sq;
    const unsigned blocks = static_cast<unsigned>((rows * D + 255) / 256);
    flash_combine_kernel<T><<<blocks, 256, 0, s>>>(part_acc, part_ml, op, rows, D, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (bf16 with Sq >= 16 takes the tensor-core
// kernel, which takes splits = 1 and ignores bq).  offsets: device int32
// [B], or null to use offset_scalar for every sequence.  bq: queries per
// block of the scalar kernel, with
// (Hq / Hkv) * bq <= 16.  splits: 1, or ceil(Skv / kSplitKeys) with
// f32 scratch part_acc [splits, B, Hq, Sq, D] and part_ml [splits, B, Hq, Sq, 2].
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           void* part_acc, void* part_ml, const void* offsets,
                           int offset_scalar, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                           int bq, int splits, int dtype, int causal, float scale,
                           void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || bq < 1 || (Hq / Hkv) * bq > kRows || Sq < 1 ||
      Skv < 0 || Hkv > 65535 || splits < 1 || static_cast<int64_t>(B) * splits > 65535 ||
      (splits > 1 && (!part_acc || !part_ml ||
                      static_cast<int64_t>(splits) * kSplitKeys < Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, pa, pm, off, offset_scalar, B, Hq, Hkv, Sq, Skv, D,
                               bq, splits, causal, scale, s);
  if (dtype == 1 && Sq >= kMmaRows) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(q, k, v, out, off, offset_scalar, B, Hq, Hkv, Sq, Skv, D, causal, scale,
                      s);
  }
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, pa, pm, off, offset_scalar, B, Hq, Hkv,
                                       Sq, Skv, D, bq, splits, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
