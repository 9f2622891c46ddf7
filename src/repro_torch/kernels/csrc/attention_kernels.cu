// Hand-written Hopper (sm_90a) flash attention of the LM serving path.
//
//   flash_attention  <- repro/kernels/flash_attention.py::flash_attention_pallas
//                       (_flash_kernel), with the query offset of the serving
//                       path's repro/models/layers.py::_chunked_attention
//
// out[b,h,i] = sum_j softmax_j(scale * q[b,h,i].k[b,h/g,j]) v[b,h/g,j] over the
// unmasked j (causal: j <= offset[b] + i; j < Skv always), q and k DK wide, v
// and out DV wide: DK = DV in {16, 32, 64, 80, 128}, or MLA's (192, 128), whose
// queries and keys carry a 64-wide rope part the values lack.  80 (zamba2's
// heads) is the one width that is no power of two and no multiple of 64: the
// decode kernel reads its 10 (bf16) or 20 (f32) 16-byte vectors a row in a
// main part of 8 or 16 and a tail of 2 or 4, and gives its last 16 output
// columns to lanes 0-15; the prefill kernel pads it to 128 in shared memory
// (see there).  Online softmax in
// exp2 units with the running max, sum and accumulator in f32 registers; a
// row with every position masked gives 0, as the TPU kernel's finalize does.
// In both kernels one block serves all g = Hq/Hkv query heads of its kv head
// (the TPU kernel's GQA index map), so each K/V byte is read once per group,
// and no key past the causal frontier offset[b] + last row is loaded: a
// decode costs the slot's valid length, not the cache's max_len.
//
// Two kernels, chosen by the launcher:
//
// * flash_attention_decode_kernel: f32 of any Sq, bf16 with Sq < 16 or
//   D < 64 (the decode wave: one query per slot).  Bound by bytes: a decode
//   wave reads each slot's valid K/V prefix once and does ~2 FMAs per byte,
//   so scalar f32 FMAs suffice if none is wasted and the loads never stop.
//   One block takes one (slot, kv head, query tile, key chunk) and exactly
//   its g * nq live rows (nq = the tile's queries, at most 16 / g): no FMA or
//   shared read is spent on a dead row.  The per-row registers are sized by
//   a power-of-two bucket R >= g * bq (a template argument), so every loop
//   over rows unrolls and no shuffle sits under a branch (the compiler would
//   wrap each such shuffle in a WARPSYNC ... ENDCOLLECTIVE emulation loop).
//   A 192-wide q row takes at most 8 rows a block (R <= 8): at R = 16 the
//   per-row registers of the (128, 128) f32 instance already fill 254.
//   A producer warp streams the chunk
//   through a ring of kDecStages tiles of 32 keys with 1-D `cp.async.bulk`
//   copies completing on mbarriers; the four consumer warps take the tiles in
//   turn, each keeping its own (m, l, acc), and merge through shared memory
//   at the end.  The 1-D bulk copy (TMA without a tensor map) fits because
//   the 32 keys of one kv head are one contiguous span of the
//   [B, Hkv, max_len, D] cache; one thread issues it, no register holds the
//   data, and K/V stay in their own type (bf16) in shared memory, converted
//   as they are read.  In the score loop lane j owns key j and reads its
//   16-byte vectors in lane-rotated order, so the 8 lanes of a shared-memory
//   wavefront hit distinct banks (a row of 10 or 20 vectors: the first 8 or
//   16 rotated so, then the 2 or 4 left in an order that spreads the 8 lanes
//   over the bank groups too); in P V lane j owns DV/32 output columns, and
//   at DV 80 lanes 0-15 also one of the last 16.
//   The launcher splits the keys into chunks so that about 4 blocks per SM
//   would exist for full caches; blocks past a slot's frontier return before
//   loading anything, and the last block of a (slot, kv head, query tile) to
//   finish (an atomic counter in a scratch buffer, reset by that block)
//   merges the chunks that saw keys: no second launch.
//
// * flash_attention_prefill_kernel: bf16 with Sq >= 16 and (DK, DV) in
//   {(64, 64), (80, 80), (128, 128), (192, 128)}.  Bound by the tensor cores (2 (DK +
//   DV) Hq operations per visible pair at 989 TFLOP/s).  Both products run
//   as wgmma m64nNk16 (bf16 in, f32 accumulate): S = Q K^T with Q and K in
//   shared memory (K-major), and O += P V with P in registers (S's
//   accumulator rounded to bf16 is the A-operand layout) and V in shared
//   memory read as an MN-major B through the descriptor's transpose bit.
//   One producer warp issues TMA loads (cp.async.bulk.tensor, 128-byte
//   swizzle, tensor maps encoded per call): the block's Q tiles once and
//   K/V tiles of 128 keys (DK / 64 and DV / 64 boxes of 64 columns) into a
//   ring of kPreStages stages with full and empty mbarriers.  Two consumer
//   warpgroups each own a 64-row query tile; a block's tiles are the g heads
//   of one kv head (heads fastest), so both consume every K/V tile it loads.
//   Tiles past the frontier are never loaded, only tiles that cross the
//   diagonal or Skv compute a mask, and the blocks of the latest query tiles
//   (the most keys) are scheduled first.  Q rows past Sq are zero-filled by
//   TMA and never stored; keys past Skv are zero-filled and masked.  A width
//   that is no multiple of 64 (80) is padded to whole 64-column boxes (128):
//   TMA's out-of-bounds fill writes zeros into q and k columns 80-127, which
//   S's k-steps (DK / 16 = 5) never read, and into v's, which give output
//   columns 80-127 that are never stored.  So P V runs as at 128 (the
//   work at width 80 is what the bound counts).
//
// Plain C entry point (bound with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// mbarriers, bulk copies (TMA), wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra LAB_DONE;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// contiguous global -> shared copy of `bytes` (a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (SWIZZLE_128B).  The atoms are 8 rows of 128 bytes, 1024-byte aligned.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// type helpers
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes at p as floats: 4 of f32, 8 of bf16
__device__ __forceinline__ void unpack16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// N consecutive elements at p (N * sizeof(T) in {2, 4, 8, 16}, aligned) as floats
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    unpack16(p, x);
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xFFFF0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else if constexpr (N == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(v << 16);
    x[1] = __uint_as_float(v & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
  }
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

// ---------------------------------------------------------------------------
// Decode: split-KV, pipelined, live rows only
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 4;                        // consumer warps
constexpr int kDecThreads = (kDecWarps + 1) * 32;   // and one producer warp
constexpr int kDecRows = 16;                        // (query head, query) rows at most
constexpr int kDecKeys = 32;                        // keys of one tile: one per lane
constexpr int kDecStages = kDecWarps;               // ring of tiles; tile t: stage and warp t % 4

template <typename T, int DK, int DV, int R>
constexpr int decode_smem_bytes() {
  // K and V rings, the q rows, each warp's softmax weights, full and empty
  // barriers, the last-block flag
  return (kDecStages * kDecKeys * (DK + DV) + R * DK) * static_cast<int>(sizeof(T)) +
         kDecWarps * R * kDecKeys * 4 + 2 * kDecStages * 8 + 16;
}

// the most rows a block of q/k width DK takes (see the header)
__host__ __device__ constexpr int dec_max_rows(int DK) { return DK == 192 ? 8 : kDecRows; }

// Grid (qtiles * splits, Hkv, B).  Block (qt, split) takes queries
// [qt*bq, qt*bq + nq) and keys [split*chunk, (split+1)*chunk) of kv head hk
// of sequence b; its rows are r = i * nq + j: query head hk*g + i, query
// qt*bq + j.  q is [B, Hq, Sq, DK], k [B, Hkv, Skv, DK], v [B, Hkv, Skv, DV],
// out [B, Hq, Sq, DV], all contiguous.  R, a power of two >= g * bq, sizes
// the per-row registers, so every loop over rows is unrolled with no branch
// around a shuffle; rows
// r >= nrows = g * nq are dead and spend no FMA or shared-memory read (their
// shuffles in the softmax reductions run, on -inf).  With splits > 1, a
// block whose (slot, head, tile) saw more than one live chunk writes its
// (m, l, acc) to part_ml [groups, splits, g*bq, 2] and part_acc [groups,
// splits, g*bq, DV] (group = (b*Hkv + hk) * qtiles + qt), and the last of
// them merges; counters [groups] are 0 on entry and left 0.
template <typename T, int DK, int DV, int R>
__global__ void __launch_bounds__(kDecThreads, 1)
flash_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              float* __restrict__ part_acc, float* __restrict__ part_ml,
                              int* __restrict__ counters, const int32_t* __restrict__ offsets,
                              int offset_scalar, int Hq, int Hkv, int Sq, int Skv, int bq,
                              int splits, int chunk, int causal, float scale_log2) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // elements of a 16-byte vector
  constexpr int kVecs = DK / kVec;                          // vectors of a q or k row
  // The lane rotation below keeps the 8 lanes of a wavefront on 8 distinct
  // 16-byte bank groups: over all kVecs vectors when kVecs is a power of two
  // or a multiple of 8, else over the first kMain (a multiple of 8), and the
  // kTail (2 or 4) left are read in an order that does the same.
  constexpr int kTail = (kVecs % 8 == 0 || (kVecs & (kVecs - 1)) == 0) ? 0 : kVecs % 8;
  constexpr int kMain = kVecs - kTail;
  static_assert(DK % kVec == 0 && (kTail == 0 || (kMain >= 8 && (kTail == 2 || kTail == 4))),
                "DK / kVec: 2^n, 8 n, or 8 n + 2 or + 4 with n >= 1");
  constexpr int kCols = DV >= 32 ? DV / 32 : 1;             // contiguous output columns of a lane
  // the last DV % 32 columns (DV > 32): column kCols * 32 + lane for lanes below
  constexpr int kTailCols = DV > 32 ? DV % 32 : 0;
  constexpr int kAcc = kCols + (kTailCols > 0 ? 1 : 0);     // accumulators of a row
  static_assert(DV <= 32 ? (DV & (DV - 1)) == 0 : DV % 2 == 0, "DV: 2^n up to 32, or even");
  static_assert(R <= dec_max_rows(DK) && (R & (R - 1)) == 0, "R: a power of two up to 16");
  // the warps' partial results fit in the rings they replace
  static_assert(kDecWarps * R * (DV + 2) * 4 <=
                kDecStages * kDecKeys * (DK + DV) * static_cast<int>(sizeof(T)), "w_acc");
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                 // [stages][keys][DK]
  T* vs = ks + kDecStages * kDecKeys * DK;            // [stages][keys][DV]
  T* qs = vs + kDecStages * kDecKeys * DV;            // [R][DK]
  float* ps = reinterpret_cast<float*>(qs + R * DK);  // [warps][R][keys]
  uint64_t* full = reinterpret_cast<uint64_t*>(ps + kDecWarps * R * kDecKeys);
  uint64_t* empty = full + kDecStages;
  int* last_flag = reinterpret_cast<int*>(empty + kDecStages);
  // after the key loop the rings hold the warps' partial results
  float* w_acc = reinterpret_cast<float*>(smem);      // [warps][R][DV]
  float* w_ml = w_acc + kDecWarps * R * DV;           // [warps][R][2]

  const int g = Hq / Hkv;
  const int qtiles = (Sq + bq - 1) / bq;
  const int qt = blockIdx.x / splits, split = blockIdx.x % splits;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq, nq = min(bq, Sq - q0), nrows = g * nq;
  const int offset = offsets ? offsets[b] : offset_scalar;
  int kv_end = Skv;
  if (causal) kv_end = max(0, min(Skv, offset + q0 + nq));
  const int live_chunks = max(1, (kv_end + chunk - 1) / chunk);
  if (split >= live_chunks) return;   // past the frontier: nothing loaded, nothing counted
  const int kv_begin = split * chunk;
  const int kv_stop = min(kv_end, kv_begin + chunk);
  const int ntiles = max(0, (kv_stop - kv_begin + kDecKeys - 1) / kDecKeys);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDecStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  for (int e = threadIdx.x; e < nrows * kVecs; e += kDecThreads) {
    const int r = e / kVecs, c = e % kVecs;
    const int h = hk * g + r / nq;
    const int64_t row = (static_cast<int64_t>(b) * Hq + h) * Sq + q0 + r % nq;
    reinterpret_cast<uint4*>(qs + r * DK)[c] = reinterpret_cast<const uint4*>(q + row * DK)[c];
  }
  __syncthreads();

  float m[R], l[R], acc[R][kAcc];
  int qpos[R];   // the last key a row sees
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    qpos[r] = r < nrows ? (causal ? offset + q0 + r % nq : Skv) : -1;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[r][c] = 0.f;
  }
  const int tcol = kCols * 32 + min(lane, kTailCols > 0 ? kTailCols - 1 : 0);   // tail column

  if (warp == kDecWarps) {
    // producer: keeps up to kDecStages tiles in flight ahead of the warps
    if (lane == 0) {
      const int64_t kv_rows = (static_cast<int64_t>(b) * Hkv + hk) * Skv;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kDecStages;
        if (t >= kDecStages) mbar_wait(&empty[s], ((t / kDecStages) - 1) & 1);
        const int k0 = kv_begin + t * kDecKeys;
        const uint32_t keys = min(kDecKeys, kv_stop - k0);
        const uint32_t kbytes = keys * DK * static_cast<uint32_t>(sizeof(T));
        const uint32_t vbytes = keys * DV * static_cast<uint32_t>(sizeof(T));
        mbar_expect_tx(&full[s], kbytes + vbytes);
        const int64_t row = kv_rows + k0;
        bulk_load(ks + s * kDecKeys * DK, k + row * DK, kbytes, &full[s]);
        bulk_load(vs + s * kDecKeys * DV, v + row * DV, vbytes, &full[s]);
      }
    }
  } else {
    float* pw = ps + warp * R * kDecKeys;   // this warp's weights [R][keys]
    for (int t = warp; t < ntiles; t += kDecWarps) {
      const int s = t % kDecStages;
      mbar_wait(&full[s], (t / kDecStages) & 1);
      const int k0 = kv_begin + t * kDecKeys;
      const int nk = min(kDecKeys, kv_stop - k0);   // keys of the tile; the rest is stale
      const T* kt = ks + s * kDecKeys * DK;
      const T* vt = vs + s * kDecKeys * DV;

      // scores: lane j holds key k0 + j, its vectors read in lane-rotated order
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      auto dot_vector = [&](const int c) {   // sc[r] += q[r] . k[lane] over vector c
        float kf[kVec];
        unpack16(kt + lane * DK + c * kVec, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nrows) {   // warp-uniform
            float qf[kVec];
            unpack16(qs + r * DK + c * kVec, qf);
#pragma unroll
            for (int e = 0; e < kVec; ++e) sc[r] = fmaf(qf[e], kf[e], sc[r]);
          }
        }
      };
#pragma unroll 2
      for (int step = 0; step < kMain; ++step) dot_vector((step + lane) % kMain);
      if constexpr (kTail > 0) {
        // the row stride is kTail (mod 8) bank groups: lanes i and i + 8 / kTail
        // of a wavefront start on the same group, so they take other vectors
#pragma unroll
        for (int step = 0; step < kTail; ++step)
          dot_vector(kMain + ((lane & 7) / (8 / kTail) + step) % kTail);
      }

      // online softmax of each row over the tile's keys; a dead row sees none
      const int key = k0 + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool visible = lane < nk && key <= qpos[r];
        const float x = visible ? sc[r] * scale_log2 : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(x));
        // a row that has seen no visible key keeps m = -inf and 0 weights
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float p = visible ? exp2f(x - m_use) : 0.f;
        const float alpha = exp2f(m[r] - m_use);
        l[r] = alpha * l[r] + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kAcc; ++c) acc[r][c] *= alpha;
        pw[r * kDecKeys + lane] = p;
      }
      __syncwarp();

      // P V: lane owns columns [lane * kCols, +kCols) and, with a tail, column
      // tcol (lanes past the tail repeat its last column and never store it);
      // only the nk loaded keys
      if (lane * kCols < DV) {
        int j = 0;
        for (; j + 4 <= nk; j += 4) {
          float vf[4][kCols], vx[4][1];   // vx: the tail column
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            load_cols<kCols>(vt + (j + jj) * DV + lane * kCols, vf[jj]);
            if constexpr (kTailCols > 0) load_cols<1>(vt + (j + jj) * DV + tcol, vx[jj]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nrows) {
              const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kDecKeys + j);
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                acc[r][c] = fmaf(p4.x, vf[0][c], acc[r][c]);
                acc[r][c] = fmaf(p4.y, vf[1][c], acc[r][c]);
                acc[r][c] = fmaf(p4.z, vf[2][c], acc[r][c]);
                acc[r][c] = fmaf(p4.w, vf[3][c], acc[r][c]);
              }
              if constexpr (kTailCols > 0) {
                acc[r][kCols] = fmaf(p4.x, vx[0][0], acc[r][kCols]);
                acc[r][kCols] = fmaf(p4.y, vx[1][0], acc[r][kCols]);
                acc[r][kCols] = fmaf(p4.z, vx[2][0], acc[r][kCols]);
                acc[r][kCols] = fmaf(p4.w, vx[3][0], acc[r][kCols]);
              }
            }
          }
        }
        for (; j < nk; ++j) {
          float vf[kCols], vx[1];
          load_cols<kCols>(vt + j * DV + lane * kCols, vf);
          if constexpr (kTailCols > 0) load_cols<1>(vt + j * DV + tcol, vx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nrows) {
              const float pj = pw[r * kDecKeys + j];
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vf[c], acc[r][c]);
              if constexpr (kTailCols > 0) acc[r][kCols] = fmaf(pj, vx[0], acc[r][kCols]);
            }
          }
        }
      }
      __syncwarp();   // the tile and the weights are read
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  __syncthreads();   // every tile is consumed: the rings are free
  if (warp < kDecWarps) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        if (lane * kCols < DV) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            w_acc[(warp * R + r) * DV + lane * kCols + c] = acc[r][c];
        }
        if constexpr (kTailCols > 0) {
          if (lane < kTailCols) w_acc[(warp * R + r) * DV + tcol] = acc[r][kCols];
        }
        if (lane == 0) {
          w_ml[2 * (warp * R + r)] = m[r];
          w_ml[2 * (warp * R + r) + 1] = l[r];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps: one thread per (row, column); a single live chunk
  // writes the output, otherwise the chunk's partial result
  const bool single = live_chunks == 1;
  const int rows = g * bq;
  const int64_t group = (static_cast<int64_t>(b) * Hkv + hk) * qtiles + qt;
  for (int e = threadIdx.x; e < nrows * DV; e += kDecThreads) {
    const int r = e / DV, col = e % DV;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, w_ml[2 * (w * R + r)]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float mw = w_ml[2 * (w * R + r)];
        if (mw == -INFINITY) continue;
        const float wt = exp2f(mw - M);
        L = fmaf(wt, w_ml[2 * (w * R + r) + 1], L);
        A = fmaf(wt, w_acc[(w * R + r) * DV + col], A);
      }
    }
    if (single) {
      const int64_t row = (static_cast<int64_t>(b) * Hq + hk * g + r / nq) * Sq + q0 + r % nq;
      out[row * DV + col] = from_f32<T>(L > 0.f ? A / L : 0.f);
    } else {
      const int64_t prow = (group * splits + split) * rows + r;
      part_acc[prow * DV + col] = A;
      if (col == 0) {
        part_ml[2 * prow] = M;
        part_ml[2 * prow + 1] = L;
      }
    }
  }
  if (single) return;

  // the last block of the group to finish merges the live chunks
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counters[group], 1);
    *last_flag = done == live_chunks - 1;
    if (*last_flag) counters[group] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  for (int e = threadIdx.x; e < nrows * DV; e += kDecThreads) {
    const int r = e / DV, col = e % DV;
    const int64_t prow0 = group * splits * rows + r;
    float M = -INFINITY;
    for (int c = 0; c < live_chunks; ++c) M = fmaxf(M, __ldcg(&part_ml[2 * (prow0 + c * rows)]));
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int c = 0; c < live_chunks; ++c) {
        const int64_t prow = prow0 + c * rows;
        const float mc = __ldcg(&part_ml[2 * prow]);
        if (mc == -INFINITY) continue;
        const float wt = exp2f(mc - M);
        L = fmaf(wt, __ldcg(&part_ml[2 * prow + 1]), L);
        A = fmaf(wt, __ldcg(&part_acc[prow * DV + col]), A);
      }
    }
    const int64_t row = (static_cast<int64_t>(b) * Hq + hk * g + r / nq) * Sq + q0 + r % nq;
    out[row * DV + col] = from_f32<T>(L > 0.f ? A / L : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Prefill: wgmma + TMA, warp-specialized
// ---------------------------------------------------------------------------
constexpr int kPreRows = 64;                               // query rows of a consumer warpgroup
constexpr int kPreKeys = 128;                              // keys of one K/V tile
constexpr int kPreStages = 2;                              // K/V ring
constexpr int kPreConsumers = 2;                           // consumer warpgroups
constexpr int kPreThreads = kPreConsumers * 128 + 32;      // and one producer warp
constexpr int kSwzCols = 64;                               // bf16 of one 128-byte swizzle row

// a width padded to whole 64-column boxes
__host__ __device__ constexpr int pad64(int D) { return (D + kSwzCols - 1) / kSwzCols * kSwzCols; }

template <int DK, int DV>
constexpr int prefill_smem_bytes() {
  // 1024 of alignment slack, the Q tiles, the K and V rings (widths padded
  // to whole boxes), the barriers
  return 1024 + kPreConsumers * pad64(DK) * kPreRows * 2 +
         kPreStages * (pad64(DK) + pad64(DV)) * kPreKeys * 2 +
         (kPreConsumers + 3 * kPreStages) * 8;
}

// Grid (B * Hkv, ceil(units / 2)), units = g * ceil(Sq / 64) numbered (query
// tile, head in group) with the head fastest; block y = 0 takes the last
// units.  The tensor maps view q as [B*Hq][Sq][DK], k as [B*Hkv][Skv][DK]
// and v as [B*Hkv][Skv][DV] in boxes of 64 columns (one 128-byte swizzle
// row) by 64 query rows or kPreKeys keys, so a tile of D columns is
// pad64(D)/64 boxes, each a run of 8-row, 1024-byte swizzle atoms (columns
// past D read as zeros); out is [B, Hq, Sq, DV].
template <int DK, int DV>
__global__ void __launch_bounds__(kPreThreads, 1)
flash_attention_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               __nv_bfloat16* __restrict__ out,
                               const int32_t* __restrict__ offsets, int offset_scalar, int Hq,
                               int Hkv, int Sq, int Skv, int causal, float scale_log2) {
  constexpr int kSubK = pad64(DK) / kSwzCols, kSubV = pad64(DV) / kSwzCols;   // boxes
  constexpr int kPadV = pad64(DV);                                 // P V's width
  // S's k-steps read DK / 16 columns; P V runs as m64n64 or m64n128
  static_assert(DK % 16 == 0 && DV % 8 == 0 && (kPadV == 64 || kPadV == 128), "DK, DV");
  constexpr int kQBox = kPreRows * 128, kKVBox = kPreKeys * 128;
  constexpr int kQBytes = kSubK * kQBox, kKBytes = kSubK * kKVBox, kVBytes = kSubV * kKVBox;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* ks = qs + kPreConsumers * kQBytes;
  unsigned char* vs = ks + kPreStages * kKBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kPreStages * kVBytes);
  uint64_t* k_full = q_full + kPreConsumers;
  uint64_t* v_full = k_full + kPreStages;
  uint64_t* empty = v_full + kPreStages;

  const int g = Hq / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int units = g * ((Sq + kPreRows - 1) / kPreRows);
  const int u0 = (gridDim.y - 1 - blockIdx.y) * kPreConsumers;
  const int nwg = min(kPreConsumers, units - u0);           // warpgroups with a unit
  const int offset = offsets ? offsets[b] : offset_scalar;
  const int q_last = min(Sq, ((u0 + nwg - 1) / g + 1) * kPreRows) - 1;
  int kv_end = Skv;
  if (causal) kv_end = max(0, min(Skv, offset + q_last + 1));
  const int ntiles = (kv_end + kPreKeys - 1) / kPreKeys;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kPreConsumers; ++w) mbar_init(&q_full[w], 1);
    for (int s = 0; s < kPreStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], nwg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kPreConsumers * 128) {
    // producer warp: one thread issues every TMA load
    if (threadIdx.x == kPreConsumers * 128) {
      for (int w = 0; w < nwg; ++w) {
        const int u = u0 + w;
        mbar_expect_tx(&q_full[w], kQBytes);
#pragma unroll
        for (int c = 0; c < kSubK; ++c)
          tma_load_3d(qs + w * kQBytes + c * kQBox, &qmap, c * kSwzCols, (u / g) * kPreRows,
                      b * Hq + hk * g + u % g, &q_full[w]);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kPreStages;
        if (t >= kPreStages) mbar_wait(&empty[s], ((t / kPreStages) - 1) & 1);
        mbar_expect_tx(&k_full[s], kKBytes);
#pragma unroll
        for (int c = 0; c < kSubK; ++c)
          tma_load_3d(ks + s * kKBytes + c * kKVBox, &kmap, c * kSwzCols, t * kPreKeys,
                      b * Hkv + hk, &k_full[s]);
        mbar_expect_tx(&v_full[s], kVBytes);
#pragma unroll
        for (int c = 0; c < kSubV; ++c)
          tma_load_3d(vs + s * kVBytes + c * kKVBox, &vmap, c * kSwzCols, t * kPreKeys,
                      b * Hkv + hk, &v_full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  if (wg >= nwg) return;   // the last block of an odd number of units
  const int u = u0 + wg;
  const int h = hk * g + u % g, q0 = (u / g) * kPreRows;
  const int wt = threadIdx.x % 128, lane = wt % 32;
  const int r0 = q0 + (wt / 32) * 16 + lane / 4, r1 = r0 + 8;   // this thread's two rows
  // the last key each row sees; the warpgroup's lowest and highest
  const int lim0 = causal ? min(Skv - 1, offset + r0) : Skv - 1;
  const int lim1 = causal ? min(Skv - 1, offset + r1) : Skv - 1;
  const int wg_lo = causal ? min(Skv - 1, offset + q0) : Skv - 1;
  const int wg_hi = causal ? min(Skv - 1, offset + q0 + kPreRows - 1) : Skv - 1;

  float o[kPadV / 2];
#pragma unroll
  for (int i = 0; i < kPadV / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // log2 units; l per thread
  const unsigned char* qt = qs + wg * kQBytes;
  mbar_wait(&q_full[wg], 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kPreStages;
    const uint32_t phase = (t / kPreStages) & 1;
    const int k0 = t * kPreKeys;
    const unsigned char* kt = ks + s * kKBytes;
    const unsigned char* vt = vs + s * kVBytes;
    if (k0 <= wg_hi) {
      // S = Q K^T over DK in k-steps of 16 (32 bytes inside the swizzle row)
      float sc[kPreKeys / 2];
#pragma unroll
      for (int i = 0; i < kPreKeys / 2; ++i) sc[i] = 0.f;
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int sub = kk / 4, in = (kk % 4) * 32;
        wgmma_ss_n128(sc, gmma_desc(qt + sub * kQBox + in, 16, 1024),
                      gmma_desc(kt + sub * kKVBox + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // accumulator element 4i + c: row r0 (c < 2) or r1, key k0 + 8i + 2 (lane % 4) + c % 2
#pragma unroll
      for (int i = 0; i < kPreKeys / 2; ++i) sc[i] *= scale_log2;
      if (k0 + kPreKeys - 1 > wg_lo) {   // only tiles that cross the diagonal or Skv
#pragma unroll
        for (int i = 0; i < kPreKeys / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * i + 2 * (lane % 4) + c;
            if (key > lim0) sc[4 * i + c] = -INFINITY;
            if (key > lim1) sc[4 * i + 2 + c] = -INFINITY;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPreKeys / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row that has seen no visible key keeps m = -inf and 0 weights
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kPreKeys / 8; ++i) {
        sc[4 * i] = exp2f(sc[4 * i] - mu0);
        sc[4 * i + 1] = exp2f(sc[4 * i + 1] - mu0);
        sc[4 * i + 2] = exp2f(sc[4 * i + 2] - mu1);
        sc[4 * i + 3] = exp2f(sc[4 * i + 3] - mu1);
        sum0 += sc[4 * i] + sc[4 * i + 1];
        sum1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
#pragma unroll
      for (int i = 0; i < kPadV / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
      // P in bf16: the accumulator layout of keys 16kk..16kk+15 is the A layout
      uint32_t pa[kPreKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kPreKeys / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 w = __floats2bfloat162_rn(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
          pa[kk][j] = *reinterpret_cast<const uint32_t*>(&w);
        }
      }

      // O += P V: V [keys][kPadV] is the MN-major B; 16 keys = 2 atoms of 8 rows
      mbar_wait(&v_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPreKeys / 16; ++kk) {
        const uint64_t db = gmma_desc(vt + kk * 16 * 128, kKVBox, 1024);
        if constexpr (kPadV == 128) {
          wgmma_rs_n128(o, pa[kk], db);
        } else {
          wgmma_rs_n64(o, pa[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
    } else {
      // past this warpgroup's frontier: only wait for the loads before releasing
      mbar_wait(&k_full[s], phase);
      mbar_wait(&v_full[s], phase);
    }
    if (wt == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, x);
    l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* oh = out + (static_cast<int64_t>(b) * Hq + h) * Sq * DV;
#pragma unroll
  for (int i = 0; i < kPadV / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    if (col >= DV) continue;   // a padded column (DV is even: col + 1 < DV too)
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<int64_t>(r0) * DV + col) =
          __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<int64_t>(r1) * DV + col) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [planes][rows][D] tensor in boxes of 64 columns x box_rows rows, 128-byte swizzle;
// out-of-bounds rows read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int D, int rows, int64_t planes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {kSwzCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// lets `kernel` use `bytes` of dynamic shared memory; `done` is the caller's per-instance flag
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int DK, int DV>
int launch_prefill(const void* q, const void* k, const void* v, void* out,
                   const int32_t* offsets, int offset_scalar, int B, int Hq, int Hkv, int Sq,
                   int Skv, int causal, float scale_log2, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, DK, Sq, static_cast<int64_t>(B) * Hq, kPreRows) ||
      !encode_map(&km, k, DK, Skv, static_cast<int64_t>(B) * Hkv, kPreKeys) ||
      !encode_map(&vm, v, DV, Skv, static_cast<int64_t>(B) * Hkv, kPreKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = prefill_smem_bytes<DK, DV>();
  static_assert(smem <= 232448, "prefill tiles exceed a block's shared memory");
  static bool smem_allowed = false;
  const cudaError_t err = allow_smem(flash_attention_prefill_kernel<DK, DV>, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t units = static_cast<int64_t>(Hq / Hkv) * ((Sq + kPreRows - 1) / kPreRows);
  const int64_t blocks = (units + kPreConsumers - 1) / kPreConsumers;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * Hkv, static_cast<unsigned>(blocks));
  flash_attention_prefill_kernel<DK, DV><<<grid, kPreThreads, smem, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), offsets, offset_scalar, Hq, Hkv, Sq, Skv,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK, int DV, int R>
int launch_decode(const void* q, const void* k, const void* v, void* out, float* part_acc,
                  float* part_ml, int* counters, const int32_t* offsets, int offset_scalar,
                  int B, int Hq, int Hkv, int Sq, int Skv, int bq, int splits, int chunk,
                  int causal, float scale_log2, cudaStream_t s) {
  constexpr int smem = decode_smem_bytes<T, DK, DV, R>();
  static bool smem_allowed = false;
  const cudaError_t err =
      allow_smem(flash_attention_decode_kernel<T, DK, DV, R>, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((Sq + bq - 1) / bq) * splits, Hkv, B);
  flash_attention_decode_kernel<T, DK, DV, R><<<grid, kDecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), part_acc, part_ml, counters, offsets, offset_scalar, Hq, Hkv, Sq,
      Skv, bq, splits, chunk, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// the instance for head dims (DK, DV) and row bucket R (the power of two >= g * bq)
template <typename T, int DK, int DV>
int launch_decode_r(const void* q, const void* k, const void* v, void* out, float* part_acc,
                    float* part_ml, int* counters, const int32_t* offsets, int offset_scalar,
                    int B, int Hq, int Hkv, int Sq, int Skv, int bq, int splits, int chunk,
                    int causal, float scale_log2, cudaStream_t s) {
  const int rows = (Hq / Hkv) * bq;
#define DECODE_ARGS                                                                         \
  q, k, v, out, part_acc, part_ml, counters, offsets, offset_scalar, B, Hq, Hkv, Sq, Skv, bq, \
      splits, chunk, causal, scale_log2, s
  if (rows > dec_max_rows(DK)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 1) return launch_decode<T, DK, DV, 1>(DECODE_ARGS);
  if (rows <= 2) return launch_decode<T, DK, DV, 2>(DECODE_ARGS);
  if (rows <= 4) return launch_decode<T, DK, DV, 4>(DECODE_ARGS);
  if (rows <= 8) return launch_decode<T, DK, DV, 8>(DECODE_ARGS);
  if constexpr (dec_max_rows(DK) >= 16) return launch_decode<T, DK, DV, 16>(DECODE_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_decode_d(const void* q, const void* k, const void* v, void* out, float* part_acc,
                    float* part_ml, int* counters, const int32_t* offsets, int offset_scalar,
                    int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int bq, int splits,
                    int chunk, int causal, float scale_log2, cudaStream_t s) {
  if (D == 192 && Dv == 128) return launch_decode_r<T, 192, 128>(DECODE_ARGS);
  if (D != Dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_decode_r<T, 16, 16>(DECODE_ARGS);
    case 32: return launch_decode_r<T, 32, 32>(DECODE_ARGS);
    case 64: return launch_decode_r<T, 64, 64>(DECODE_ARGS);
    case 80: return launch_decode_r<T, 80, 80>(DECODE_ARGS);
    case 128: return launch_decode_r<T, 128, 128>(DECODE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_ARGS
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  offsets: device int32 [B], or null to use
// offset_scalar for every sequence.
// D is the width of q and k, Dv that of v and out: D = Dv in {16, 32, 64,
// 80, 128}, or (192, 128).
// prefill = 1 (bf16, Sq >= 16, (D, Dv) in {(64, 64), (80, 80), (128, 128), (192, 128)},
// Skv >= 1): the wgmma kernel; bq, splits, chunk and the scratch are ignored.
// prefill = 0: the decode kernel with bq queries per block ((Hq / Hkv) * bq
// <= 16, or 8 at D 192) and the keys in `splits` chunks of `chunk` keys (a
// multiple of 32, splits * chunk >= Skv); with splits > 1, f32 scratch
// part_acc [groups, splits, g*bq, Dv] and part_ml [groups, splits, g*bq, 2]
// and int32 counters [groups], all 0 (groups = B * Hkv * ceil(Sq / bq)).
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           void* part_acc, void* part_ml, void* counters, const void* offsets,
                           int offset_scalar, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                           int Dv, int bq, int splits, int chunk, int dtype, int prefill,
                           int causal, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 0 || Hkv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (prefill) {
    if (dtype != 1 || Sq < 16 || Skv < 1 || static_cast<int64_t>(B) * Hkv > 0x7FFFFFFF)
      return static_cast<int>(cudaErrorInvalidValue);
    if (D == 128 && Dv == 128)
      return launch_prefill<128, 128>(q, k, v, out, off, offset_scalar, B, Hq, Hkv, Sq, Skv,
                                      causal, scale_log2, s);
    if (D == 64 && Dv == 64)
      return launch_prefill<64, 64>(q, k, v, out, off, offset_scalar, B, Hq, Hkv, Sq, Skv,
                                    causal, scale_log2, s);
    if (D == 80 && Dv == 80)
      return launch_prefill<80, 80>(q, k, v, out, off, offset_scalar, B, Hq, Hkv, Sq, Skv,
                                    causal, scale_log2, s);
    if (D == 192 && Dv == 128)
      return launch_prefill<192, 128>(q, k, v, out, off, offset_scalar, B, Hq, Hkv, Sq, Skv,
                                      causal, scale_log2, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bq < 1 || (Hq / Hkv) * bq > kDecRows || splits < 1 || chunk < kDecKeys ||
      chunk % kDecKeys != 0 || static_cast<int64_t>(splits) * chunk < Skv ||
      static_cast<int64_t>((Sq + bq - 1) / bq) * splits > 0x7FFFFFFF ||
      (splits > 1 && (!part_acc || !part_ml || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0)
    return launch_decode_d<float>(q, k, v, out, pa, pm, cnt, off, offset_scalar, B, Hq, Hkv, Sq,
                                  Skv, D, Dv, bq, splits, chunk, causal, scale_log2, s);
  if (dtype == 1)
    return launch_decode_d<__nv_bfloat16>(q, k, v, out, pa, pm, cnt, off, offset_scalar, B, Hq,
                                          Hkv, Sq, Skv, D, Dv, bq, splits, chunk, causal,
                                          scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
