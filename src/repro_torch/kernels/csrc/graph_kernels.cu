// Hand-written Hopper (sm_90a) kernels of the graph generator's main path.
//
// Each kernel replaces one Pallas TPU kernel of the JAX reference and is
// bit-exact with it (all arithmetic is uint32 / int32).  Plain C entry points
// (bound with ctypes from Python) launch on the caller's stream, allocate
// nothing, and return cudaGetLastError() so the wrapper can raise.
//
//   rmat_edges      <- repro/kernels/rmat.py::rmat_edges_pallas (_rmat_kernel)
//   feistel_perm    <- repro/kernels/rmat.py::feistel_perm_pallas (_feistel_kernel)
//   relabel_gather  <- repro/kernels/relabel_gather.py::relabel_gather_pallas
//   bucket_hist     <- repro/kernels/bucket.py::bucket_hist_pallas
//   merge_runs      <- no Pallas kernel (the reference's receive-side merge is
//                      repro/distributed/collectives.py::merge_sorted_runs,
//                      pairwise searchsorted rounds in plain XLA)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgraph_kernels.so graph_kernels.cu

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kThreads = 256;
constexpr int kMaxFeistelRounds = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_uniform(uint32_t seed, uint32_t idx,
                                                    uint32_t stream) {
  const uint32_t s = seed ^ (stream * kGolden);
  return mix32(mix32(idx + s) ^ s);
}

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// rmat_edges: one thread per edge, the `scale` levels unrolled (SCALE is a
// template parameter).  Bound by the integer ALU: per edge and level four
// mix32 evaluations (2 counter uniforms of 2 mix32 each), against 8 bytes
// written per edge; there is no input.  The global edge index wraps mod 2^32
// exactly as the reference's uint32 `start + arange(count)` does.
// ---------------------------------------------------------------------------
template <int SCALE>
__global__ void __launch_bounds__(kThreads)
rmat_edges_kernel(int32_t* __restrict__ src, int32_t* __restrict__ dst, int64_t count,
                  uint32_t start, uint32_t seed, uint32_t t_src, uint32_t t_dst0,
                  uint32_t t_dst1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t idx = start + static_cast<uint32_t>(i);
  uint32_t s = 0, d = 0;
#pragma unroll
  for (int level = 0; level < SCALE; ++level) {
    const uint32_t r1 = counter_uniform(seed, idx, 2u * level);
    const uint32_t r2 = counter_uniform(seed, idx, 2u * level + 1u);
    const uint32_t sb = r1 < t_src ? 1u : 0u;
    const uint32_t db = r2 < (sb ? t_dst1 : t_dst0) ? 1u : 0u;
    s = (s << 1) | sb;
    d = (d << 1) | db;
  }
  src[i] = static_cast<int32_t>(s);
  dst[i] = static_cast<int32_t>(d);
}

// ---------------------------------------------------------------------------
// The two elementwise int32 maps, feistel_perm and relabel_gather, share one
// skeleton.  Both are bound by bytes (4 read + 4 written per id; the
// relabel's table once more).  Their first design ran one thread per id: one
// 4-byte load in flight a thread and 64-bit index arithmetic, 59-61 % of the
// byte bound on the main path's arrays and 11-28 % on the disk tier's small
// ones.  Here each thread issues up to kMapVecs independent 16-byte loads
// per tile (4096 ids a 256-thread block), computes, and issues as many
// 16-byte stores; offsets inside a tile are 32-bit; the grid is as many
// blocks as fit on the card's SMs at once, each walking tiles at a stride of
// the grid.  An array too small to give every resident block a tile of
// kMapVecs vectors a thread gets tiles of 2 or 1 (`vecs`), so that more of
// its loads are in flight at once.
//
// Shape: `rows` rows of `row_len` ids, row r at r * row_len (a flat array is
// one row).  Tile t belongs to row t % rows, so the grid walks every row side
// by side (see relabel_gather).  Each row has `head` ids before its first
// 16-byte boundary and `tail` after its last whole vector (each at most 3;
// the same in every row, since row_len % 4 == 0 where rows > 1): block 0
// maps those one by one, rows * (head + tail) <= kMapThreads of them.  Where
// the input and output sit at different offsets from a 16-byte boundary no
// vector fits both, and the SCALAR instance maps the flat array with
// kMapVecs * 4 independent 4-byte loads a thread instead.  `out` may be
// `in` itself: each id is read and then written by the same thread (hence no
// __restrict__ on the two).
// ---------------------------------------------------------------------------
constexpr int kMapThreads = 256;
constexpr int kMapVecs = 4;                                  // int4 loads per thread per tile
constexpr int kMapScalarIds = 4 * kMapVecs;                  // the SCALAR instance's ids a thread
constexpr int kMapMaxRows = kMapThreads / 6;                 // head + tail <= 6 ids a row
constexpr long long kMapMaxIds = 1LL << 33;                  // whole vectors fit uint32

struct MapShape {
  int64_t row_len;   // ids a row, and the stride between rows
  int rows;
  int head;          // ids before each row's first 16-byte boundary
  int tail;          // ids after each row's last whole vector
  uint32_t nvec;     // whole vectors a row
  int vecs;          // vectors a thread per tile: 1, 2 or kMapVecs
  uint32_t tiles;    // tiles of all rows together
};

template <bool SCALAR, typename F>
__device__ __forceinline__ void map_ids(const int32_t* in, int32_t* out, const MapShape& s,
                                        const F& f) {
  if constexpr (SCALAR) {
    const int64_t n = s.row_len * s.rows;
    const int64_t step = static_cast<int64_t>(gridDim.x) * kMapThreads * kMapScalarIds;
    for (int64_t b = static_cast<int64_t>(blockIdx.x) * kMapThreads * kMapScalarIds; b < n;
         b += step) {
      const int32_t* src = in + b;
      int32_t* dst = out + b;
      const int left = n - b < kMapThreads * kMapScalarIds ? static_cast<int>(n - b)
                                                            : kMapThreads * kMapScalarIds;
      int32_t v[kMapScalarIds];
#pragma unroll
      for (int u = 0; u < kMapScalarIds; ++u) {
        const int i = u * kMapThreads + threadIdx.x;
        if (i < left) v[u] = __ldcs(src + i);
      }
#pragma unroll
      for (int u = 0; u < kMapScalarIds; ++u) {
        const int i = u * kMapThreads + threadIdx.x;
        if (i < left) __stcs(dst + i, f(v[u]));
      }
    }
  } else {
    const int edge = s.head + s.tail;
    if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < s.rows * edge) {
      const int r = threadIdx.x / edge, k = threadIdx.x - r * edge;
      const int64_t at = r * s.row_len +
                         (k < s.head ? k : s.head + 4 * static_cast<int64_t>(s.nvec) + k - s.head);
      out[at] = f(in[at]);
    }
    const uint32_t rows = static_cast<uint32_t>(s.rows);
    const uint32_t tile = kMapThreads * s.vecs;
    for (uint32_t t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      const uint32_t r = t % rows, j = t / rows;
      const int64_t at = r * s.row_len + s.head + 4 * static_cast<int64_t>(j) * tile;
      const int4* src = reinterpret_cast<const int4*>(in + at);
      int4* dst = reinterpret_cast<int4*>(out + at);
      const uint32_t rest = s.nvec - j * tile;
      const int left = static_cast<int>(rest < tile ? rest : tile);   // i < left: u < vecs
      int4 v[kMapVecs];
#pragma unroll
      for (int u = 0; u < kMapVecs; ++u) {
        const int i = u * kMapThreads + threadIdx.x;
        if (i < left) v[u] = __ldcs(src + i);
      }
#pragma unroll
      for (int u = 0; u < kMapVecs; ++u) {
        if (u * kMapThreads + static_cast<int>(threadIdx.x) < left) {   // no work on empty lanes
          v[u].x = f(v[u].x);
          v[u].y = f(v[u].y);
          v[u].z = f(v[u].z);
          v[u].w = f(v[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < kMapVecs; ++u) {
        const int i = u * kMapThreads + threadIdx.x;
        if (i < left) __stcs(dst + i, v[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// feistel_perm: keyed unbalanced Feistel over mix32 on [0, 2^nbits), ROUNDS
// (even, at most 8) unrolled.  The round keys and both half-width masks are
// folded on the host (the port's feistel_round_key; `hi_mask` for the even
// rounds, `lo_mask` for the odd ones), so a round is mix32 and two logic ops
// with no width swap.  ROUNDS x ~10 integer ops per id against 8 bytes moved:
// bound by bytes at 4 rounds (the old design, one id a thread, reached 59 %
// of that bound at 2^30 ids and 28 % at the disk tier's 2^20).
// ---------------------------------------------------------------------------
struct RoundKeys {
  uint32_t k[kMaxFeistelRounds];
};

template <int ROUNDS>
struct FeistelMap {
  RoundKeys rk;
  int lo_bits;
  uint32_t hi_mask, lo_mask;

  __device__ __forceinline__ int32_t operator()(int32_t x) const {
    const uint32_t v = static_cast<uint32_t>(x);
    uint32_t L = v >> lo_bits, R = v & lo_mask;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const uint32_t nR = (L ^ mix32(R ^ rk.k[r])) & (r % 2 ? lo_mask : hi_mask);
      L = R;
      R = nR;
    }
    return static_cast<int32_t>((L << lo_bits) | R);
  }
};

template <int ROUNDS, bool SCALAR>
__global__ void __launch_bounds__(kMapThreads)
feistel_perm_kernel(const int32_t* x, int32_t* out, MapShape s, FeistelMap<ROUNDS> f) {
  map_ids<SCALAR>(x, out, s, f);
}

// ---------------------------------------------------------------------------
// relabel_gather: out = chunk[key - base] for keys in [base, base + B), the
// key itself otherwise.  The table (a pv chunk of 2^23 ids, or all of pv,
// 2^26, when the ring relabel runs as one launch) is far beyond shared
// memory, so it is gathered through L1 from global memory; the keys are
// sorted, so neighbouring ids read neighbouring or equal table entries.
// Bound by bytes: 4 read + 4 written per key, plus the table entries the
// keys touch.  The old design (one key a thread, one launch per ring
// segment) reached 61 % of that bound on a ring segment and 11 % on a
// 2^18-key pv-join segment.  Beyond the shared skeleton: keys and outputs
// bypass L1 and are marked evict-first in L2 (ld/st .cs), so the table keeps
// its L2 lines; and a [rows, N] field of sorted rows (the ring relabel's
// nb shards) runs with its rows' tiles interleaved, so the blocks in flight
// at any moment read one stretch of the table, which each line of it is
// fetched from device memory for about once instead of once a row.
// ---------------------------------------------------------------------------
struct GatherMap {
  const int32_t* chunk;
  int64_t B, base;

  __device__ __forceinline__ int32_t operator()(int32_t key) const {
    const int64_t local = static_cast<int64_t>(key) - base;
    return (local >= 0 && local < B) ? __ldg(chunk + local) : key;
  }
};

template <bool SCALAR>
__global__ void __launch_bounds__(kMapThreads)
relabel_gather_kernel(const int32_t* keys, int32_t* out, MapShape s, GatherMap f) {
  map_ids<SCALAR>(keys, out, s, f);
}

// ---------------------------------------------------------------------------
// bucket_hist: counts of int32 ids in [0, k); any other value (the pad value
// k, negatives) is not counted.  Bound by bytes: 4 read per id.
//
// Loads: each thread issues kHistVecs independent 16-byte loads per tile
// (4096 ids per 256-thread block), so with 4 blocks per SM some 64 KiB are in
// flight per SM.  The ids before the first 16-byte boundary of `dest` and
// after the last whole vector (at most 3 each) are counted one by one by
// block 0.
//
// Small k (K = a power of two >= max(k, 4), at most 32): per-thread counters
// in registers and no shared atomics.  An id u adds 1 << 8 (u & 3) to packed
// word u >> 2 (four 8-bit bins per word, compared against every word index,
// without branches); ids >= K (negatives too, as unsigned) match no word, and
// bins k..K-1 (the pad value k) are counted but never written out.  After at
// most 15 tiles (240 ids per thread < 256) the bytes are added into 32-bit
// counters (at most n < 2^31 each), which are summed per warp with
// __reduce_add_sync and across warps in shared memory.
//
// Large k (K = 0, k <= 8192): a histogram in shared memory, one copy per
// warp where all fit in 32 KiB, else one per block (`copies`, chosen by the
// wrapper), updated with native shared atomicAdd.
//
// Each block writes its k counts to partials[block, k]; the last block to
// finish (an atomic ticket, 0 on entry and reset by that block) sums them into
// `counts`.  So one launch does all: nothing zeroes `counts` beforehand.
// ---------------------------------------------------------------------------
constexpr int kHistThreads = 256;
constexpr int kHistVecs = 4;                              // int4 loads per thread per tile
constexpr int64_t kHistTileVecs = kHistThreads * kHistVecs;
constexpr int kHistFlushTiles = 15;                       // 15 x 16 ids < 256 per byte bin

template <int K>
__device__ __forceinline__ void count_packed(uint32_t (&acc)[K / 4], int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  const uint32_t inc = 1u << ((u & 3u) << 3);
  const uint32_t word = u >> 2;
#pragma unroll
  for (int r = 0; r < K / 4; ++r) acc[r] += word == static_cast<uint32_t>(r) ? inc : 0u;
}

template <int K>
__device__ __forceinline__ void unpack(uint32_t (&acc)[K / 4], uint32_t (&c)[K]) {
#pragma unroll
  for (int r = 0; r < K / 4; ++r) {
#pragma unroll
    for (int b = 0; b < 4; ++b) c[4 * r + b] += (acc[r] >> (8 * b)) & 0xFFu;
    acc[r] = 0;
  }
}

// Calls f(id) for every id this block owns: block 0 takes the unaligned head
// and the tail, every block the 16-byte vectors of its tiles.  `flush` runs
// after every kHistFlushTiles tiles and at the end; every thread of a block
// runs the same number of tiles.
template <typename F, typename G>
__device__ __forceinline__ void for_each_id(const int32_t* __restrict__ dest, int head,
                                            int64_t nvec, int tail, F f, G flush) {
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) f(dest[threadIdx.x]);
    if (threadIdx.x < tail) f(dest[head + 4 * nvec + threadIdx.x]);
  }
  const int4* __restrict__ vec = reinterpret_cast<const int4*>(dest + head);
  const int64_t tiles = (nvec + kHistTileVecs - 1) / kHistTileVecs;
  for (int64_t t = blockIdx.x; t < tiles;) {
    for (int f_tiles = 0; f_tiles < kHistFlushTiles && t < tiles; ++f_tiles, t += gridDim.x) {
      int4 x[kHistVecs];
#pragma unroll
      for (int u = 0; u < kHistVecs; ++u) {
        const int64_t i = t * kHistTileVecs + u * kHistThreads + threadIdx.x;
        x[u] = i < nvec ? __ldg(vec + i) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kHistVecs; ++u) {
        f(x[u].x);
        f(x[u].y);
        f(x[u].z);
        f(x[u].w);
      }
    }
    flush();
  }
}

template <int K>
__global__ void __launch_bounds__(kHistThreads, K == 32 ? 2 : 4)
bucket_hist_kernel(const int32_t* __restrict__ dest, int head, int64_t nvec, int tail, int k,
                   int copies, uint32_t* partials, unsigned* __restrict__ ticket,
                   int32_t* __restrict__ counts) {
  __shared__ uint32_t red[kHistThreads];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* part = partials + static_cast<int64_t>(blockIdx.x) * k;   // this block's row
  if constexpr (K > 0) {
    uint32_t acc[K / 4] = {};
    uint32_t c[K] = {};
    for_each_id(dest, head, nvec, tail, [&](int32_t v) { count_packed<K>(acc, v); },
                [&]() { unpack<K>(acc, c); });
    unpack<K>(acc, c);   // the head and tail ids of block 0
    __shared__ uint32_t per_warp[kHistThreads / 32][K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t s = __reduce_add_sync(0xFFFFFFFFu, c[j]);
      if (lane == 0) per_warp[warp][j] = s;
    }
    __syncthreads();
    if (threadIdx.x < k) {
      uint32_t s = 0;
#pragma unroll
      for (int w = 0; w < kHistThreads / 32; ++w) s += per_warp[w][threadIdx.x];
      part[threadIdx.x] = s;
    }
  } else {
    extern __shared__ uint32_t hist[];                    // [copies, k]
    for (int j = threadIdx.x; j < copies * k; j += kHistThreads) hist[j] = 0;
    __syncthreads();
    uint32_t* __restrict__ mine = hist + (warp % copies) * k;
    const uint32_t uk = static_cast<uint32_t>(k);
    for_each_id(dest, head, nvec, tail, [&](int32_t v) {
      if (static_cast<uint32_t>(v) < uk) atomicAdd(mine + v, 1u);
    }, []() {});
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += kHistThreads) {
      uint32_t s = 0;
      for (int cp = 0; cp < copies; ++cp) s += hist[cp * k + j];
      part[j] = s;
    }
  }

  // the last block to finish sums the partial counts
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int G = gridDim.x;
  if (k <= kHistThreads) {
    // thread t sums bin t % k over the rows t / k, t / k + R, ...
    const int R = kHistThreads / k;
    uint32_t s = 0;
    if (threadIdx.x < R * k)
#pragma unroll 8   // independent loads in flight: this sum is the launch's tail
      for (int g = threadIdx.x / k; g < G; g += R)
        s += __ldcg(partials + static_cast<int64_t>(g) * k + threadIdx.x % k);
    red[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < k) {
      s = 0;
      for (int r = 0; r < R; ++r) s += red[r * k + threadIdx.x];
      counts[threadIdx.x] = static_cast<int32_t>(s);
    }
  } else {
    for (int j = threadIdx.x; j < k; j += kHistThreads) {
      uint32_t s = 0;
      for (int g = 0; g < G; ++g) s += __ldcg(partials + static_cast<int64_t>(g) * k + j);
      counts[j] = static_cast<int32_t>(s);
    }
  }
  if (threadIdx.x == 0) *ticket = 0;   // ready for the next launch
}

// ---------------------------------------------------------------------------
// merge_runs: the receive side of redistribute_sorted.  It replaces no
// Pallas kernel: the reference merges each receiver's nb runs by log2(nb)
// rounds of pairwise searchsorted merges (merge_sorted_runs), which the port
// ran as plain PyTorch before this kernel, at ~66x the byte bound.
//
// Input: data [nb receivers, nb senders, cap] (src, dst) records and valid
// [nb, nb, cap].  Each (receiver, sender) bucket holds its live records as a
// prefix of length L[r, s], sorted by src, stably (bucket_by_destination puts
// a destination's rank i at slot i).  Output, a row of nb * cap a receiver:
// the stable merge of its runs by src (ties to the lower sender, then the
// lower slot), then src 0, dst 0, valid 0 to the end of the row.
//
// Bound by bytes: each live record read once (8 bytes), every output slot
// written once (9 bytes); ~27.9 GB at scale 26, nb 8: 8.3 ms at 3.35 TB/s.
// Four launches on the caller's stream:
//   merge_lengths_kernel  L[r, s] by a binary search for each bucket's first
//                         empty slot, not a pass over `valid`;
//   merge_splits_kernel   twice: each run's split at every
//                         kMergeTile * kMergeFan-th output (the chunks),
//                         then at every kMergeTile-th (the tiles), each
//                         searched inside its chunk's segments;
//   merge_runs_kernel     one block a (tile, receiver): stages the tile's nb
//                         segments in shared memory (loads of 8 bytes,
//                         kMergeItems in flight a thread), merges them by
//                         ceil(log2(nb)) rounds of merge path (each thread 16
//                         consecutive outputs from its own co-rank) and
//                         writes src, dst and valid out coalesced; a tile
//                         past the receiver's live records writes zeros.
// A split (the co-rank of output q) is a binary search on the key v with
// sum_s lb_s(v) <= q < sum_s ub_s(v), one lane a run, the counts summed by
// shuffles inside the lanes' group; the records of key v are then handed
// out in sender order.  So the tie order is exact, and a hub source whose
// records span many tiles is split evenly.  Positions are int32 (nb * cap <
// 2^31); offsets into `data` are 64-bit.
// ---------------------------------------------------------------------------
constexpr int kMergeThreads = 256;
constexpr int kMergeTile = 4096;                                  // outputs a block
constexpr int kMergeItems = kMergeTile / kMergeThreads;           // consecutive outputs a thread
constexpr int kMergeFan = 16;                                     // tiles a chunk
constexpr int kMergeMaxRuns = 32;                                 // one lane a run
constexpr int kMergeBuf = kMergeTile + kMergeTile / kMergeItems;  // with one pad a thread's outputs
constexpr int kMergeSmem = 2 * kMergeBuf * static_cast<int>(sizeof(int2));

// Shared-memory slot of tile position i: a pad record after every
// kMergeItems, so that the threads of a warp, each at its own run of
// kMergeItems outputs, write to different banks.
__device__ __forceinline__ int merge_slot(int i) { return i + i / kMergeItems; }

__device__ __forceinline__ int group_sum(int x, unsigned mask, int group) {
  for (int o = 1; o < group; o <<= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

__device__ __forceinline__ int group_min(int x, unsigned mask, int group) {
  for (int o = 1; o < group; o <<= 1) {
    const int y = __shfl_xor_sync(mask, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int group_max(int x, unsigned mask, int group) {
  for (int o = 1; o < group; o <<= 1) {
    const int y = __shfl_xor_sync(mask, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// The sum of x over the lanes of the group below this one (lane: the
// lane's index in its group).
__device__ __forceinline__ int group_exclusive(int x, unsigned mask, int group, int lane) {
  int inclusive = x;
  for (int o = 1; o < group; o <<= 1) {
    const int y = __shfl_up_sync(mask, inclusive, o, group);
    if (lane >= o) inclusive += y;
  }
  return inclusive - x;
}

// The first index in [lo, hi) of a run whose key exceeds v, hi if none; the
// key of record i is keys[2 * i].
__device__ __forceinline__ int upper_bound(const int32_t* keys, int lo, int hi, long long v) {
  int n = hi - lo;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(keys + 2 * static_cast<int64_t>(lo + half)) <= v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The co-rank of output q (0 < q < total) of the stable merge of the runs'
// segments [a, b): a plus how many of the first q records come from this
// lane's run.  Lanes past the runs hold empty segments.  Invariant of the
// search on v in [lo, hi]: `below` is lb(lo), `upto` ub(hi) in this run,
// fewer than q + 1 records lie below lo and more than q at most at hi.
__device__ int merge_corank(const int32_t* keys, int a, int b, int q, unsigned mask, int group,
                            int lane) {
  long long lo = group_min(a < b ? __ldg(keys + 2 * static_cast<int64_t>(a)) : INT_MAX, mask, group);
  long long hi = group_max(a < b ? __ldg(keys + 2 * static_cast<int64_t>(b - 1)) : INT_MIN, mask,
                           group);
  int below = a, upto = b;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const int u = upper_bound(keys, below, upto, mid);
    if (group_sum(u - a, mask, group) > q) {
      hi = mid;
      upto = u;
    } else {
      lo = mid + 1;
      below = u;
    }
  }
  // v = lo: each run's records of key v are [below, upto); q falls among them
  const int ties = upto - below;
  const int take = q - group_sum(below - a, mask, group) - group_exclusive(ties, mask, group, lane);
  return below + (take < 0 ? 0 : take > ties ? ties : take);
}

// bounds[r] = {0, ..., 0; L[r, 0], ..., L[r, nb - 1]} for each of the
// `receivers` rows, the splits before the first output and past the last:
// L[r, s] is bucket (r, s)'s first empty slot, found by binary search (its
// live slots are a prefix).
__global__ void __launch_bounds__(kMergeThreads)
merge_lengths_kernel(const uint8_t* __restrict__ valid, int receivers, int nb, long long cap,
                     int32_t* __restrict__ bounds) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= receivers * nb) return;
  const uint8_t* v = valid + static_cast<int64_t>(i) * cap;
  long long lo = 0, n = cap;
  while (n > 0) {
    const long long half = n >> 1;
    if (v[lo + half]) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  const int r = i / nb, s = i - r * nb;
  bounds[2 * r * nb + s] = 0;
  bounds[(2 * r + 1) * nb + s] = static_cast<int>(lo);
}

// splits[r, t, s]: the co-rank in run s of output t * step of receiver r (r
// below `receivers`), t in [0, count), searched inside the parent's chunk (parent[r, j]: the
// splits of output j * pstep, j in [0, pcount); parent[r, pcount - 1] lies
// past every live record).  A group of `group` lanes (a power of two >= nb,
// at most 32) a split, lane s for run s.
__global__ void __launch_bounds__(kMergeThreads)
merge_splits_kernel(const int2* __restrict__ data, int receivers, int nb, long long cap,
                    int group, const int32_t* __restrict__ parent, int pcount, long long pstep,
                    int32_t* __restrict__ splits, int count, long long step) {
  const int64_t split = (static_cast<int64_t>(blockIdx.x) * kMergeThreads + threadIdx.x) / group;
  if (split >= static_cast<int64_t>(receivers) * count) return;   // the whole group
  const int lane = threadIdx.x & 31, s = lane & (group - 1);
  const unsigned mask = group == 32 ? 0xFFFFFFFFu : ((1u << group) - 1u) << (lane & ~(group - 1));
  const int r = static_cast<int>(split / count);
  const long long p = (split - static_cast<int64_t>(r) * count) * step;
  const int32_t* up = parent + static_cast<int64_t>(r) * pcount * nb;
  const long long j = p / pstep;
  int c;
  if (j >= pcount - 1) {
    c = s < nb ? up[static_cast<int64_t>(pcount - 1) * nb + s] : 0;
  } else {
    const int a = s < nb ? up[j * nb + s] : 0;
    const int b = s < nb ? up[(j + 1) * nb + s] : 0;
    const long long q = p - j * pstep;
    const int total = group_sum(b - a, mask, group);
    if (q == 0) {
      c = a;
    } else if (q >= total) {
      c = b;
    } else {
      const int2* run = data + (static_cast<int64_t>(r) * nb + (s < nb ? s : 0)) * cap;
      c = merge_corank(reinterpret_cast<const int32_t*>(run), a, b, static_cast<int>(q), mask,
                       group, s);
    }
  }
  if (s < nb) splits[split * nb + s] = c;
}

// One merge-path round: ranges of w runs each, paired (runs [2gw, 2gw + w)
// and [2gw + w, 2gw + 2w)), merged from `in` into `out`, ties to the first
// range of the pair.  start[s]: where run s begins in the tile; m = start[nb].
__device__ __forceinline__ void merge_round(const int2* in, int2* out, const int* start, int nb,
                                            int w, int m) {
  int o = threadIdx.x * kMergeItems;
  if (o >= m) return;
  const int end = o + kMergeItems < m ? o + kMergeItems : m;
  auto bound = [&](int run) { return start[run < nb ? run : nb]; };
  int g = 0;
  while (bound(2 * w * (g + 1)) <= o) ++g;
  int lo = bound(2 * w * g), mid = bound(2 * w * g + w), hi = bound(2 * w * (g + 1));
  // merge path: i0 of the pair's first o - lo outputs come from its first range
  const int d = o - lo;
  int i0 = d > hi - mid ? d - (hi - mid) : 0, i1 = d < mid - lo ? d : mid - lo;
  while (i0 < i1) {
    const int im = (i0 + i1) >> 1;
    if (in[merge_slot(lo + im)].x <= in[merge_slot(mid + d - 1 - im)].x) {
      i0 = im + 1;
    } else {
      i1 = im;
    }
  }
  int i = lo + i0, j = mid + d - i0;             // the two heads, as tile positions
  int2 x = i < mid ? in[merge_slot(i)] : make_int2(0, 0);
  int2 y = j < hi ? in[merge_slot(j)] : make_int2(0, 0);
  for (; o < end; ++o) {
    while (o == hi) {                            // the pair is done: the next starts here
      ++g;
      lo = hi;
      mid = bound(2 * w * g + w);
      hi = bound(2 * w * (g + 1));
      i = lo;
      j = mid;
      if (i < mid) x = in[merge_slot(i)];
      if (j < hi) y = in[merge_slot(j)];
    }
    const bool first = j >= hi || (i < mid && x.x <= y.x);
    out[merge_slot(o)] = first ? x : y;
    if (first) {
      if (++i < mid) x = in[merge_slot(i)];
    } else {
      if (++j < hi) y = in[merge_slot(j)];
    }
  }
}

// Tile t of receiver r: outputs [t * kMergeTile, ...) of its row, the records
// between the splits of t and t + 1 (splits[r, t] and [r, t + 1]).
__global__ void __launch_bounds__(kMergeThreads, 3)
merge_runs_kernel(const int2* __restrict__ data, int nb, long long cap,
                  const int32_t* __restrict__ splits, int count, int32_t* __restrict__ out_src,
                  int32_t* __restrict__ out_dst, uint8_t* __restrict__ out_valid) {
  extern __shared__ int2 merge_buf[];             // two buffers of kMergeBuf records
  __shared__ int start[kMergeMaxRuns + 1];
  __shared__ long long offset[kMergeMaxRuns];    // tile position i of run s: data[offset[s] + i]
  const int t = blockIdx.x, r = blockIdx.y;
  const long long row = nb * cap, p0 = static_cast<long long>(t) * kMergeTile;
  const int len = row - p0 < kMergeTile ? static_cast<int>(row - p0) : kMergeTile;
  if (threadIdx.x == 0) {
    const int32_t* at = splits + (static_cast<int64_t>(r) * count + t) * nb;
    int acc = 0;
    for (int s = 0; s < nb; ++s) {
      start[s] = acc;
      offset[s] = (static_cast<long long>(r) * nb + s) * cap + at[s] - acc;
      acc += at[nb + s] - at[s];
    }
    start[nb] = acc;
  }
  __syncthreads();
  const int m = start[nb];                        // live records of the tile, the same in the block
  const int2* tile = merge_buf;
  if (m > 0) {
    int2 v[kMergeItems];
    int s = 0;
#pragma unroll
    for (int k = 0; k < kMergeItems; ++k) {
      const int i = k * kMergeThreads + threadIdx.x;
      if (i < m) {
        while (start[s + 1] <= i) ++s;
        v[k] = __ldcs(data + offset[s] + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kMergeItems; ++k) {
      const int i = k * kMergeThreads + threadIdx.x;
      if (i < m) merge_buf[merge_slot(i)] = v[k];
    }
    __syncthreads();
    int2* in = merge_buf;
    int2* out = merge_buf + kMergeBuf;
    for (int w = 1; w < nb; w <<= 1) {
      merge_round(in, out, start, nb, w, m);
      __syncthreads();
      int2* done = out;
      out = in;
      in = done;
    }
    tile = in;
  }
  int32_t* os = out_src + r * row + p0;
  int32_t* od = out_dst + r * row + p0;
  uint8_t* ov = out_valid + r * row + p0;
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    const int i = k * kMergeThreads + threadIdx.x;
    if (i < len) {
      const int2 x = i < m ? tile[merge_slot(i)] : make_int2(0, 0);
      __stcs(os + i, x.x);
      __stcs(od + i, x.y);
      ov[i] = i < m;
    }
  }
}

// The MapShape of a [rows, row_len] map from `in` to `out`; true where no
// vector fits both (the SCALAR instance, which reads the flat array).  Rows
// that would not keep every row's head alike, or too many of them, are
// mapped as one flat row.
bool map_shape(const int32_t* in, const int32_t* out, long long rows, long long row_len,
               MapShape* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(in), b = reinterpret_cast<uintptr_t>(out);
  if (rows > 1 && (row_len % 4 || rows > kMapMaxRows)) {
    row_len *= rows;
    rows = 1;
  }
  s->rows = static_cast<int>(rows);
  s->row_len = row_len;
  const bool scalar = (a % 16) != (b % 16);
  const long long head = scalar ? 0 : (16 - a % 16) % 16 / 4;
  s->head = static_cast<int>(head < row_len ? head : row_len);
  s->nvec = scalar ? 0 : static_cast<uint32_t>((row_len - s->head) / 4);
  s->tail = scalar ? 0 : static_cast<int>(row_len - s->head - 4LL * s->nvec);
  return scalar;
}

// Launches the map f over [rows, row_len] ids: the Vector instance, or the
// Scalar one where no 16-byte vector fits both `in` and `out`.  The grid is
// as many blocks as are resident on the card at once (counted once per
// instance and device), fewer where there are fewer tiles, and at least one,
// which maps the rows' heads and tails.
template <typename F, void (*Scalar)(const int32_t*, int32_t*, MapShape, F),
          void (*Vector)(const int32_t*, int32_t*, MapShape, F)>
int launch_map(const int32_t* in, int32_t* out, long long rows, long long row_len, const F& f,
               void* stream) {
  MapShape s;
  const bool scalar = map_shape(in, out, rows, row_len, &s);
  const auto kernel = scalar ? Scalar : Vector;
  static int resident[2][64] = {};
  int dev = 0, err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& fit = resident[scalar][dev];
  if (!fit) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMapThreads, 0)))
      return err;
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  // vectors a thread if every resident block took one tile
  const long long spread = static_cast<long long>(s.nvec) * s.rows / (1LL * fit * kMapThreads);
  s.vecs = spread >= kMapVecs ? kMapVecs : spread >= 2 ? 2 : 1;
  const uint32_t tile = kMapThreads * s.vecs;
  s.tiles = (s.nvec + tile - 1) / tile * s.rows;
  const long long per_block = kMapThreads * kMapScalarIds;
  const long long work = scalar ? (s.row_len * s.rows + per_block - 1) / per_block : s.tiles;
  const unsigned grid = static_cast<unsigned>(work < 1 ? 1 : work < fit ? work : fit);
  kernel<<<grid, kMapThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, s, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* graph_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rmat_edges_launch(void* src, void* dst, long long count, unsigned start, unsigned seed,
                      int scale, unsigned t_src, unsigned t_dst0, unsigned t_dst1,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o_src = static_cast<int32_t*>(src);
  int32_t* o_dst = static_cast<int32_t*>(dst);
  const unsigned grid = grid_for(count);
  switch (scale) {
#define RMAT_CASE(S)                                                              \
  case S:                                                                         \
    rmat_edges_kernel<S><<<grid, kThreads, 0, s>>>(o_src, o_dst, count, start, seed, \
                                                   t_src, t_dst0, t_dst1);        \
    break;
    RMAT_CASE(1) RMAT_CASE(2) RMAT_CASE(3) RMAT_CASE(4) RMAT_CASE(5) RMAT_CASE(6)
    RMAT_CASE(7) RMAT_CASE(8) RMAT_CASE(9) RMAT_CASE(10) RMAT_CASE(11) RMAT_CASE(12)
    RMAT_CASE(13) RMAT_CASE(14) RMAT_CASE(15) RMAT_CASE(16) RMAT_CASE(17) RMAT_CASE(18)
    RMAT_CASE(19) RMAT_CASE(20) RMAT_CASE(21) RMAT_CASE(22) RMAT_CASE(23) RMAT_CASE(24)
    RMAT_CASE(25) RMAT_CASE(26) RMAT_CASE(27) RMAT_CASE(28) RMAT_CASE(29) RMAT_CASE(30)
    RMAT_CASE(31)
#undef RMAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int feistel_perm_launch(const void* x, void* out, long long n, int nbits, int rounds,
                        const unsigned* keys, void* stream) {
  if (rounds < 0 || rounds > kMaxFeistelRounds || nbits < 1 || nbits > 31 || n < 0 ||
      n >= kMapMaxIds)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lo_bits = nbits / 2;
  RoundKeys rk{};
  for (int r = 0; r < rounds; ++r) rk.k[r] = keys[r];
  const uint32_t hi_mask = (1u << (nbits - lo_bits)) - 1u, lo_mask = (1u << lo_bits) - 1u;
  const int32_t* in = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  switch (rounds) {
#define FEISTEL_CASE(R)                                                                    \
  case R:                                                                                  \
    return launch_map<FeistelMap<R>, feistel_perm_kernel<R, true>, feistel_perm_kernel<R, false>>( \
        in, o, 1, n, FeistelMap<R>{rk, lo_bits, hi_mask, lo_mask}, stream);
    FEISTEL_CASE(2) FEISTEL_CASE(4) FEISTEL_CASE(6) FEISTEL_CASE(8)
#undef FEISTEL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// keys and out: [rows, row_len], contiguous, out disjoint from chunk and
// either keys itself or disjoint from it; rows > 1 interleaves the rows'
// tiles (a field of sorted rows).
int relabel_gather_launch(const void* keys, const void* chunk, void* out, long long rows,
                          long long row_len, long long chunk_len, long long base, void* stream) {
  if (rows < 1 || row_len < 0 || rows * row_len >= kMapMaxIds)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_map<GatherMap, relabel_gather_kernel<true>, relabel_gather_kernel<false>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(out), rows, row_len,
      GatherMap{static_cast<const int32_t*>(chunk), chunk_len, base}, stream);
}

// counts [k] from partials [grid, k] (scratch), ticket (one unsigned, 0 on
// entry and on return); bins: 4, 8, 16 or 32 (registers, >= k) or 0 (shared
// memory, `copies` histograms per block).  n < 2^31; dest 4-byte aligned.
int bucket_hist_launch(const void* dest, long long n, int k, int bins, int grid, int copies,
                       void* partials, void* ticket, void* counts, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dest);
  if (addr % 4 || n < 0 || n >= (1LL << 31) || k < 1 || grid < 1 || copies < 1 ||
      (bins > 0 && bins < k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int head = static_cast<int>(n < static_cast<long long>((16 - addr % 16) % 16 / 4)
                                        ? n : (16 - addr % 16) % 16 / 4);
  const int64_t nvec = (n - head) / 4;
  const int tail = static_cast<int>(n - head - 4 * nvec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* d = static_cast<const int32_t*>(dest);
  uint32_t* p = static_cast<uint32_t*>(partials);
  unsigned* t = static_cast<unsigned*>(ticket);
  int32_t* c = static_cast<int32_t*>(counts);
  switch (bins) {
#define HIST_CASE(K)                                                                      \
  case K:                                                                                 \
    bucket_hist_kernel<K><<<grid, kHistThreads, 0, s>>>(d, head, nvec, tail, k, 1, p, t, c); \
    break;
    HIST_CASE(4) HIST_CASE(8) HIST_CASE(16) HIST_CASE(32)
#undef HIST_CASE
    case 0:
      bucket_hist_kernel<0><<<grid, kHistThreads, sizeof(uint32_t) * copies * k, s>>>(
          d, head, nvec, tail, k, copies, p, t, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// data [receivers, nb, cap] (src, dst) int32 pairs, 8-byte aligned; valid
// [receivers, nb, cap] bytes, each bucket's live slots a prefix; scratch:
// bounds [receivers, 2, nb], coarse [receivers, chunks + 1, nb] and fine
// [receivers, tiles + 1, nb] int32 (chunks, tiles: nb * cap over kMergeTile *
// kMergeFan and over kMergeTile, rounded up); out_src, out_dst [receivers,
// nb * cap] int32, out_valid [receivers, nb * cap] bytes.  1 <= receivers,
// 1 <= nb <= 32, cap >= 1, nb * cap < 2^31.
int merge_runs_launch(const void* data, const void* valid, int receivers, int nb, long long cap,
                      void* bounds, void* coarse, void* fine, void* out_src, void* out_dst,
                      void* out_valid, void* stream) {
  if (receivers < 1 || receivers > 65535 || nb < 1 || nb > kMergeMaxRuns || cap < 1 ||
      nb * cap >= (1LL << 31) || reinterpret_cast<uintptr_t>(data) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row = nb * cap, chunk = static_cast<long long>(kMergeTile) * kMergeFan;
  const int tiles = static_cast<int>((row + kMergeTile - 1) / kMergeTile);
  const int chunks = static_cast<int>((row + chunk - 1) / chunk);
  int group = 1;
  while (group < nb) group <<= 1;
  const int2* d = static_cast<const int2*>(data);
  int32_t* b = static_cast<int32_t*>(bounds);
  int32_t* c = static_cast<int32_t*>(coarse);
  int32_t* f = static_cast<int32_t*>(fine);
  int err = 0;
  merge_lengths_kernel<<<(receivers * nb + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                         st>>>(static_cast<const uint8_t*>(valid), receivers, nb, cap, b);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const long long coarse_threads = static_cast<long long>(receivers) * (chunks + 1) * group;
  merge_splits_kernel<<<static_cast<unsigned>((coarse_threads + kMergeThreads - 1) / kMergeThreads),
                        kMergeThreads, 0, st>>>(d, receivers, nb, cap, group, b, 2, row, c,
                                                chunks + 1, chunk);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const long long fine_threads = static_cast<long long>(receivers) * (tiles + 1) * group;
  merge_splits_kernel<<<static_cast<unsigned>((fine_threads + kMergeThreads - 1) / kMergeThreads),
                        kMergeThreads, 0, st>>>(d, receivers, nb, cap, group, c, chunks + 1, chunk,
                                                f, tiles + 1, kMergeTile);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = static_cast<int>(cudaFuncSetAttribute(
           merge_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMergeSmem))))
    return err;
  merge_runs_kernel<<<dim3(tiles, receivers), kMergeThreads, kMergeSmem, st>>>(
      d, nb, cap, f, tiles + 1, static_cast<int32_t*>(out_src), static_cast<int32_t*>(out_dst),
      static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

// Copies `bytes` from `src` on device `src_device` to `dst` on device
// `dst_device`, on `stream` (the sender's): peer to peer where access
// between the two is enabled, else staged through the host by CUDA.
int copy_peer_launch(void* dst, int dst_device, const void* src, int src_device, long long bytes,
                     void* stream) {
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == 0) return 0;
  return static_cast<int>(cudaMemcpyPeerAsync(dst, dst_device, src, src_device,
                                              static_cast<size_t>(bytes),
                                              static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
