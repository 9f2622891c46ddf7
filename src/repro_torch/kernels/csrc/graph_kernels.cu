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
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgraph_kernels.so graph_kernels.cu

#include <cuda_runtime.h>
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

}  // extern "C"
