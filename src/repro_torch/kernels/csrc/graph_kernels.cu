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
// feistel_perm: one thread per element, the rounds unrolled (ROUNDS is a
// template parameter; the count is even, at most 8).  Keyed unbalanced
// Feistel over mix32 on [0, 2^nbits); round keys are folded on the host (the
// port's feistel_round_key) and passed by value.  `rounds` mix32 per element
// against 8 bytes moved.
// ---------------------------------------------------------------------------
struct RoundKeys {
  uint32_t k[kMaxFeistelRounds];
};

__device__ __forceinline__ uint32_t low_mask(int w) {
  return w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
}

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
feistel_perm_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t n,
                    int nbits, RoundKeys rk) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lo_bits = nbits / 2;
  const uint32_t v = static_cast<uint32_t>(x[i]);
  uint32_t L = v >> lo_bits;
  uint32_t R = v & low_mask(lo_bits);
  int wL = nbits - lo_bits, wR = lo_bits;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t F = mix32(R ^ rk.k[r]);
    const uint32_t nR = (L ^ F) & low_mask(wL);
    L = R;
    R = nR;
    const int t = wL;
    wL = wR;
    wR = t;
  }
  out[i] = static_cast<int32_t>((L << lo_bits) | R);
}

// ---------------------------------------------------------------------------
// relabel_gather: one thread per key, out = chunk[key - base] for keys in
// [base, base + B), the key itself otherwise.  The chunk (B = 2^23 int32 at
// scale 26, nb 8) is far beyond shared memory, so it is gathered from global
// memory; the keys are sorted, so neighbouring threads read neighbouring or
// equal chunk entries and the gather is close to a streaming read.  Bound by
// bytes: 4 read + 4 written per key, plus the chunk once.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
relabel_gather_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ chunk,
                      int32_t* __restrict__ out, int64_t n, int64_t B, int64_t base) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t key = keys[i];
  const int64_t local = static_cast<int64_t>(key) - base;
  out[i] = (local >= 0 && local < B) ? __ldg(chunk + local) : key;
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
  if (rounds < 0 || rounds > kMaxFeistelRounds) return static_cast<int>(cudaErrorInvalidValue);
  RoundKeys rk{};
  for (int r = 0; r < rounds; ++r) rk.k[r] = keys[r];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  const unsigned grid = grid_for(n);
  switch (rounds) {
#define FEISTEL_CASE(R)                                                       \
  case R:                                                                     \
    feistel_perm_kernel<R><<<grid, kThreads, 0, s>>>(in, o, n, nbits, rk);    \
    break;
    FEISTEL_CASE(2) FEISTEL_CASE(4) FEISTEL_CASE(6) FEISTEL_CASE(8)
#undef FEISTEL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int relabel_gather_launch(const void* keys, const void* chunk, void* out, long long n,
                          long long chunk_len, long long base, void* stream) {
  relabel_gather_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(chunk),
      static_cast<int32_t*>(out), n, chunk_len, base);
  return static_cast<int>(cudaGetLastError());
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
