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
// k, negatives) is not counted.  Each block keeps a histogram in shared
// memory.  With k = nb = 8 every thread of a warp hits one of 8 bins, so the
// warp first groups equal ids with __match_any_sync and one leader per group
// adds the group's size: at most 8 shared atomics per warp step instead of
// 32.  One global atomicAdd per (block, nonzero bin) at the end.  Integer
// adds commute, so the result is exact.  Bound by bytes: 4 read per id.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
bucket_hist_kernel(const int32_t* __restrict__ dest, int64_t n, int k,
                   int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  for (int j = threadIdx.x; j < k; j += blockDim.x) hist[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // Every thread of a warp runs the same number of iterations (the loop
  // bound depends on the block only), so the full-warp mask is exact.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const int32_t d = i < n ? dest[i] : -1;
    const bool ok = d >= 0 && d < k;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, ok ? d : -1);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (hist[j]) atomicAdd(&counts[j], hist[j]);
  }
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

int bucket_hist_launch(const void* dest, long long n, int k, void* counts, int max_blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * static_cast<size_t>(k), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  bucket_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, sizeof(int32_t) * k, s>>>(
      static_cast<const int32_t*>(dest), n, k, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
