// The INIT-10 jump rows of comb_pairs, built on the card, hand-written for
// Hopper (sm_90a). Bound to Python through ops/layout_cuda.py (ctypes) and
// called by ops/rank.DeviceFMIndex.from_host on a card.
//
// Replaces no TPU kernel: the JAX package builds these rows on the host in
// numpy (ops/rank.py `_build_c10`, `_c10_from_counts`), and so does the
// port's CPU layout, which stays the plain version. On the card the table
// is a pure function of the index text, and the host's histogram over the
// 2N text positions was most of a fresh layout.
//
// What it computes, for a text of n bases (n <= 2^26 + a few: an INIT-10
// index has seq_len <= INIT12_MIN_SEQLEN):
//   counts[k]  the number of 10-mers of the text with key k (the first base
//              in the key's high bits), k < 4^10;
//   the steps  a +1 on starts[lb:] for each suffix of the text shorter than
//              10 bases, lb its key padded with A; the host computes the lb
//              values from the text's last bases. A step at lb > 0 is a +1
//              on counts[lb - 1] before the scan, a step at lb 0 a +1 on
//              every start (`base`);
//   rows[k]    (start_k | start_{k+1} << 32): start_k = base + the
//              exclusive sum of counts up to k, start_{4^10} = the sum of
//              all, which is n + 1, the end row of the table.
// Integer atomics, so the counts do not depend on the order of the adds,
// and the rows equal the host's bit for bit.
//
// What bounds it on this card: at the synth_ecoli shape (9,283,304 bases)
// 2.3 MB of packed text read and 8.4 MB of rows written, 3.2 us at
// 3.35 TB/s; 4 MB of counts zeroed, counted into and read twice, all in
// the 50 MB L2; and 9.3 M atomic adds, resolved in L2 slices, which are the
// limit. The design: one thread a text word (16 starts) reads that word
// and the next once and forms its 16 keys by shifts, so the text is read
// once and the atomics are all that is issued per base; the counts are
// never private copies (4 MB fits no block's shared memory) but
// L2-resident. The scan is two passes over tiles of 1,024 bins, a warp a
// tile: the tiles' sums, then each warp adds the sums of the tiles before
// its own (at most 1,023 words, from L2), scans its lanes' runs of 32 bins
// by shuffles and writes 16-byte stores. A memset and three launches on
// the caller's stream, no synchronisation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kKeys = 1LL << 20;        // 4^10
constexpr int kTile = 1024;                   // bins a warp scans
constexpr long long kTiles = kKeys / kTile;
constexpr int kRun = kTile / 32;              // bins a lane scans
constexpr unsigned kFull = 0xFFFFFFFFu;

}  // namespace

// Must match ops/layout_cuda._Init10Args field for field.
struct Init10Args {
  const uint32_t* text;    // packed 2-bit bases, 16 a word, the first base
                           // in the high bits (pack_bwt_codes)
  uint32_t* counts;        // [4^10] scratch, zeroed here
  uint32_t* tile_sums;     // [4^10 / 1024] scratch
  uint32_t* rows;          // [4^10] int64 rows, as (low, high) word pairs
  long long stride;        // words from one group of 16 words to the next:
                           // 16 for packed words, 32 for text_rows (each
                           // group followed by the next, so word 16 of a
                           // group is the next group's first)
  long long n;             // bases of the text
  long long base;          // steps at lb 0
  long long n_bumps;       // steps at lb > 0, at most 10
  long long bumps[10];     // their lb
  long long max_blocks;    // a grid's blocks at most (0: as the work needs)
};

namespace {

// Words of the text holding a 10-mer start.
__host__ __device__ inline long long start_words(long long n) {
  return n >= 10 ? (n - 10) / 16 + 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
init10_count(const __grid_constant__ Init10Args a) {
  if (blockIdx.x == 0 && threadIdx.x < a.n_bumps)
    atomicAdd(&a.counts[a.bumps[threadIdx.x] - 1], 1u);
  const long long words = start_words(a.n);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < words; w += step) {
    const uint32_t* at = a.text + (w >> 4) * a.stride + (w & 15);
    const uint64_t pair = static_cast<uint64_t>(at[0]) << 32 | at[1];
    const long long left = a.n - 9 - 16 * w;  // 10-mers starting in word w
    const int m = left < 16 ? static_cast<int>(left) : 16;
    for (int i = 0; i < m; ++i)
      atomicAdd(&a.counts[(pair >> (44 - 2 * i)) & (kKeys - 1)], 1u);
  }
}

// The warp's first tile and the tiles between its next ones.
__device__ __forceinline__ long long first_tile() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}
__device__ __forceinline__ long long tile_step() {
  return static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
}

__global__ void __launch_bounds__(kThreads)
init10_tile_sums(const __grid_constant__ Init10Args a) {
  const int lane = threadIdx.x & 31;
  for (long long t = first_tile(); t < kTiles; t += tile_step()) {
    const uint4* c = reinterpret_cast<const uint4*>(a.counts + t * kTile);
    uint32_t s = 0;
    for (int j = 0; j < kTile / 128; ++j) {
      const uint4 v = c[j * 32 + lane];
      s += v.x + v.y + v.z + v.w;
    }
    s = __reduce_add_sync(kFull, s);
    if (lane == 0) a.tile_sums[t] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
init10_scan(const __grid_constant__ Init10Args a) {
  const int lane = threadIdx.x & 31;
  for (long long t = first_tile(); t < kTiles; t += tile_step()) {
    uint32_t pre = 0;
    for (long long i = lane; i < t; i += 32) pre += a.tile_sums[i];
    pre = __reduce_add_sync(kFull, pre) + static_cast<uint32_t>(a.base);
    const long long first = t * kTile + lane * kRun;
    const uint4* c = reinterpret_cast<const uint4*>(a.counts + first);
    uint4 v[kRun / 4];
    uint32_t s = 0;
    for (int j = 0; j < kRun / 4; ++j) {
      v[j] = c[j];
      s += v[j].x + v[j].y + v[j].z + v[j].w;
    }
    uint32_t inc = s;                          // inclusive over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    uint32_t at = pre + inc - s;
    uint4* out = reinterpret_cast<uint4*>(a.rows + 2 * first);
    for (int j = 0; j < kRun / 4; ++j) {       // two rows a store
      const uint32_t e0 = at + v[j].x, e1 = e0 + v[j].y, e2 = e1 + v[j].z,
                     e3 = e2 + v[j].w;
      out[2 * j] = make_uint4(at, e0, e0, e1);
      out[2 * j + 1] = make_uint4(e1, e2, e2, e3);
      at = e3;
    }
  }
}

unsigned grid(long long want, long long cap) {
  if (want < 1) want = 1;
  if (cap > 0 && want > cap) want = cap;
  return static_cast<unsigned>(want);
}

int launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// C entry point: zero the counts, count, sum the tiles, scan into the rows,
// in order on `stream` (a cudaStream_t). Pointers are device pointers.
// Returns the first CUDA error (0 = all launched).
extern "C" int gsalign_init10_rows(const Init10Args* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->n < 0 || args->n_bumps < 0 || args->n_bumps > 10)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(args->counts, 0, kKeys * sizeof(uint32_t),
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.gridDim = dim3(grid((start_words(args->n) + kThreads - 1) / kThreads,
                          args->max_blocks));
  int err = launched(cudaLaunchKernelEx(&cfg, init10_count, *args));
  if (err != 0) return err;
  cfg.gridDim = dim3(grid(kTiles / (kThreads / 32), args->max_blocks));
  if ((err = launched(cudaLaunchKernelEx(&cfg, init10_tile_sums, *args))))
    return err;
  return launched(cudaLaunchKernelEx(&cfg, init10_scan, *args));
}
