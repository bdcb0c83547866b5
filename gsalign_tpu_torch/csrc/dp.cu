// Batched ksw2 extz2 global alignment with traceback, hand-written for
// Hopper (sm_90a). Bound to Python through ops/dp_cuda.py (ctypes).
//
// Replaces the JAX package's Pallas kernels in gsalign_tpu/ops/dp_pallas.py:
//   dp_small  <- dp_align_batch_pallas (_dp_kernel), L <= 256: a warp a
//                problem, several problems a block, the packed directions
//                (L*L/2 bytes) in shared memory.
//   dp_any    <- dp_align_batch_pallas_big (_dp_fwd_kernel + _dp_tb_kernel),
//                256 < L <= 2048, and the lax.scan route the JAX package
//                takes above 2048 (ops/dp.py dp_align_batch): any L, a chain
//                of warps a problem that may run on through the blocks of a
//                thread block cluster, the packed directions in a global
//                scratch of B*L*L/2 bytes, read back by windows.
//
// Recurrence (same as ops/dp.py, the plain torch version these kernels are
// held against): cell (i, j), target row i and query column j, takes x and v
// from the cell above it (i-1, j) and u and y from the cell to its left
// (i, j-1); the borders are cell-local (column 0: u = gap open if i > 0 else
// 0, y = 0; row 0: x = 0, v = gap open if j > 0 else 0). Match +1, mismatch
// -1, wildcard (code >= 4) 0, gap open 2, extend 1, clamp at MAX_SC.
// Direction nibble: dmain on bits 0-1, x>0 (E-continue) on bit 2, y>0
// (F-continue) on bit 3. Any order of the cells that respects the two
// arrows gives the same nibbles; the traceback is ksw2's state machine.
//
// What bounds it on this card is operations, not bytes (about 30 integer
// operations a cell against 4 bytes a base), and, for one large problem,
// the length of its chain of warps: a warp on its own takes 40 to 45 ns a
// cell of its lanes' columns, so the time of a launch falls with the warps
// it keeps in flight and a large problem needs many warps, on many SMs.
// The design:
//   - a warp owns a strip of 32*K consecutive target rows, K a lane, and
//     streams the query's columns through it: at step s lane l computes
//     column s - l of its K rows. u, y and the target codes stay in
//     registers; x + v and v of a lane's bottom row reach the next lane by
//     __shfl_up_sync, once a step. No block barrier and no shared-memory
//     state in the forward pass; the query is staged once into shared
//     memory. A warp is bound by the instructions it executes, not by the
//     chain of its cells, so the cell is kept short (a byte table for the
//     score, nothing packed between two steps).
//   - directions are packed 8 nibbles a 32-bit word, the 8 steps of one
//     chunk, and each word is stored once and never read in the forward
//     pass. Lane l keeps column j of a row at nibble position (j + l) mod L
//     of that row, so all 32 lanes finish a word at the same step and a
//     store is 32 consecutive words (ops/dp_cuda.dir_word_index is the same
//     map in Python). The one word of a row that both ends of the lane's run
//     share stays in a register until the run ends.
//   - dp_any chains the strips: the bottom lane of a warp hands x and v,
//     column by column, to the top lane of the next through a 32-column ring
//     in the consumer's shared memory, signalled a chunk of 8 columns at a
//     time by a release store and an acquire load at cluster scope; a count
//     of columns taken flows back the same way. The next warp may be in the
//     next block of the cluster (distributed shared memory), so a large
//     problem runs on up to 8 SMs. Rows beyond one pass of the chain
//     run as further passes, the last row of a pass kept in a global row
//     buffer.
//   - the traceback is walked by a whole warp in step (every lane holds the
//     same state; lane 0 writes), four ops a 32-bit store; dp_any loads the
//     direction words around the current cell by windows of 16 chunks of
//     one strip (coalesced 16-byte loads) instead of one dependent global
//     read a step. The warp then writes the OP_PAD tail.
//
// Output: uint8 [B, 2L] per problem, reverse-order ops (M=0, D=1, I=2)
// written contiguously from column 0, then OP_PAD (3) to the end.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "dp_dev.cuh"

namespace {

constexpr int kMatch = 1;
constexpr int kMismatch = -1;
constexpr int kGapOpen = 2;
constexpr int kQE2 = 6;      // 2 * (gap open + gap extend)
constexpr int kMaxSc = 7;    // match + kQE2
constexpr int kWildcard = 4;
constexpr uint32_t kOpM = 0, kOpD = 1, kOpI = 2;
constexpr uint32_t kPadWord = 0x03030303u;   // four OP_PAD

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 8;        // steps a chunk = nibbles a direction word
constexpr int kRing = 32;        // columns a ring between two warps holds
constexpr int kWinChunks = 16;   // chunks of one strip a traceback window holds

// How a strip of a chain gets the row above it and gives its last row.
// A ring slot is v << 8 | x of one column. Counters hold `base` + columns;
// base grows from pass to pass.
struct Link {
  int in_kind = 0;              // 0 the DP's top border, 1 ring, 2 row buffer
  const uint16_t* in_ring = nullptr;   // this warp's ring (own shared memory)
  const int* produced = nullptr;       // columns written to it (own)
  int* consumed_up = nullptr;          // the producer's counter (maybe remote)
  const uint16_t* in_row = nullptr;    // the pass before's last row (global)
  int out_kind = 0;             // 0 none, 1 ring, 2 row buffer
  uint16_t* out_ring = nullptr;        // the next warp's ring (maybe remote)
  int* produced_down = nullptr;        // its counter (maybe remote)
  const int* consumed = nullptr;       // columns it has taken (own)
  uint16_t* out_row = nullptr;         // this pass's last row (global)
  int base = 0;
};

__device__ __forceinline__ void wait_for(const int* counter, int base,
                                         int need) {
  while (dpdev::ld_acquire_cluster(counter) - base < need) __nanosleep(20);
  __syncwarp();
}

// Forward pass of one strip by one warp: rows row0 + lane*kr + k, k < kr
// (kr <= K rows a lane), all ql columns. dirs: this strip's direction
// words, word (chunk mod NG) * kr * 32 + k * 32 + lane.
template <int K, bool CHAIN>
__device__ __forceinline__ void strip_forward(
    const uint8_t* qs, int ql, const uint8_t* __restrict__ t, int tl,
    int row0, int kr, uint32_t* dirs, int NG, const Link& lk) {
  const int lane = threadIdx.x & 31;
  const int grow = row0 + lane * kr;   // this lane's first row
  // tz[k]: byte c is match/mismatch + kQE2 of row k against query code c
  // (wildcard rows: all kQE2). u and y start at column 0's border and are
  // not written before it.
  int u[K], y[K];
  uint32_t tz[K], cur[K], head[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int row = grow + k;
    const int tc = (k < kr && row < tl) ? t[row] : kWildcard;
    tz[k] = tc >= kWildcard
                ? 0x01010101u * kQE2
                : 0x01010101u * (kMismatch + kQE2) +
                      (static_cast<uint32_t>(kMatch - kMismatch) << (8 * tc));
    u[k] = row > 0 ? kGapOpen : 0;
    y[k] = 0;
    cur[k] = 0;
    head[k] = 0;
  }
  // what this lane's bottom row hands down: a = x + v and v (x and v are
  // only ever needed as that sum and as v alone), not packed, so that no
  // packing stands between one step's last cell and the next step's first
  int a_bot = 0, v_bot = 0;
  const int head_g = lane >> 3;  // the chunk in which this lane starts
  uint32_t pre = 0;              // the row buffer, one chunk ahead of its use
  if (CHAIN && lk.in_kind == 2)
    pre = (lane < kChunk && lane < ql) ? __ldcg(lk.in_row + lane) : 0;
  const int nsteps = ql + 31;
  for (int s0 = 0; s0 < nsteps; s0 += kChunk) {
    // the row above, for the columns lane 0 takes in this chunk: lane e
    // holds column s0 + e as v << 8 | x
    uint32_t in_val;
    const int c_in = s0 + lane;
    if (CHAIN && lk.in_kind == 1) {
      wait_for(lk.produced, lk.base, min(s0 + kChunk, ql));
      in_val = (lane < kChunk && c_in < ql) ? lk.in_ring[c_in & (kRing - 1)]
                                            : 0;
      __syncwarp();
      if (lane == 0)
        dpdev::st_release_cluster(lk.consumed_up,
                                  lk.base + min(s0 + kChunk, ql));
    } else if (CHAIN && lk.in_kind == 2) {
      in_val = pre;
      const int c = c_in + kChunk;
      pre = (lane < kChunk && c < ql) ? __ldcg(lk.in_row + c) : 0;
    } else {
      in_val = c_in > 0 ? (kGapOpen << 8) : 0;   // x = 0, v = gap open
    }
    const int in_v = static_cast<int>(static_cast<int8_t>(in_val >> 8));
    const int in_a = static_cast<int>(in_val & 0xff) + in_v;
    if (CHAIN && lk.out_kind == 1) {
      // the ring slots lane 31 writes in this chunk must have been taken
      const int need = min(s0 + kChunk - 32, ql - 1) - kRing + 1;
      if (need > 0) wait_for(lk.consumed, lk.base, need);
    }
    uint32_t sent[kChunk];   // v << 8 | x of the bottom row, step by step
    // the chunk's query codes, read ahead of the steps that use them: each
    // selects byte (query code) of tz[k], or kQE2 for a wildcard; the other
    // three bytes of the result are 0
    uint32_t qsels[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int col = s0 + e - lane;
      qsels[e] = (static_cast<unsigned>(col) < static_cast<unsigned>(ql)
                      ? qs[col]
                      : kWildcard) | 0x5550u;
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int col = s0 + e - lane;
      const bool ok = static_cast<unsigned>(col) < static_cast<unsigned>(ql);
      const uint32_t qsel = qsels[e];
      const uint32_t nib_at = ok ? 1u << (4 * e) : 0u;   // this step's nibble
      const bool started = col >= 0;
      int a = __shfl_up_sync(kFull, a_bot, 1);
      int v = __shfl_up_sync(kFull, v_bot, 1);
      const int top_a = __shfl_sync(kFull, in_a, e);
      const int top_v = __shfl_sync(kFull, in_v, e);
      if (lane == 0) {
        a = top_a;
        v = top_v;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < kr) {
          const int uu = u[k];
          const int b = y[k] + uu;
          // ties keep the earlier choice: a > z, then b > z, strictly
          bool z_ge_a, z_ge_b;
          int z = __vibmax_s32(
              static_cast<int>(__byte_perm(tz[k], kQE2, qsel)), a, &z_ge_a);
          z = min(__vibmax_s32(z, b, &z_ge_b), kMaxSc);
          const int d = z_ge_b ? (z_ge_a ? 0 : 1) : 2;
          const int x1 = min(max(a - z + kGapOpen, 0), 1);   // x > 0
          const int yn = max(b - z + kGapOpen, 0);
          if (started) {
            u[k] = z - v;
            y[k] = yn;
          }
          v = z - uu;
          // x + v of this row, for the row below: max(a - z + 2, 0) + z - uu
          a = max(a + kGapOpen, z) - uu;
          // d | (x > 0) << 2 | (y > 0) << 3 at this step's nibble
          cur[k] += static_cast<uint32_t>(d + 4 * x1 + 8 * min(yn, 1)) *
                    nib_at;
        }
      }
      a_bot = a;
      v_bot = v;
      if (CHAIN) sent[e] = ((a - v) & 0xff) | ((v & 0xff) << 8);
    }
    if (CHAIN && lane == 31 && lk.out_kind != 0) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const int col = s0 + e - 31;
        if (static_cast<unsigned>(col) < static_cast<unsigned>(ql)) {
          if (lk.out_kind == 1)
            lk.out_ring[col & (kRing - 1)] = static_cast<uint16_t>(sent[e]);
          else
            lk.out_row[col] = static_cast<uint16_t>(sent[e]);
        }
      }
    }
    // this chunk's words: each is stored once. The chunk a lane starts in
    // is also the one its run may end in after wrapping (mod NG): that
    // word waits in `head` for the end of the run.
    const bool active = s0 + kChunk - 1 >= lane && s0 < lane + ql;
    int g = s0 >> 3;
    if (g >= NG) g -= NG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kr && active) {
        if (g == head_g)
          head[k] |= cur[k];
        else
          dirs[(g * kr + k) * 32 + lane] = cur[k];
      }
      cur[k] = 0;
    }
    if (CHAIN && lk.out_kind == 1) {
      // the chunk's columns are in the ring before the count says so
      __syncwarp();
      if (lane == 31)
        dpdev::st_release_cluster(
            lk.produced_down,
            lk.base + max(0, min(s0 + kChunk - 31, ql)));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < kr) dirs[(head_g * kr + k) * 32 + lane] = head[k];
}

// Direction words of dp_small: one strip, in shared memory.
struct SmemDirs {
  const uint32_t* words;
  int NG, kr;
  __device__ __forceinline__ uint32_t word(int /*strip*/, int ln, int k,
                                           int g) {
    if (g >= NG) g -= NG;
    return words[(g * kr + k) * 32 + ln];
  }
};

// Direction words of dp_any: in global memory, read through a window in
// shared memory of up to kWinChunks chunks of one strip, ending at the
// chunk first asked for. A walk inside a strip only moves to lower chunks.
template <int K>
struct WindowDirs {
  const uint32_t* words;   // the problem's scratch
  uint32_t* win;           // kWinChunks * K * 32 words of shared memory
  int NG;
  int strip = -1, g_lo = 0;
  __device__ __forceinline__ uint32_t word(int s, int ln, int k, int g) {
    if (s != strip || g < g_lo) {   // warp-uniform
      __syncwarp();
      strip = s;
      g_lo = max(g - kWinChunks + 1, 0);
      const int lane = threadIdx.x & 31;
      const uint4* src = reinterpret_cast<const uint4*>(
          words + static_cast<size_t>(s) * NG * (K * 32));
      uint4* dst = reinterpret_cast<uint4*>(win);
      const int per = K * 8;   // 16-byte pieces a chunk
      for (int i = lane; i < (g - g_lo + 1) * per; i += 32) {
        int gg = g_lo + i / per;
        if (gg >= NG) gg -= NG;
        dst[i] = __ldcg(src + gg * per + i % per);
      }
      __syncwarp();
    }
    return win[((g - g_lo) * K + k) * 32 + ln];
  }
};

// ksw_backtrack (reference src/ksw2_alignment.cpp:25-68), full band, by a
// whole warp in step; lane 0 writes. kr rows a lane in every strip. out:
// the problem's L/2 op words.
template <class Dirs>
__device__ __forceinline__ void traceback(int ql, int tl, int kr, Dirs& dirs,
                                          uint32_t* __restrict__ out, int L) {
  const int lane = threadIdx.x & 31;
  int i = tl - 1;   // target row
  int j = ql - 1;   // query column
  int strip = 0, ln = 0, k = 0;
  if (i >= 0) {
    strip = i / (32 * kr);
    const int r = i - strip * 32 * kr;
    ln = r / kr;
    k = r - ln * kr;
  }
  int st = 0;
  int n = 0;
  uint32_t acc = 0;
  auto emit = [&](uint32_t op) {
    acc |= op << (8 * (n & 3));
    ++n;
    if ((n & 3) == 0) {
      if (lane == 0) out[(n >> 2) - 1] = acc;
      acc = 0;
    }
  };
  while (i >= 0 && j >= 0) {
    const int p = j + ln;
    const int tmp = (dirs.word(strip, ln, k, p >> 3) >> ((p & 7) * 4)) & 0xF;
    int s = st == 0 ? (tmp & 3) : (((tmp >> (st + 1)) & 1) ? st : 0);
    if (s == 0) s = tmp & 3;
    st = s;
    if (s == 0) {
      emit(kOpM);
      --j;
    } else if (s == 1 || s == 3) {
      emit(kOpD);
    } else {
      emit(kOpI);
      --j;
    }
    if (s != 2) {   // M and D consume a target row
      --i;
      if (--k < 0) {
        k = kr - 1;
        if (--ln < 0) {
          ln = 31;
          --strip;
        }
      }
    }
  }
  for (; i >= 0; --i) emit(kOpD);   // leading gap: T left over
  for (; j >= 0; --j) emit(kOpI);   // leading gap: Q left over
  if (n & 3) {
    acc |= kPadWord << (8 * (n & 3));
    if (lane == 0) out[n >> 2] = acc;
  }
  for (int w = ((n + 3) >> 2) + lane; w < L / 2; w += 32) out[w] = kPadWord;
}

__device__ __forceinline__ int clamp_len(int v, int L) {
  return v < 0 ? 0 : (v > L ? L : v);
}

// A warp a problem, blockDim.x / 32 problems a block. Shared memory of a
// warp: NG * K * 32 direction words (NG = L/8 chunks), then the
// query's L codes.
template <int K>
__global__ void dp_small_kernel(const uint8_t* __restrict__ q,
                                const uint8_t* __restrict__ t,
                                const int32_t* __restrict__ ql,
                                const int32_t* __restrict__ tl, int B, int L,
                                uint8_t* __restrict__ ops) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t b = static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= static_cast<size_t>(B)) return;
  const int NG = L / kChunk;
  const size_t per_warp = static_cast<size_t>(NG) * K * 32 * 4 + L;
  uint8_t* mine = dpdev::dyn_smem() + warp * per_warp;
  uint32_t* dirs = reinterpret_cast<uint32_t*>(mine);
  uint8_t* qs = mine + static_cast<size_t>(NG) * K * 32 * 4;
  const int qlen = clamp_len(ql[b], L);
  const int tlen = clamp_len(tl[b], L);
  const uint32_t* qsrc = reinterpret_cast<const uint32_t*>(q + b * L);
  for (int w = lane; w < L / 4; w += 32)
    reinterpret_cast<uint32_t*>(qs)[w] = qsrc[w];
  __syncwarp();
  // the rows a lane owns follow the target's length, so all lanes work
  const int kr = max(1, (tlen + 31) >> 5);
  if (qlen > 0 && tlen > 0)
    strip_forward<K, false>(qs, qlen, t + b * L, tlen, 0, kr, dirs, NG,
                            Link());
  __syncwarp();
  SmemDirs sd{dirs, NG, kr};
  traceback(qlen, tlen, kr, sd,
            reinterpret_cast<uint32_t*>(ops + b * 2 * L), L);
}

// A cluster of blocks a problem (blockIdx.x / cluster size), the warps of
// the cluster one chain: warp gw = rank * warps-a-block + warp owns rows
// [pass * R + gw * 32K, + 32K), R = the rows of one pass of the chain.
// Shared memory of a block: the query's L codes | a ring of kRing uint16 a
// warp | produced and consumed counters a warp | the traceback window.
// dirs: ceil(L / 32K) strips of NG * K * 32 words a problem. rows: two
// buffers of L uint16 a problem (the last row of a pass, by pass parity).
template <int K>
__global__ void dp_any_kernel(const uint8_t* __restrict__ q,
                              const uint8_t* __restrict__ t,
                              const int32_t* __restrict__ ql,
                              const int32_t* __restrict__ tl, int L,
                              uint8_t* __restrict__ ops, uint32_t* dirs,
                              uint16_t* rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int cs = dpdev::cluster_size();
  const int rank = dpdev::cluster_rank();
  const size_t b = blockIdx.x / cs;
  const int NG = L / kChunk;
  const int n_strips = (L + 32 * K - 1) / (32 * K);

  uint8_t* smem = dpdev::dyn_smem();
  uint8_t* qs = smem;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + L);
  int* produced = reinterpret_cast<int*>(ring + wpb * kRing);
  int* consumed = produced + wpb;
  uint32_t* win = reinterpret_cast<uint32_t*>(consumed + wpb + (wpb & 1) * 2);

  const int qlen = clamp_len(ql[b], L);
  const int tlen = clamp_len(tl[b], L);
  const uint4* qsrc = reinterpret_cast<const uint4*>(q + b * L);
  for (int w = threadIdx.x; w < L / 16; w += blockDim.x)
    reinterpret_cast<uint4*>(qs)[w] = qsrc[w];
  if (threadIdx.x < wpb) {
    produced[threadIdx.x] = 0;
    consumed[threadIdx.x] = 0;
  }
  // the counters are zero before any block of the cluster writes one
  dpdev::cluster_sync();

  uint32_t* my_dirs = dirs + b * n_strips * NG * (K * 32);
  uint16_t* my_rows = rows + b * 2 * L;
  const int chain = cs * wpb;              // warps of the chain
  const int gw = rank * wpb + warp;
  const int R = chain * 32 * K;            // rows of one pass
  const int n_pass = qlen > 0 ? (tlen + R - 1) / R : 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * R + gw * 32 * K;
    if (row0 < tlen) {
      Link lk;
      lk.base = pass * (L + 64);
      if (gw > 0) {
        lk.in_kind = 1;
        lk.in_ring = ring + warp * kRing;
        lk.produced = produced + warp;
        const int up = gw - 1;
        lk.consumed_up = dpdev::map_rank(consumed + up % wpb, up / wpb);
      } else if (pass > 0) {
        lk.in_kind = 2;
        lk.in_row = my_rows + ((pass - 1) & 1) * L;
      }
      if (row0 + 32 * K < tlen) {
        if (gw + 1 < chain) {
          lk.out_kind = 1;
          const int dn = gw + 1;
          lk.out_ring = dpdev::map_rank(ring + (dn % wpb) * kRing, dn / wpb);
          lk.produced_down = dpdev::map_rank(produced + dn % wpb, dn / wpb);
          lk.consumed = consumed + warp;
        } else {
          lk.out_kind = 2;
          lk.out_row = my_rows + (pass & 1) * L;
        }
      }
      strip_forward<K, true>(
          qs, qlen, t + b * L, tlen, row0, K,
          my_dirs + static_cast<size_t>(row0 / (32 * K)) * NG * (K * 32), NG,
          lk);
    }
    // the pass's last row, and after the last pass every direction word,
    // is written before anything reads it
    dpdev::cluster_sync();
  }
  if (rank == 0 && warp == 0) {
    WindowDirs<K> wd{my_dirs, win, NG};
    traceback(qlen, tlen, K, wd,
              reinterpret_cast<uint32_t*>(ops + b * 2 * L), L);
  }
}

// cudaFuncAttributeMaxDynamicSharedMemorySize is raised once per kernel
// instance and size, not on every call.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int* allowed, size_t bytes) {
  if (bytes <= static_cast<size_t>(*allowed)) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) *allowed = static_cast<int>(bytes);
  return e;
}

template <int K>
int launch_small(const void* q, const void* t, const void* ql, const void* tl,
                 int B, int L, void* ops, int wpb, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const size_t smem =
      static_cast<size_t>(wpb) * (static_cast<size_t>(L / kChunk) * K * 128 + L);
  cudaError_t e = allow_smem(dp_small_kernel<K>, &allowed, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + wpb - 1) / wpb);
  cfg.blockDim = dim3(32 * wpb);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(
      &cfg, dp_small_kernel<K>, static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(t), static_cast<const int32_t*>(ql),
      static_cast<const int32_t*>(tl), B, L, static_cast<uint8_t*>(ops));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_any(const void* q, const void* t, const void* ql, const void* tl,
               int B, int L, void* ops, void* dirs, void* rows, int wpb,
               int cs, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const size_t smem = static_cast<size_t>(L) + wpb * (kRing * 2 + 8) +
                      (wpb & 1) * 8 + kWinChunks * K * 128;
  cudaError_t e = allow_smem(dp_any_kernel<K>, &allowed, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cs);
  cfg.blockDim = dim3(32 * wpb);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, dp_any_kernel<K>, static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(t), static_cast<const int32_t*>(ql),
      static_cast<const int32_t*>(tl), L, static_cast<uint8_t*>(ops),
      static_cast<uint32_t*>(dirs), static_cast<uint16_t*>(rows));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Pointers are device pointers; stream is a cudaStream_t.
// Each returns a CUDA error code (0 = launched). L is a multiple of 32.
// K: rows a lane, 2, 4 or 8; wpb: warps a block.

// dp_small: 32 * K >= L; wpb problems a block.
extern "C" int gsalign_dp_small(const void* q, const void* t, const void* ql,
                                const void* tl, int B, int L, void* ops,
                                int K, int wpb, void* stream) {
  if (B <= 0) return 0;
  if (L < 32 || L % 32 != 0 || 32 * K < L || wpb < 1 || wpb > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return launch_small<2>(q, t, ql, tl, B, L, ops, wpb, s);
    case 4: return launch_small<4>(q, t, ql, tl, B, L, ops, wpb, s);
    case 8: return launch_small<8>(q, t, ql, tl, B, L, ops, wpb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dp_any: a cluster of cs blocks (1 to 8) of wpb warps a problem. dirs:
// B * ceil(L / 32K) * L * K * 16 bytes (B*L*L/2 where 32K divides L); rows:
// B * 2 * L uint16.
extern "C" int gsalign_dp_any(const void* q, const void* t, const void* ql,
                              const void* tl, int B, int L, void* ops,
                              void* dirs, void* rows, int K, int wpb, int cs,
                              void* stream) {
  if (B <= 0) return 0;
  if (L < 32 || L % 32 != 0 || wpb < 1 || wpb > 32 || cs < 1 || cs > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return launch_any<2>(q, t, ql, tl, B, L, ops, dirs, rows, wpb, cs, s);
    case 4: return launch_any<4>(q, t, ql, tl, B, L, ops, dirs, rows, wpb, cs, s);
    case 8: return launch_any<8>(q, t, ql, tl, B, L, ops, dirs, rows, wpb, cs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
