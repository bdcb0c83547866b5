// The seed step's cost probes, hand-written for Hopper (sm_90a). Bound to
// Python through ops/probe.py (ctypes). Instruments, on no align path:
//
//   seedcost      <- the JAX package's tools/exp_seedcost.py, which times
//                    K iterations of stripped XLA while_loops over a bench
//                    configuration's real index tables, adding one piece of
//                    the seed scan's loop body at a time (its `loop`, :66).
//                    Here B lanes, a warp a lane, take K iterations of one
//                    of the tool's six bodies (kPiece):
//                      0 floor        acc += look
//                      1 + q_rows     the query words at look (WarpMem::qword)
//                                     and their metadata (meta16); acc +=
//                                     cls12 + b1ok
//                      2 + comb       two comb_pairs words: the INIT-order
//                                     row and the next where the first base
//                                     is unambiguous, else the INIT-8 row and
//                                     the one `half` past it; acc += b - a
//                      3 + occ_t3     the triple-mode ranks at k2 and k2 + 100
//                                     (WarpMem::occ_pair, the RowGroup decode);
//                                     acc += the first
//                      4 + text+cmp   256 text bases against the query's
//                                     (text_window, first_mismatch); acc +=
//                                     the run
//                      5 + emit       where run & 7 == 0, one record
//                                     (cls12, a + cnt, run) into three planes
//                    with the tool's lane starts, look sequence and index
//                    clamps, and the scan's memory policy (seed_core.cuh: the
//                    same device functions, compiled again here), so a
//                    piece's time says what it costs inside seed_scan's step.
//   gather_sweep  <- the JAX package's tools/exp_sweep.py (its loop, :43): a
//                    thread a lane, K dependent random reads of an int32
//                    table, v = table[idx]; idx = (5 idx + v) mod n; acc += v,
//                    or of two tables at the same index (its two-call split).
//
// What the tool does and the scan does not, followed here: the text compare
// counts no ambiguity (the tool's mask has no ambiguity plane; run256 ORs
// the query's in); the text row is the tool's row p >> 8 of 128 words,
// compared from field p & 255 (the scan reads a 32-word quarter of row
// (p >> 8) >> 2); the query window is not staged in shared memory
// (kStaged false: look jumps across the whole query), so the pieces do not
// add up to a scan step. Reads whose values the tool's acc never uses (the
// rank at k2 + 100, the compare's query words before piece 4) are folded
// into a second checksum, `chk`, so that the compiler keeps them; the plain
// version computes it too.
//
// Integer semantics are JAX's: int32 state wraps, `%` is a floor modulo,
// a table read clamps its index to the table (the INIT row's neighbour of
// the last k-mer lies one past comb_pairs on a narrow index), and an int64
// difference or sum stored as int32 keeps its low 32 bits.
//
// What bounds them: the latency of dependent reads, as the scan. A lane's
// next look is known ahead (it depends on k alone), but each iteration's
// reads depend on the query word it reads first, and a lane's iterations
// run in order; B lanes are B warps (seedcost) or B threads (gather_sweep)
// in flight, not enough to cover the latency at the tool's B of 512.

#include <cstdint>

#include <cuda_runtime.h>

#include "seed_core.cuh"
#include "seed_dev.cuh"

// Must match ops/probe._SeedcostArgs field for field.
struct SeedcostArgs {
  SeedArgs s;              // the tables (q_rows, t3, t3_major, t3_exc_pos,
                           // t3_exc_chr, comb_pairs, init_corr, text_rows)
                           // and order; the lane fields are unused
  int32_t* acc;            // [B] out
  uint32_t* chk;           // [B] out: the checksum of the unused reads
  uint32_t* out_meta;      // [B, max_out] (piece 5, zeroed by the caller)
  int32_t* out_k0;         // [B, max_out]
  int8_t* out_fr;          // [B, max_out]
  int32_t* out_n;          // [B] out
  long long B, K, max_out;
  long long look_mod;      // n_qrow * 256 - 600
  long long k2_mod;        // seq_len - 300
  long long text_mod;      // n_trow * 256 - 600
  long long comb_len;      // comb_pairs' entries
};

// Must match ops/probe._SweepArgs field for field.
struct SweepArgs {
  const int32_t* ta;       // [n] (one table) or the first of two [n]
  const int32_t* tb;       // the second table, or null
  const int32_t* idx0;     // [B] start indices, in [0, n)
  int32_t* acc;            // [B] out
  int32_t* idx;            // [B] out: the last index
  long long B, K, n;
};

namespace {

constexpr int kSweepThreads = 256;
// the tool's comb_pairs offsets on either layout: the narrow index's first
// INIT-order row, and the pair of an INIT-8 row that far past it
constexpr i64 kInitOff = kCombTail + kClassRows;

// int64 to int32 keeping the low 32 bits (JAX's astype(int32), and int32
// arithmetic that wraps)
__device__ __forceinline__ int32_t low32(i64 v) {
  return static_cast<int32_t>(static_cast<u32>(static_cast<u64>(v)));
}

// x mod m with the sign of m (JAX's and Python's %), in int32 as the
// tools compute it: a 64-bit modulo is a long software routine on the card
// and would dwarf the floor piece
__device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t m) {
  const int32_t r = x % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

template <int kPiece, class Rows>
__global__ void __launch_bounds__(kScanWarps * 32)
seedcost_kernel(const __grid_constant__ SeedcostArgs p) {
  const SeedArgs& a = p.s;
  u64* shared64 = seeddev::dyn_smem64();
  const SharedTables tb = stage_tables<Rows>(a, shared64);
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const i64 b = static_cast<i64>(blockIdx.x) * kScanWarps + warp;
  if (b >= p.B) return;
  const WarpMem<false, Rows, WholeTable> m{a, tb.comb_tail, tb.corr,
                                           tb.exc_pos, tb.exc_chr, nullptr,
                                           0, t, false, 0};
  // the moduli fit int32 (the wrapper checks it), as in the tool
  const int32_t look_mod = static_cast<int32_t>(p.look_mod);
  const int32_t idx = floor_mod(low32(b * 9973), look_mod);
  u32 acc = 0, chk = 0;
  i64 out_n = 0;
  for (i64 k = 0; k < p.K; ++k) {
    const int32_t look = floor_mod(low32(idx + 7 * k), look_mod);
    if constexpr (kPiece == 0) {
      acc += static_cast<u32>(look);
    } else {
      const u32 w = m.qword(0, look, 0);
      const u32 amb = m.qword(1, look, 0);
      const Meta16 q = meta16(w, amb);
      // the tool's second copy of the query row: the compare's 16 words
      const u32 qw = m.qword(0, look, t & 15);
      if (t < 16) chk += qw;
      if constexpr (kPiece == 1) {
        acc += q.cls12 + q.b1ok;
      } else {
        const i64 cls_init = q.cls12 & ((1u << (2 * a.order)) - 1u);
        const i64 ia = q.b1ok ? kInitOff + cls_init : (q.cls12 & 0xFFFF);
        const i64 ib = q.b1ok ? ia + 1 : ia + kInitOff;
        const i64 va = a.comb_pairs[min(ia, p.comb_len - 1)];
        const i64 vb = a.comb_pairs[min(ib, p.comb_len - 1)];
        acc += static_cast<u32>(low32(vb - va));
        if constexpr (kPiece >= 3) {
          const i64 k2 = floor_mod(look, static_cast<int32_t>(p.k2_mod));
          i64 tk, tl;
          m.occ_pair(k2, k2 + 100, true, static_cast<int>(q.cls12 & 63), tk,
                     tl);
          if (t == 0) chk += static_cast<u32>(low32(tl));
          acc += static_cast<u32>(low32(tk));
          if constexpr (kPiece >= 4) {
            const i64 pt = floor_mod(low32(static_cast<i64>(look) * 3),
                                     static_cast<int32_t>(p.text_mod));
            const u32* trow = a.text_rows + (pt >> 8) * 128;
            const u32 tw = text_window(trow, static_cast<int>(pt & 255), t);
            const int run =
                first_mismatch(t < 16 ? mismatch_mask(tw, qw, 0u) : 0u);
            acc += static_cast<u32>(run);
            if constexpr (kPiece == 5) {
              if ((run & 7) == 0) {
                if (t == 0) {
                  const i64 o = b * p.max_out + min(out_n, p.max_out - 1);
                  p.out_meta[o] = q.cls12;
                  p.out_k0[o] = low32(va + tk);
                  p.out_fr[o] = static_cast<int8_t>(static_cast<uint8_t>(run));
                }
                ++out_n;
              }
            }
          }
        }
      }
    }
  }
  chk = __reduce_add_sync(kFull, chk);
  if (t == 0) {
    p.acc[b] = static_cast<int32_t>(acc);
    p.chk[b] = chk;
    p.out_n[b] = static_cast<int32_t>(out_n);
  }
}

template <bool kTwo>
__global__ void __launch_bounds__(kSweepThreads)
gather_sweep_kernel(const SweepArgs a) {
  const i64 i = static_cast<i64>(blockIdx.x) * kSweepThreads + threadIdx.x;
  if (i >= a.B) return;
  const int32_t n = static_cast<int32_t>(a.n);   // below 2^31 (checked)
  int32_t idx = a.idx0[i];
  u32 acc = 0;
  for (i64 k = 0; k < a.K; ++k) {
    int32_t v = a.ta[idx];
    if constexpr (kTwo) v = low32(static_cast<i64>(v) + a.tb[idx]);
    idx = floor_mod(low32(5 * static_cast<i64>(idx) + v), n);
    acc += static_cast<u32>(v);
  }
  a.acc[i] = static_cast<int32_t>(acc);
  a.idx[i] = idx;
}

typedef void (*SeedcostKernel)(const SeedcostArgs);

// The instance of a piece and a row layout; pieces 4 and 5 read text rows,
// which only a direct, so narrow, index has.
SeedcostKernel seedcost_instance(i64 piece, i64 wide) {
  if (wide) {
    switch (piece) {
      case 0: return seedcost_kernel<0, WideRows>;
      case 1: return seedcost_kernel<1, WideRows>;
      case 2: return seedcost_kernel<2, WideRows>;
      case 3: return seedcost_kernel<3, WideRows>;
      default: return nullptr;
    }
  }
  switch (piece) {
    case 0: return seedcost_kernel<0, NarrowRows>;
    case 1: return seedcost_kernel<1, NarrowRows>;
    case 2: return seedcost_kernel<2, NarrowRows>;
    case 3: return seedcost_kernel<3, NarrowRows>;
    case 4: return seedcost_kernel<4, NarrowRows>;
    case 5: return seedcost_kernel<5, NarrowRows>;
    default: return nullptr;
  }
}

size_t seedcost_shared(i64 wide) {
  return (wide ? Heads<WideRows>::kScanHead : Heads<NarrowRows>::kScanHead) *
         sizeof(u64);
}

int launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// C entry points. args points to a host struct of device pointers and
// scalars; stream is a cudaStream_t. Each returns a CUDA error code: of the
// launch (0 = launched), or of the call that prepared it.

extern "C" int gsalign_seedcost(const SeedcostArgs* args, i64 piece,
                                void* stream) {
  const SeedcostKernel kernel = seedcost_instance(piece, args->s.wide);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (args->B <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((args->B + kScanWarps - 1) /
                                           kScanWarps));
  cfg.blockDim = dim3(kScanWarps * 32);
  cfg.dynamicSmemBytes = seedcost_shared(args->s.wide);
  cfg.stream = static_cast<cudaStream_t>(stream);
  return launched(cudaLaunchKernelEx(&cfg, kernel, *args));
}

extern "C" int gsalign_gather_sweep(const SweepArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((args->B + kSweepThreads - 1) /
                                           kSweepThreads));
  cfg.blockDim = dim3(kSweepThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  return launched(args->tb != nullptr
                      ? cudaLaunchKernelEx(&cfg, gather_sweep_kernel<true>,
                                           *args)
                      : cudaLaunchKernelEx(&cfg, gather_sweep_kernel<false>,
                                           *args));
}

// Registers a thread and resident warps an SM of a seedcost instance.
extern "C" int gsalign_seedcost_occupancy(i64 piece, i64 wide, int* regs,
                                          int* warps) {
  const SeedcostKernel kernel = seedcost_instance(piece, wide);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return occupancy(kernel, kScanWarps * 32, seedcost_shared(wide), regs,
                   warps);
}

// The same of a gather_sweep instance (two: the two-table form).
extern "C" int gsalign_gather_sweep_occupancy(i64 two, int* regs,
                                              int* warps) {
  return two ? occupancy(gather_sweep_kernel<true>, kSweepThreads, 0, regs,
                         warps)
             : occupancy(gather_sweep_kernel<false>, kSweepThreads, 0, regs,
                         warps);
}
