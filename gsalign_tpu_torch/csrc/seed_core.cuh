// The seed kernels' shared device code, included by csrc/seed.cu (the
// scans, resolve_sa, occ_rows) and csrc/probe.cu (the seed-step cost
// probes): the argument struct of the scans, the t3 row layouts and their
// one row decode (RowGroup), and the scans' memory policy (WarpMem) with its
// query-word read, class-row read, rank pair and 256-base compare. What
// they are and why is in seed.cu's head comment. Defined once here, so a
// probe times the very code the scan runs.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned int u32;
typedef unsigned long long u64;

// The argument structs of the C entry points (outside the anonymous
// namespace: the entry points that take them have external linkage).

// A table's rows cut into equal blocks, one a mesh entry, the last
// zero-padded (ops/rank.RowShards): row r is row r % rows of block r / rows.
// rows == 0: the table is read whole from its own pointer. A table that is
// not cut in a sharded run is one block of all its rows. Must match
// ops/seed_cuda._Shards.
//
// The block addresses travel in the kernel's parameters, by value, so a
// row's block is one read of the constant bank (the same for a warp that
// reads one row) and no table of addresses is uploaded before a launch.
// kMaxShards bounds a mesh's entries: 1,024, more than the cards of any one
// host. It makes SeedArgs 8,480 bytes and ResolveArgs (two tables) 16,512,
// within the 32,764 bytes of kernel parameters that CUDA 12.1 and later
// allow (the kernels take them as __grid_constant__: read in place, never
// copied to a thread's stack).
constexpr int kMaxShards = 1024;
struct Shards {
  const void* block[kMaxShards];
  long long rows;          // rows a block
};

// Must match ops/seed_cuda._SeedArgs field for field.
struct SeedArgs {
  const u32* q_rows;       // [R, 64]: 32 packed code words | 32 ambiguity words
  const u32* t3;           // [n3, 64]: 32 u16-pair minor words | 32 sym words
  const int32_t* t3_major; // [ceil(n3/256), 64]
  const i64* t3_exc_pos;   // [3]
  const i64* t3_exc_chr;   // [3]
  const i64* comb_pairs;   // packed lo | sz << 32
  const i64* init_corr;    // [12], -1 padded
  const u32* text_rows;    // [n4, 128] (direct indexes)
  const int32_t* sa_rows;  // [pad1024(seq_len + 1)] (direct indexes)
  // [B] each: a lane scans starts from `starts` and records none from
  // `emit_stops` on; an extension is clipped at `ext_stops`, which lies
  // before the chunk's end `hard_stops` for a speculative segment's lane
  const i64* starts;
  const i64* emit_stops;
  const i64* ext_stops;
  const i64* hard_stops;
  i64* state;              // [12, B]
  i64* out;                // [B, max_out, 3]
  // seed_lockstep: [2, blocks] need | live << 32 of each block, by the
  // iteration's parity, then the grid barrier's word (zero at launch)
  u64* block_counts;
  u64* counters;           // [4] (seed_lockstep), as ops/seeding.C_*
  i64 B, max_out, min_seed_length, max_seed_freq, sensitive, order;
  i64 use_init, use8, seq_len, n_look, mode;
  i64 win_words, step_cap; // staged words per plane; step (iteration) limit
  // seed_lockstep: compaction slots; iterations to run (0: to the end);
  // grid blocks; consecutive lanes a warp (1: state in registers and the
  // query window staged in shared memory)
  i64 gather_k, max_iters, blocks, lanes_per_warp;
  // the row layout (0 narrow, 1 wide); in comb_pairs, the first INIT-order
  // row and (wide) the offset of the sz plane from the lo plane
  i64 wide, comb_init_off, comb_half;
  Shards t3_shards;        // t3 by blocks (rows > 0), else read from t3
};

namespace {

constexpr i64 kCombTail = 65536;        // first of the 136 class rows
constexpr int kClassRows = 136;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kScanWarps = 4;           // lanes (warps) per seed_scan block
// warps per seed_lockstep block: the grid barrier costs more the more blocks
// arrive at it, so its blocks are large (one block an SM)
constexpr int kLockWarps = 16;

// 32-bit word j of the 2-bit fields starting at field offset `off` of a
// run of packed words.
__device__ __forceinline__ u32 word_at(const u32* row, int off, int j) {
  const int ow = (off >> 4) + j;
  const int sh = (off & 15) << 1;
  const u32 a = row[ow];
  if (sh == 0) return a;
  return (a << sh) | (row[ow + 1] >> (32 - sh));
}

// Symbols of class `cls` among the first `keep` (0..4) bytes of a symbol
// word: whole 8-bit symbols in triple mode, their low two bits otherwise.
__device__ __forceinline__ int sym_count(u32 sym, int keep, int cls,
                                         bool triple) {
  if (keep <= 0) return 0;
  const u32 mask = keep >= 4 ? 0xFFFFFFFFu : (0xFFFFFFFFu << (32 - 8 * keep));
  const u32 x = sym ^ (static_cast<u32>(cls) * 0x01010101u);
  u32 eq;
  if (triple) {         // per-byte zero detect (symbols < 0x40)
    u32 s = x | (x >> 4);
    s |= s >> 2;
    s |= s >> 1;
    eq = ~s & 0x01010101u;
  } else {              // low two bits of each byte equal cls
    const u32 x2 = x & 0x03030303u;
    eq = ~(x2 | (x2 >> 1)) & 0x01010101u;
  }
  return __popc(eq & mask);
}

// The SA < 3 exception rows' correction to a strict rank at k: they store
// symbol 0, so class 0 loses them, and single mode adds their true chars.
__device__ __forceinline__ int exc_corr(const i64* exc_pos,
                                        const i64* exc_chr, i64 k,
                                        bool triple, int cls) {
  int nbelow = 0, chr_match = 0;
  for (int i = 0; i < 3; ++i) {
    const bool below = exc_pos[i] < k;
    nbelow += below;
    chr_match += below && exc_chr[i] == cls;
  }
  const int zero_cls = cls == 0;
  return triple ? -zero_cls * nbelow : -zero_cls * nbelow + chr_match;
}

// ---- the row decode ----
// A rank query's row is read by a group of G threads (8, 16 or 32) as
// regions of 32 words: thread t of the group takes V = 32 / G consecutive
// words of each region (one 128 / G-byte load, the group's together one
// coalesced 128-byte read), so every thread does the same kind of work at
// the same point and the group counts a region in V words a thread. The
// whole row is read even where the query's class is known (occ_pair): a
// load only of the words the query counts ran 0-10 % slower on an H100
// (PERF.md). kGroup is resolve_sa's G for the layout (occ_pair's is the
// warp).
// Narrow: the row's minor region (u16 checkpoints of classes 2w, 2w + 1 in
// word w), its symbol region, and the two regions of its major row
// (classes 32 i + w). Wide: the two regions of u32 low checkpoints
// (classes 32 i + w), the 4 carry words (bits 32-33 of class 16 w + f in
// field f of word w), the symbol region.
struct NarrowRows {
  static constexpr bool kWide = false;
  static constexpr int kWords = 64;       // u32 words a t3 row
  static constexpr int kSym = 32;         // first symbol word
  static constexpr int kCombRows = kClassRows;   // class rows staged
  static constexpr int kGroup = 16;
};
struct WideRows {
  static constexpr bool kWide = true;
  static constexpr int kWords = 100;
  static constexpr int kSym = 68;
  static constexpr int kCarry = 64;       // first carry word
  static constexpr int kCombRows = 2 * kClassRows;   // lo and sz planes
  static constexpr int kGroup = 32;
};

// The scans' shared 64-bit words before the query windows (kScanHead):
// the comb_pairs class rows (both planes on a wide index), init_corr,
// t3_exc_pos, t3_exc_chr; seed_lockstep adds its warps' counts, one word a
// warp for each parity of the iteration (kLockHead).
template <class Rows>
struct Heads {
  static constexpr int kScanHead = Rows::kCombRows + 12 + 3 + 3;
  static constexpr int kLockHead = kScanHead + 2 * kLockWarps;
};

// V consecutive words by one load (V = 1, 2 or 4; p aligned to 4 V bytes).
template <int V>
struct Words {
  u32 w[V];
  __device__ __forceinline__ void load(const u32* p) {
    if constexpr (V == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (V == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *p;
    }
  }
};

// Whether checkpoint class j counts for the query: the class itself in
// triple mode, every j with j & 3 == cls in single mode.
__device__ __forceinline__ bool wanted(int j, int cls, bool triple) {
  return triple ? j == cls : (j & 3) == cls;
}

// The sum of the 2-bit carries of the wanted classes in carry word w
// (classes 16 w .. 16 w + 15 in fields 0..15): the field at 2 (cls & 15)
// of word cls >> 4 (triple), or those at 2 cls + 8 i of every word (single).
__device__ __forceinline__ int carry_sum(u32 word, int w, int cls,
                                         bool triple) {
  u32 keep;
  if (triple) keep = (cls >> 4) == w ? 3u << (2 * (cls & 15)) : 0u;
  else keep = 0x03030303u << (2 * cls);
  const u32 x = word & keep;
  return __popc(x & 0x55555555u) + 2 * __popc(x & 0xAAAAAAAAu);
}

// Where row r of a table of `width`-element rows lies: at base + r * width
// (WholeTable), or in the block that owns it (ShardedTable). Row indices and
// offsets are int64: a wide t3 passes 2^31 rows' words.
struct WholeTable {
  template <class T>
  __device__ __forceinline__ static const T* row(const T* base,
                                                 const Shards&, i64 r,
                                                 i64 width) {
    return base + r * width;
  }
};
struct ShardedTable {
  template <class T>
  __device__ __forceinline__ static const T* row(const T*, const Shards& s,
                                                 i64 r, i64 width) {
    return static_cast<const T*>(s.block[r / s.rows]) + (r % s.rows) * width;
  }
};

template <class Rows, int G>
struct RowGroup {
  static constexpr int V = 32 / G;
  Words<V> cp[2];      // major (narrow) or low checkpoint (wide) regions
  Words<V> minor;      // narrow: the minor region; wide: the carry words
  Words<V> sym;        // the symbol region

  // Rank k's row (at `row`, which Table::row found), the words thread t of
  // the group holds: one round trip of independent loads.
  __device__ __forceinline__ void load(const u32* row, const int32_t* major,
                                       i64 k, int t) {
    const int o = t * V;
    if constexpr (Rows::kWide) {
      cp[0].load(row + o);
      cp[1].load(row + 32 + o);
      if (o < 4) minor.load(row + Rows::kCarry + o);
    } else {
      const u32* mrow = reinterpret_cast<const u32*>(major) + (k >> 15) * 64;
      cp[0].load(mrow + o);
      cp[1].load(mrow + 32 + o);
      minor.load(row + o);
    }
    sym.load(row + Rows::kSym + o);
  }

  // This thread's share of the strict rank of class cls at in-row offset
  // m = k & 127, without the exception correction: its checkpoint classes
  // and the symbols of its symbol words among the first m. Summed in 32
  // bits on a narrow index, whose ranks stay below 2^31; in 64 on a wide
  // one (a low word plus its carry shifted to bit 32).
  __device__ __forceinline__ i64 part(int t, int m, int cls,
                                      bool triple) const {
    using Acc = typename std::conditional<Rows::kWide, i64, u32>::type;
    const int o = t * V;
    Acc sum = 0;
#pragma unroll
    for (int e = 0; e < V; ++e) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (wanted(32 * i + o + e, cls, triple)) sum += cp[i].w[e];
      if constexpr (Rows::kWide) {
        if (o + e < 4)
          sum += static_cast<i64>(carry_sum(minor.w[e], o + e, cls, triple))
                 << 32;
      } else {
        const int j = 2 * (o + e);
        if (wanted(j, cls, triple)) sum += minor.w[e] & 0xFFFF;
        if (wanted(j + 1, cls, triple)) sum += minor.w[e] >> 16;
      }
      sum += sym_count(sym.w[e], m - 4 * (o + e), cls, triple);
    }
    return static_cast<i64>(sum);
  }

  // Symbol word w (0..31) of the row, from the thread that holds it.
  __device__ __forceinline__ u32 sym_word(unsigned mask, int lane0,
                                          int w) const {
    u32 mine = sym.w[0];
#pragma unroll
    for (int e = 1; e < V; ++e)
      if ((w & (V - 1)) == e) mine = sym.w[e];
    return __shfl_sync(mask, mine, lane0 + w / V);
  }
};

// The group's sum of its parts. A narrow rank stays below 2^31, so one
// 32-bit reduction is exact; a wide one passes 2^32 and is summed in 64
// bits, a shuffle tree over the group.
template <class Rows, int G>
__device__ __forceinline__ i64 group_sum(unsigned mask, i64 part) {
  if constexpr (!Rows::kWide) {
    return static_cast<i64>(
        __reduce_add_sync(mask, static_cast<u32>(part)));
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(mask, part, off);
    return part;
  }
}

// The mask of the G-thread group that holds lane `lane` of a warp.
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// First mismatch of 16 compare words: given this word's mismatch mask
// (one bit per differing or ambiguous base, base 0 in the top field).
__device__ __forceinline__ u32 mismatch_mask(u32 tw, u32 qw, u32 aw) {
  const u32 x = tw ^ qw;
  return ((x | (x >> 1)) & 0x55555555u) | aw;
}

// Thread t's compare word of 256 text bases at field offset toff (0..255)
// of the 32-word run at trow: 17 words by one coalesced load (threads
// 0..16), each thread's neighbour by a shuffle. Threads 0..15 hold words
// 0..15 of the compare.
__device__ __forceinline__ u32 text_window(const u32* trow, int toff, int t) {
  const int tow = toff >> 4, tsh = (toff & 15) << 1;
  const u32 t0 = t < 17 ? trow[tow + t] : 0u;
  const u32 t1 = __shfl_down_sync(kFull, t0, 1);
  return tsh == 0 ? t0 : (t0 << tsh) | (t1 >> (32 - tsh));
}

// The compare's run: the first mismatching base of the 16 words whose
// mismatch masks threads 0..15 hold (0 on threads 16..31), or 256; a
// ballot and a find-first-set over the warp.
__device__ __forceinline__ int first_mismatch(u32 mm) {
  const unsigned hit = __ballot_sync(kFull, mm != 0);
  if (hit == 0) return 256;
  const int first = __ffs(hit) - 1;
  return 16 * first + (__clz(__shfl_sync(kFull, mm, first)) >> 1);
}

// A query word's scan metadata (_meta16): the 16 bases of code word w from
// ambiguity word amb on. cls12 is the 12-mer class of its first 12 bases,
// (3 - base) in ascending 2-bit fields, so cls8 = cls12 & 0xFFFF, cls3 =
// cls12 & 63, cls1 = cls12 & 3; real8, real3 and b1ok: the first 8, 3 and
// 1 bases are unambiguous.
struct Meta16 {
  u32 cls12;
  bool real8, real3, b1ok;
};

__device__ __forceinline__ Meta16 meta16(u32 w, u32 amb) {
  u32 r = ~w;                                  // 3 - base, per 2-bit field
  r = ((r << 2) & 0xCCCCCCCCu) | ((r >> 2) & 0x33333333u);
  r = ((r << 4) & 0xF0F0F0F0u) | ((r >> 4) & 0x0F0F0F0Fu);
  r = ((r << 8) & 0xFF00FF00u) | ((r >> 8) & 0x00FF00FFu);
  r = (r << 16) | (r >> 16);
  return {r & 0xFFFFFFu, (amb & 0xFFFF0000u) == 0, (amb & 0xFC000000u) == 0,
          (amb & 0xC0000000u) == 0};
}

// ---- the scans' memory policy: a warp, the small tables in shared
// memory, rank rows and text rows by coalesced loads; the lane's query
// window in shared memory too (kStaged) or read from q_rows; the rank rows
// in the layout Rows, from the whole t3 or its blocks (Table) ----
template <bool kStaged, class Rows, class Table>
struct WarpMem {
  const SeedArgs& a;
  // shared: comb_pairs' 136 class rows (packed lo | sz << 32), or on a
  // wide index their lo plane then their sz plane
  const u64* comb_tail;
  const i64* corr;         // shared: init_corr[12]
  const i64* exc_pos;      // shared: t3_exc_pos[3]
  const i64* exc_chr;      // shared: t3_exc_chr[3]
  const u32* win;          // shared: [2, win_words] code | ambiguity words
  i64 base;                // query position of the window's first field
  int t;                   // this thread's index in the warp
  // pallas mode: whether the lane got a compaction slot this iteration,
  // and the SA word its slot read (seed_lockstep sets both before a step)
  bool sa_ok;
  i64 sa_word;

  __device__ __forceinline__ bool writer() const { return t == 0; }
  __device__ __forceinline__ u32 qword(int plane, i64 look, int j) const {
    if constexpr (kStaged)
      return word_at(win + plane * a.win_words, static_cast<int>(look - base),
                     j);
    else
      return word_at(a.q_rows + (look >> 8) * 64 + plane * 32,
                     static_cast<int>(look & 255), j);
  }
  // (lo, sz) of class row `row` (INIT-8 rows below kCombTail, then the
  // class rows), or with `init` of the INIT-order row of k-mer g (its sz
  // is starts[g + 1]). Wide: two reads, in the lo and the sz plane, or
  // starts[g] and starts[g + 1].
  __device__ __forceinline__ void comb(i64 row, bool init, i64 g, i64& lo,
                                       i64& sz) const {
    const bool tail = !init && row >= kCombTail;
    if constexpr (Rows::kWide) {
      if (tail) {
        lo = static_cast<i64>(comb_tail[row - kCombTail]);
        sz = static_cast<i64>(comb_tail[kClassRows + row - kCombTail]);
      } else {
        const i64 r = init ? a.comb_init_off + g : row;
        lo = a.comb_pairs[r];
        sz = a.comb_pairs[init ? r + 1 : r + a.comb_half];
      }
    } else {
      const u64 v = tail ? comb_tail[row - kCombTail]
                         : static_cast<u64>(
                               a.comb_pairs[init ? a.comb_init_off + g : row]);
      lo = static_cast<i64>(v & 0xFFFFFFFFull);
      sz = static_cast<i64>(v >> 32);
    }
  }
  __device__ __forceinline__ int corr_n(i64 cls_init) const {
    int n = 0;
    for (int i = 0; i < 12; ++i) n += corr[i] == cls_init;
    return n;
  }
  // Both ranks of a step together, by the row decode over the warp: one
  // row's words a thread (and a second row's where kb falls in another),
  // one group sum a rank.
  __device__ __forceinline__ void occ_pair(i64 ka, i64 kb, bool triple,
                                           int cls, i64& tk, i64& tl) const {
    RowGroup<Rows, 32> ra, rb;
    ra.load(Table::row(a.t3, a.t3_shards, ka >> 7, Rows::kWords), a.t3_major,
            ka, t);
    if ((kb >> 7) != (ka >> 7))                                      // uniform
      rb.load(Table::row(a.t3, a.t3_shards, kb >> 7, Rows::kWords),
              a.t3_major, kb, t);
    else
      rb = ra;
    tk = group_sum<Rows, 32>(
             kFull, ra.part(t, static_cast<int>(ka & 127), cls, triple)) +
         exc_corr(exc_pos, exc_chr, ka, triple, cls);
    tl = group_sum<Rows, 32>(
             kFull, rb.part(t, static_cast<int>(kb & 127), cls, triple)) +
         exc_corr(exc_pos, exc_chr, kb, triple, cls);
  }
  // 16 compare words on 16 threads (the upper half-warp repeats them), the
  // query's ambiguous bases counted as mismatches
  __device__ __forceinline__ int run256(const u32* trow, int toff,
                                        i64 look) const {
    const u32 tw = text_window(trow, toff, t);
    const int j = t & 15;
    const u32 mm = t < 16 ? mismatch_mask(tw, qword(0, look, j),
                                          qword(1, look, j))
                          : 0u;
    return first_mismatch(mm);
  }
};

// The scans' block prologue: the small tables into the head of the block's
// shared memory. Ends in the block's barrier.
struct SharedTables {
  u64* comb_tail;
  i64 *corr, *exc_pos, *exc_chr;
};

template <class Rows>
__device__ __forceinline__ SharedTables stage_tables(const SeedArgs& a,
                                                     u64* shared64) {
  constexpr int n = Rows::kCombRows;
  const SharedTables s{shared64, reinterpret_cast<i64*>(shared64 + n),
                       reinterpret_cast<i64*>(shared64 + n + 12),
                       reinterpret_cast<i64*>(shared64 + n + 12 + 3)};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // the wide sz plane's class rows follow its lo plane's
    const i64 plane = i < kClassRows ? 0 : a.comb_half - kClassRows;
    s.comb_tail[i] = static_cast<u64>(a.comb_pairs[kCombTail + plane + i]);
  }
  if (threadIdx.x < 12) s.corr[threadIdx.x] = a.init_corr[threadIdx.x];
  if (threadIdx.x < 3) {
    s.exc_pos[threadIdx.x] = a.t3_exc_pos[threadIdx.x];
    s.exc_chr[threadIdx.x] = a.t3_exc_chr[threadIdx.x];
  }
  __syncthreads();
  return s;
}

// What the compiler and the card make of a kernel launched with `threads`
// threads a block and `shared` bytes of dynamic shared memory: its
// registers a thread (cudaFuncGetAttributes) and the warps an SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA
// error code.
template <class K>
int occupancy(K kernel, int threads, size_t shared, int* regs, int* warps) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    shared);
  *regs = fa.numRegs;
  *warps = blocks * (threads / 32);
  return static_cast<int>(e);
}

}  // namespace
