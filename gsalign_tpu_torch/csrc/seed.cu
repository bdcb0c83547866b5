// The seed stage's device loops, hand-written for Hopper (sm_90a). Bound to
// Python through ops/seed_cuda.py (ctypes).
//
//   seed_scan   <- the whole of the JAX package's seed-scan while_loop
//                  (gsalign_tpu/ops/seeding.py, _seed_scan_impl, with
//                  rank.occ_t3, _meta16 and _extract256), an XLA loop on
//                  the TPU: every lane run to its end in ONE launch, a warp
//                  per lane. Serves the "xla" and "none" SA modes, where a
//                  lane's trajectory depends on its own state and the
//                  read-only tables alone.
//   seed_lockstep <- the same loop taken iteration by iteration: every
//                  lane takes one step an iteration, in lock step, and the
//                  loop itself runs on the card, a warp per lane and one
//                  grid barrier an iteration. "pallas" SA mode needs the
//                  lock step: its K compaction slots couple the lanes
//                  (_seed_scan_impl under sa_mode="pallas", with the Pallas
//                  kernel gather_pallas._kernel for the slots' reads). The
//                  slots are made here by a prefix sum over the lanes in lane
//                  order and each lane reads its own slot's SA word
//                  (gather_dev.cuh). With max_iters = 1 it is seed_step, one
//                  iteration of the loop's body; in the other modes it is
//                  the lane-by-lane diffing tool.
//   resolve_sa  <- gsalign_tpu/ops/rank.py resolve_sa (with lf_t3), the
//                  LF walk of sampled-SA indexes, an XLA while_loop on the
//                  TPU. One thread per rank, walking to its sampled row.
//
// Each is held against its plain torch version: seed_scan against
// ops/seeding.seed_scan_plain, seed_lockstep against the host loop
// ops/seeding.scan_lockstep (one seed_step_plain an iteration), resolve_sa
// against ops/rank.resolve_sa. seed_scan and seed_lockstep run the SAME step
// function (lane_step below) over the same memory policy, so they cannot
// drift apart. The word tables (q_rows, t3, t3_major, text_rows) are
// the port's int32 tensors, read here as the 32-bit words they hold.
//
// What bounds the scan on this card: neither bytes nor operations but the
// latency of dependent reads. A step is one query-window read, one
// comb_pairs read and two order-3 rank queries (256-byte rows) or one
// direct 256-base compare, and the next step's addresses come out of this
// step's results; a lane takes hundreds to thousands of steps and there
// are only hundreds to thousands of lanes. What seed_scan does about it:
//   - no host in the loop: one launch, the lanes loop on the card, and the
//     host reads the final state back once (the lock-step loop paid one
//     launch and one synchronising read-back per step);
//   - a warp per lane: lanes of different length never share a warp, a
//     finished warp leaves, and hundreds of lanes fill the SMs. A rank row
//     is one coalesced load (thread j takes minor word j and symbol word
//     j), counted by one popcount per thread and one warp reduction; the
//     16 checkpoint classes of a single-class rank go to 16 threads; the
//     two ranks of a step are issued together and share a row when they
//     fall into one; the 256-base compare is 16 words on 16 threads, a
//     ballot and a find-first-set;
//   - fewer dependent reads: the lane's query window (code and ambiguity
//     words of its chunk plus the compare's lookahead) is staged once into
//     shared memory, with the 136 class rows of comb_pairs, init_corr and
//     the t3 exceptions, so a step waits for its rank rows (and for
//     comb_pairs on an INIT jump) and for nothing else in device memory;
//   - the lane's state lives in registers, uniform across its warp, and
//     thread 0 writes the records.
// What seed_lockstep adds, where the lanes must stay in step:
//   - the host leaves the loop: the slot compaction, the gather and the
//     count of live lanes, which cost the host loop two launches, some
//     twenty tensor operations and a synchronising read-back an iteration,
//     are a few instructions around one grid barrier;
//   - slots in lane order without atomics: a block publishes how many of
//     its lanes need an SA word (and how many are live) to a buffer picked
//     by the iteration's parity; after the barrier every warp sums the
//     blocks before its own (one coalesced read, one warp reduction) and the
//     warps before it in its block. The order is the result: which lanes
//     stall, and so the iteration count, equal the host loop's;
//   - the grid is launched cooperatively, so all of it is resident. Where
//     the lanes outnumber the warps the card holds at once, a warp owns a
//     run of consecutive lanes and steps each once an iteration, with their
//     state in the state tensor and query words read from q_rows.
// An LF-walk step of resolve_sa is two dependent reads (a t3 row, then its
// major row), up to sa_intv - 1 steps on average.
//
// uint32 shifts by 32 are undefined in C++ (the torch version relies on
// int64 shifts clearing the word), so word extraction special-cases a zero
// bit offset and the rank mask skips bytes that keep nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "gather_dev.cuh"
#include "seed_dev.cuh"

typedef long long i64;
typedef unsigned int u32;
typedef unsigned long long u64;

// The argument structs of the C entry points (outside the anonymous
// namespace: the entry points that take them have external linkage).
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
  const i64* starts;       // [B]
  const i64* stops;        // [B]
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
};

// Must match ops/seed_cuda._ResolveArgs field for field.
struct ResolveArgs {
  const u32* t3;
  const int32_t* t3_major;
  const i64* t3_exc_pos;
  const i64* t3_exc_chr;
  const i64* l2;           // [5]
  const int32_t* sa;       // sa_samples (or sa_rows when sa_intv == 1)
  const i64* k;            // [n] ranks in
  i64* out;                // [n] SA values out
  i64 n, primary, seq_len, sa_intv;
};

namespace {

constexpr i64 kPhaseInit = 0, kPhaseExt = 1;
constexpr i64 kPoisonNone = 0x7FFFFFFF;
constexpr i64 kCombTail = 65536;        // first of the 136 class rows
constexpr i64 kInitOff = 65536 + 136;   // ops/rank.INIT_OFF
// SA modes, as ops/seeding.SA_MODES; "xla" (1) reads sa_rows directly
constexpr int kModeNone = 0, kModePallas = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kScanWarps = 4;           // lanes (warps) per seed_scan block
// warps per seed_lockstep block: the grid barrier costs more the more blocks
// arrive at it, so its blocks are large (one block an SM)
constexpr int kLockWarps = 16;
// the scans' shared 64-bit words before the query windows: the comb_pairs
// class rows, init_corr, t3_exc_pos, t3_exc_chr; seed_lockstep adds its
// warps' counts, one word a warp for each parity of the iteration
constexpr int kScanHead = 136 + 12 + 3 + 3;
constexpr int kLockHead = kScanHead + 2 * kLockWarps;
// rows of seed_lockstep's counters, as ops/seeding.C_*
enum { C_ITERS, C_LIVE, C_GATHERED, C_STALLED };

// rows of the lane-state tensor, as ops/seeding.F_*
enum {
  F_PHASE, F_CURSOR, F_EXT_START, F_EXT_POS, F_IK1, F_IK2, F_TRI_FAILED,
  F_DIR_SET, F_DIR_OFF, F_OUT_N, F_POISON, F_STEPS
};

// One lane's state, in registers.
struct Lane {
  i64 phase, cursor, ext_start, ext_pos, ik1, ik2, dir_off, out_n, poison,
      steps;
  bool tri_failed, dir_set;
};

__device__ __forceinline__ void load_lane(Lane& s, const i64* st, i64 B,
                                          i64 b) {
  s.phase = st[F_PHASE * B + b];
  s.cursor = st[F_CURSOR * B + b];
  s.ext_start = st[F_EXT_START * B + b];
  s.ext_pos = st[F_EXT_POS * B + b];
  s.ik1 = st[F_IK1 * B + b];
  s.ik2 = st[F_IK2 * B + b];
  s.tri_failed = st[F_TRI_FAILED * B + b] != 0;
  s.dir_set = st[F_DIR_SET * B + b] != 0;
  s.dir_off = st[F_DIR_OFF * B + b];
  s.out_n = st[F_OUT_N * B + b];
  s.poison = st[F_POISON * B + b];
  s.steps = st[F_STEPS * B + b];
}

__device__ __forceinline__ void store_lane(const Lane& s, i64* st, i64 B,
                                           i64 b) {
  st[F_PHASE * B + b] = s.phase;
  st[F_CURSOR * B + b] = s.cursor;
  st[F_EXT_START * B + b] = s.ext_start;
  st[F_EXT_POS * B + b] = s.ext_pos;
  st[F_IK1 * B + b] = s.ik1;
  st[F_IK2 * B + b] = s.ik2;
  st[F_TRI_FAILED * B + b] = s.tri_failed;
  st[F_DIR_SET * B + b] = s.dir_set;
  st[F_DIR_OFF * B + b] = s.dir_off;
  st[F_OUT_N * B + b] = s.out_n;
  st[F_POISON * B + b] = s.poison;
  st[F_STEPS * B + b] = s.steps;
}

// A lane is live in EXT phase, or in INIT phase before its stop.
__device__ __forceinline__ bool lane_live(const Lane& s, i64 stop) {
  return s.phase == kPhaseExt || s.cursor < stop;
}

// 32-bit word j of the 2-bit fields starting at field offset `off` of a
// run of packed words.
__device__ __forceinline__ u32 word_at(const u32* row, int off, int j) {
  const int ow = (off >> 4) + j;
  const int sh = (off & 15) << 1;
  const u32 a = row[ow];
  if (sh == 0) return a;
  return (a << sh) | (row[ow + 1] >> (32 - sh));
}

// u16 minor checkpoint of class j out of its packed word
__device__ __forceinline__ u32 minor_of(u32 word, int j) {
  return (word >> ((j & 1) * 16)) & 0xFFFF;
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

// Single-class STRICT rank over the order-3 table (ops/rank.occ_t3), by
// one thread: triple mode counts 8-bit symbols == cls (cls < 64) in
// T3[0, k); single mode counts rows whose preceding char is cls (cls < 4).
__device__ i64 occ_t3(const u32* t3, const int32_t* t3_major,
                      const i64* exc_pos, const i64* exc_chr, i64 k,
                      bool triple, int cls) {
  const u32* row = t3 + (k >> 7) * 64;
  const int32_t* mrow = t3_major + (k >> 15) * 64;
  i64 cp = 0;
  if (triple) {
    cp = mrow[cls] + minor_of(row[cls >> 1], cls);
  } else {
    for (int j = cls; j < 64; j += 4) cp += mrow[j] + minor_of(row[j >> 1], j);
  }
  const int m = static_cast<int>(k & 127);
  int cnt = 0;
  for (int j = 0; 4 * j < m; ++j)
    cnt += sym_count(row[32 + j], m - 4 * j, cls, triple);
  return cp + cnt + exc_corr(exc_pos, exc_chr, k, triple, cls);
}

// First mismatch of 16 compare words: given this word's mismatch mask
// (one bit per differing or ambiguous base, base 0 in the top field).
__device__ __forceinline__ u32 mismatch_mask(u32 tw, u32 qw, u32 aw) {
  const u32 x = tw ^ qw;
  return ((x | (x >> 1)) & 0x55555555u) | aw;
}

// ---- the scans' memory policy: a warp, the small tables in shared
// memory, rank rows and text rows by coalesced loads; the lane's query
// window in shared memory too (kStaged) or read from q_rows ----
template <bool kStaged>
struct WarpMem {
  const SeedArgs& a;
  const u64* comb_tail;    // shared: comb_pairs[kCombTail .. +136)
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
  __device__ __forceinline__ u64 comb(i64 row) const {
    if (row >= kCombTail && row < kInitOff) return comb_tail[row - kCombTail];
    return static_cast<u64>(a.comb_pairs[row]);
  }
  __device__ __forceinline__ int corr_n(i64 cls_init) const {
    int n = 0;
    for (int i = 0; i < 12; ++i) n += corr[i] == cls_init;
    return n;
  }
  // Both ranks of a step together: thread j holds minor word j and symbol
  // word j of each row; threads 0..15 (thread 0 in triple mode) add their
  // checkpoint classes; one warp sum per rank.
  __device__ __forceinline__ void occ_pair(i64 ka, i64 kb, bool triple,
                                           int cls, i64& tk, i64& tl) const {
    const i64 ra = ka >> 7, rb = kb >> 7;
    const u32* row_a = a.t3 + ra * 64;
    const u32 min_a = row_a[t], sym_a = row_a[32 + t];
    u32 min_b = min_a, sym_b = sym_a;
    if (rb != ra) {                       // uniform across the warp
      const u32* row_b = a.t3 + rb * 64;
      min_b = row_b[t];
      sym_b = row_b[32 + t];
    }
    const int j = triple ? cls : cls + 4 * (t & 15);   // my class, < 64
    const bool has_cp = triple ? t == 0 : t < 16;
    u32 maj_a = 0, maj_b = 0;
    if (has_cp) {
      maj_a = static_cast<u32>(a.t3_major[(ka >> 15) * 64 + j]);
      maj_b = static_cast<u32>(a.t3_major[(kb >> 15) * 64 + j]);
    }
    const u32 mw_a = __shfl_sync(kFull, min_a, j >> 1);
    const u32 mw_b = __shfl_sync(kFull, min_b, j >> 1);
    u32 part_a = sym_count(sym_a, static_cast<int>(ka & 127) - 4 * t, cls,
                           triple);
    u32 part_b = sym_count(sym_b, static_cast<int>(kb & 127) - 4 * t, cls,
                           triple);
    if (has_cp) {
      part_a += maj_a + minor_of(mw_a, j);
      part_b += maj_b + minor_of(mw_b, j);
    }
    // ranks of a narrow index stay below 2^31: the 32-bit sums are exact
    tk = static_cast<i64>(__reduce_add_sync(kFull, part_a)) +
         exc_corr(exc_pos, exc_chr, ka, triple, cls);
    tl = static_cast<i64>(__reduce_add_sync(kFull, part_b)) +
         exc_corr(exc_pos, exc_chr, kb, triple, cls);
  }
  // 16 compare words on 16 threads (the upper half-warp repeats them); 17
  // text words by one coalesced load, each thread's neighbour by a shuffle
  __device__ __forceinline__ int run256(const u32* trow, int toff,
                                        i64 look) const {
    const int tow = toff >> 4, tsh = (toff & 15) << 1;
    const u32 t0 = t < 17 ? trow[tow + t] : 0u;
    const u32 t1 = __shfl_down_sync(kFull, t0, 1);
    const u32 tw = tsh == 0 ? t0 : (t0 << tsh) | (t1 >> (32 - tsh));
    const int j = t & 15;
    const u32 mm = t < 16 ? mismatch_mask(tw, qword(0, look, j),
                                          qword(1, look, j))
                          : 0u;
    const unsigned hit = __ballot_sync(kFull, mm != 0);
    if (hit == 0) return 256;
    const int first = __ffs(hit) - 1;
    return 16 * first + (__clz(__shfl_sync(kFull, mm, first)) >> 1);
  }
};

// One step of a live lane b = [start, stop): the JAX scan body. Every
// thread that runs it for a lane (the whole warp) holds the same Lane and
// computes the same values; m.writer() names the thread that writes the
// record.
template <class Mem>
__device__ __forceinline__ void lane_step(Lane& s, const SeedArgs& a,
                                          const Mem& m, i64 b, i64 start,
                                          i64 stop) {
  const i64 phase = s.phase, cursor = s.cursor, ext_start = s.ext_start;
  const i64 ext_pos = s.ext_pos, ik1 = s.ik1, ik2 = s.ik2;
  const bool tri_failed = s.tri_failed, dir_set = s.dir_set;
  i64 dir_off = s.dir_off;
  const int order = static_cast<int>(a.order);
  const bool in_ext = phase == kPhaseExt;
  const bool in_init = !in_ext;               // live, so cursor < stop
  const bool in_dir = in_ext && a.mode != kModeNone && ik2 == 1;
  const bool iv_ext = in_ext && !in_dir;

  // ---- query metadata (_meta16): the 16 bases at `look` ----
  i64 look = in_ext ? ext_pos : cursor;
  look = look < 0 ? 0 : (look > a.n_look - 1 ? a.n_look - 1 : look);
  const u32 w = m.qword(0, look, 0);
  const u32 amb = m.qword(1, look, 0);
  u32 r = ~w;                                  // 3 - base, per 2-bit field
  r = ((r << 2) & 0xCCCCCCCCu) | ((r >> 2) & 0x33333333u);
  r = ((r << 4) & 0xF0F0F0F0u) | ((r >> 4) & 0x0F0F0F0Fu);
  r = ((r << 8) & 0xFF00FF00u) | ((r >> 8) & 0x00FF00FFu);
  r = (r << 16) | (r >> 16);
  const u32 cls12 = r & 0xFFFFFFu;
  const bool real8 = (amb & 0xFFFF0000u) == 0;
  const bool real3 = (amb & 0xFC000000u) == 0;
  const bool b1ok = (amb & 0xC0000000u) == 0;
  const i64 cls_init = cls12 & ((1u << (2 * order)) - 1u);
  const int cls8 = cls12 & 0xFFFF, cls3 = cls12 & 63, cls1 = cls12 & 3;
  const u32 init_mask = 0xFFFFFFFFu << (32 - 2 * order);   // order 10 or 12

  // ---- INIT class choice: INIT-order jump, else 8, 3, 1 ----
  const bool init_can12 = a.use_init && b1ok && (amb & init_mask) == 0 &&
                          cursor + (order - 1) < stop;
  const bool init_can8 = a.use8 && b1ok && real8 && cursor + 7 < stop &&
                         !init_can12;
  const bool init_can3 = b1ok && real3 && cursor + 2 < stop && !init_can8 &&
                         !init_can12;
  // ---- EXT class choice: triple when possible, else single ----
  const bool can3 = iv_ext && ext_pos + 2 < stop && real3 && !tri_failed;
  const int cls = can3 ? cls3 : cls1;

  const i64 i3 = kCombTail + cls3, i1 = kCombTail + 64 + (3 - cls1);
  const i64 row_idx =
      in_init ? (init_can12  ? kInitOff + cls_init
                 : init_can8 ? cls8
                 : init_can3 ? i3
                             : i1)
              : (can3 ? i3 : i1);
  const u64 v = m.comb(row_idx);
  const i64 sel_a = static_cast<i64>(v & 0xFFFFFFFFull);
  const i64 sel_b = static_cast<i64>(v >> 32);
  const i64 init_sz =
      init_can12 ? sel_b - sel_a - m.corr_n(cls_init) : sel_b;

  // ---- INIT step ----
  const bool init_dead =
      in_init && (init_can12 || init_can8 || init_can3) && init_sz == 0;
  const bool start_ext = in_init && b1ok && !init_dead;
  const int init_jump = init_can12 ? order : init_can8 ? 8 : init_can3 ? 3 : 1;

  // ---- interval EXT step ----
  i64 e_ik1 = 0, e_ik2 = 0;
  bool fin_iv = false, tri_miss = false, ext_ok = false;
  if (iv_ext) {
    i64 tk, tl;
    m.occ_pair(ik1, ik1 + ik2, can3, cls, tk, tl);
    e_ik1 = sel_a + tk;
    e_ik2 = tl - tk;
    const bool hit_boundary = ext_pos >= stop;
    const bool dead_end = e_ik2 == 0 && !can3;
    fin_iv = hit_boundary || !b1ok || dead_end;
    tri_miss = can3 && e_ik2 == 0;
    ext_ok = !fin_iv && !tri_miss;
  }

  // ---- DIRECT step: the unique occurrence's text against the query ----
  bool in_dir_eff = false, fin_dir = false, dir_adv = false;
  i64 dir_ext_pos = ext_pos;
  if (in_dir) {
    const bool need = !dir_set;               // resolving its SA word now
    bool enter = false;
    i64 rc_pos = 0;
    if (need) {
      if (a.mode == kModePallas) {
        enter = m.sa_ok;                      // past the K slots: stall
        rc_pos = m.sa_word;
      } else {
        enter = true;
        const i64 kc = ik1 < 0 ? 0 : (ik1 > a.seq_len ? a.seq_len : ik1);
        rc_pos = a.sa_rows[kc];
      }
    }
    if (enter) dir_off = a.seq_len - rc_pos - ext_pos;
    in_dir_eff = dir_set || enter;
    if (in_dir_eff) {
      const i64 p = dir_off + ext_pos;        // text pos of the next compare
      const i64 p_safe = p < 0 ? 0 : (p > a.seq_len - 1 ? a.seq_len - 1 : p);
      const i64 jrow = p_safe >> 8;
      const u32* trow = a.text_rows + (jrow >> 2) * 128 + (jrow & 3) * 32;
      const int run = m.run256(trow, static_cast<int>(p_safe & 255), look);
      const i64 lim_q = stop - ext_pos;
      const i64 lim_t = a.seq_len - p;
      const i64 limit = min(min(lim_q, lim_t), static_cast<i64>(256));
      const i64 adv = min(static_cast<i64>(run), max(limit, static_cast<i64>(0)));
      const bool reach = run >= limit;
      // boundary (checked first, like the interval path) > text-end dead
      // end > plain continue at a full 256-base window
      const bool bound_dir = reach && lim_q <= min(lim_t, static_cast<i64>(256));
      const bool tdead_dir = reach && !bound_dir && lim_t <= 256;
      const bool cont_dir = reach && !bound_dir && !tdead_dir;
      fin_dir = !reach || bound_dir || tdead_dir;
      dir_adv = cont_dir;
      dir_ext_pos = ext_pos + adv;
    }
  }

  // ---- finalize and emit ----
  const bool finalize = fin_iv || fin_dir;
  const i64 length = (in_dir ? dir_ext_pos : ext_pos) - ext_start;
  const i64 freq = ik2;
  const bool is_hit = finalize && length >= a.min_seed_length && freq > 0 &&
                      freq <= a.max_seed_freq;
  const i64 advance = is_hit ? ext_start + (a.sensitive ? 5 : length + 1)
                             : ext_start + 1;
  // a full emit buffer poisons the lane: it retires here and a later round
  // re-scans it from this start position
  const bool overflow = is_hit && s.out_n >= a.max_out;
  if (is_hit && !overflow) {
    if (m.writer()) {
      i64* rec = a.out + (b * a.max_out + s.out_n) * 3;
      rec[0] = (ext_start - start) | (length << 16);
      // direct hits know their occurrence: k0 < 0 encodes -(r_start + 1)
      rec[1] = in_dir ? -(dir_off + ext_start) - 1 : ik1;
      rec[2] = min(freq, a.max_seed_freq + 1);
    }
    s.out_n += 1;
  }

  // ---- state updates ----
  s.cursor = overflow ? stop
             : ((in_init && !b1ok) || init_dead) ? cursor + 1
             : finalize ? advance
                        : cursor;
  if (overflow && s.poison == kPoisonNone) s.poison = ext_start;
  s.ext_pos = start_ext ? cursor + init_jump
              : ext_ok  ? ext_pos + (can3 ? 3 : 1)
              : dir_adv ? dir_ext_pos
                        : ext_pos;
  const bool reset = start_ext || finalize;
  s.phase = start_ext ? kPhaseExt : finalize ? kPhaseInit : phase;
  s.ext_start = start_ext ? cursor : ext_start;
  s.ik1 = start_ext ? sel_a : ext_ok ? e_ik1 : ik1;
  s.ik2 = start_ext ? init_sz : ext_ok ? e_ik2 : ik2;
  s.tri_failed = !reset && (tri_miss || (!ext_ok && tri_failed));
  s.dir_set = !reset && (in_dir_eff || dir_set);
  s.dir_off = dir_off;
  s.steps += 1;
}

// The scans' block prologue: the small tables into the head of the block's
// shared memory. Ends in the block's barrier.
struct SharedTables {
  u64* comb_tail;
  i64 *corr, *exc_pos, *exc_chr;
};

__device__ __forceinline__ SharedTables stage_tables(const SeedArgs& a,
                                                     u64* shared64) {
  const SharedTables s{shared64, reinterpret_cast<i64*>(shared64 + 136),
                       reinterpret_cast<i64*>(shared64 + 136 + 12),
                       reinterpret_cast<i64*>(shared64 + 136 + 12 + 3)};
  for (int i = threadIdx.x; i < 136; i += blockDim.x)
    s.comb_tail[i] = static_cast<u64>(a.comb_pairs[kCombTail + i]);
  if (threadIdx.x < 12) s.corr[threadIdx.x] = a.init_corr[threadIdx.x];
  if (threadIdx.x < 3) {
    s.exc_pos[threadIdx.x] = a.t3_exc_pos[threadIdx.x];
    s.exc_chr[threadIdx.x] = a.t3_exc_chr[threadIdx.x];
  }
  __syncthreads();
  return s;
}

// Stage a lane's query window, by its warp: flat word W of a plane (bases
// 16W .. 16W + 15) is column W - 16 * row of q_rows row min(W >> 4, R - 1).
// Returns the query position of the window's first field.
__device__ __forceinline__ i64 stage_window(const SeedArgs& a, u32* win,
                                            i64 start, int t) {
  const i64 w0 = start >> 4, last_row = (a.n_look >> 8) - 1;
  for (i64 i = t; i < a.win_words; i += 32) {
    const i64 row = min((w0 + i) >> 4, last_row);
    const i64 col = w0 + i - 16 * row;
    const bool in = col < 32;           // past the last row's lookahead: 0
    win[i] = in ? a.q_rows[row * 64 + col] : 0u;
    win[a.win_words + i] = in ? a.q_rows[row * 64 + 32 + col] : 0u;
  }
  __syncwarp();
  return w0 << 4;
}

// Every lane to its end, a warp per lane. Dynamic shared memory:
// kScanHead 64-bit words, then per warp 2 * win_words 32-bit words. A lane
// that would take more than step_cap steps stops with F_STEPS = -1, which
// the wrapper turns into an exception.
__global__ void __launch_bounds__(kScanWarps * 32)
seed_scan_kernel(const SeedArgs a) {
  u64* shared64 = seeddev::dyn_smem64();
  // the only block-wide barrier: warps part after it
  const SharedTables tb = stage_tables(a, shared64);

  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const i64 b = static_cast<i64>(blockIdx.x) * kScanWarps + warp;
  if (b >= a.B) return;
  const i64 start = a.starts[b], stop = a.stops[b];
  u32* win = reinterpret_cast<u32*>(shared64 + kScanHead) +
             static_cast<i64>(warp) * 2 * a.win_words;
  const i64 base = stage_window(a, win, start, t);

  const WarpMem<true> m{a, tb.comb_tail, tb.corr, tb.exc_pos, tb.exc_chr,
                        win, base, t, false, 0};
  Lane s;
  load_lane(s, a.state, a.B, b);
  while (lane_live(s, stop)) {
    if (s.steps >= a.step_cap) {
      s.steps = -1;
      break;
    }
    lane_step(s, a, m, b, start, stop);
  }
  if (t == 0) store_lane(s, a.state, a.B, b);
}

// A lane that enters direct extension this iteration and has its SA word
// still to read (ops/seeding._sa_need).
__device__ __forceinline__ bool lane_needs_sa(const Lane& s) {
  return s.phase == kPhaseExt && s.ik2 == 1 && !s.dir_set;
}

// One lock-step iteration of one live lane: in pallas mode its compaction
// slot and its slot's read, then the step. `pos` counts the lanes that
// needed an SA word before this one, in lane order (cumsum(need) - 1 of the
// host loop); the first gather_k of an iteration get a slot, the others
// stall: their step moves nothing and is counted all the same.
template <bool kStaged>
__device__ __forceinline__ void lockstep_lane(Lane& s, const SeedArgs& a,
                                              WarpMem<kStaged>& m, i64 b,
                                              i64 start, i64 stop, i64& pos,
                                              i64& gathered, i64& stalled) {
  m.sa_ok = false;
  m.sa_word = 0;
  if (a.mode == kModePallas && lane_needs_sa(s)) {
    m.sa_ok = pos < a.gather_k;
    const i64 kc = s.ik1 < 0 ? 0 : (s.ik1 > a.seq_len ? a.seq_len : s.ik1);
    m.sa_word = gatherdev::masked_word(
        a.sa_rows, m.sa_ok ? static_cast<int32_t>(kc) : -1);
    gathered += m.sa_ok;
    stalled += !m.sa_ok;
    ++pos;
  }
  lane_step(s, a, m, b, start, stop);
}

// The whole lock-step scan: every lane one step an iteration until none is
// live, max_iters iterations have run (max_iters > 0) or step_cap
// iterations have (the wrapper raises if lanes are live then). Launched
// cooperatively with a.blocks blocks of kLockWarps warps; warp w of the
// grid owns lanes [w * lanes_per_warp, (w + 1) * lanes_per_warp), so blocks
// and warps hold the lanes in lane order. kStaged (lanes_per_warp == 1):
// the lane's state stays in registers and its query window in shared
// memory, as in seed_scan; otherwise each step loads and stores the state
// tensor and reads q_rows. Dynamic shared memory: kLockHead 64-bit words,
// then (kStaged) per warp 2 * win_words 32-bit words.
//
// An iteration: every warp has counted, at the end of its last step, how
// many of its lanes need an SA word next and how many are live; thread 0
// of the block publishes the block's sums to block_counts[parity]; one
// grid barrier; every warp reads all blocks' sums (the live total decides
// whether the loop goes on, the same for every block) and steps its lanes.
// Two parities suffice: a block writes parity p again only after the
// barrier in between, which no block passes before all have read.
template <bool kStaged>
__global__ void __launch_bounds__(kLockWarps * 32)
seed_lockstep_kernel(const SeedArgs a) {
  u64* shared64 = seeddev::dyn_smem64();
  const SharedTables tb = stage_tables(a, shared64);
  u64* warp_counts = shared64 + kScanHead;      // [2, kLockWarps]

  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int n_blocks = static_cast<int>(gridDim.x);
  const i64 w = static_cast<i64>(blockIdx.x) * kLockWarps + warp;
  const i64 lo = min(w * a.lanes_per_warp, a.B);
  const i64 hi = min(lo + a.lanes_per_warp, a.B);
  const bool pallas = a.mode == kModePallas;

  WarpMem<kStaged> m{a, tb.comb_tail, tb.corr, tb.exc_pos, tb.exc_chr,
                     nullptr, 0, t, false, 0};
  Lane s;                          // kStaged: this warp's one lane
  i64 start = 0, stop = 0;
  u32 need = 0, live = 0;          // this warp's lanes, for the next step
  if (kStaged) {
    if (lo < hi) {
      start = a.starts[lo];
      stop = a.stops[lo];
      u32* win = reinterpret_cast<u32*>(shared64 + kLockHead) +
                 static_cast<i64>(warp) * 2 * a.win_words;
      m.base = stage_window(a, win, start, t);
      m.win = win;
      load_lane(s, a.state, a.B, lo);
      live = lane_live(s, stop);
      need = pallas && lane_needs_sa(s);
    }
  } else {
    for (i64 b = lo; b < hi; ++b) {
      load_lane(s, a.state, a.B, b);
      live += lane_live(s, a.stops[b]);
      need += pallas && lane_needs_sa(s);
    }
  }

  const i64 limit = a.max_iters > 0 ? a.max_iters : a.step_cap;
  i64 it = 0, gathered = 0, stalled = 0;
  u32 live_all = 0;
  for (;;) {
    const int par = static_cast<int>(it & 1);
    if (t == 0)
      warp_counts[par * kLockWarps + warp] =
          need | (static_cast<u64>(live) << 32);
    __syncthreads();
    if (threadIdx.x == 0) {
      u64 sum = 0;                 // each half stays below 2^32: B lanes
      for (int i = 0; i < kLockWarps; ++i)
        sum += warp_counts[par * kLockWarps + i];
      __stcg(&a.block_counts[par * n_blocks + blockIdx.x], sum);
    }
    seeddev::grid_sync(a.block_counts + 2 * n_blocks,
                       static_cast<u64>(it + 1) * n_blocks);
    // lanes needing a word in the blocks before this one; live lanes in all
    u32 need_before = 0;
    live_all = 0;
    for (int i = t; i < n_blocks; i += 32) {
      const u64 v = __ldcg(&a.block_counts[par * n_blocks + i]);
      live_all += static_cast<u32>(v >> 32);
      if (i < static_cast<int>(blockIdx.x)) need_before += static_cast<u32>(v);
    }
    live_all = __reduce_add_sync(kFull, live_all);
    if (live_all == 0 || it >= limit) break;
    i64 pos = __reduce_add_sync(kFull, need_before);
    for (int i = 0; i < warp; ++i)
      pos += static_cast<u32>(warp_counts[par * kLockWarps + i]);

    if (kStaged) {
      if (live) {
        lockstep_lane(s, a, m, lo, start, stop, pos, gathered, stalled);
        live = lane_live(s, stop);
        need = pallas && lane_needs_sa(s);
      }
    } else {
      need = live = 0;
      for (i64 b = lo; b < hi; ++b) {
        load_lane(s, a.state, a.B, b);
        stop = a.stops[b];
        if (!lane_live(s, stop)) continue;      // a finished lane is inert
        lockstep_lane(s, a, m, b, a.starts[b], stop, pos, gathered, stalled);
        // the threads of a warp are not in step: every one has loaded this
        // lane's state before thread 0 overwrites it
        __syncwarp();
        if (t == 0) store_lane(s, a.state, a.B, b);
        live += lane_live(s, stop);
        need += pallas && lane_needs_sa(s);
      }
    }
    ++it;
  }

  if (kStaged && t == 0 && lo < hi) store_lane(s, a.state, a.B, lo);
  if (t == 0 && gathered) atomicAdd(&a.counters[C_GATHERED],
                                    static_cast<u64>(gathered));
  if (t == 0 && stalled) atomicAdd(&a.counters[C_STALLED],
                                   static_cast<u64>(stalled));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.counters[C_ITERS] = static_cast<u64>(it);
    a.counters[C_LIVE] = live_all;
  }
}

// LF mapping (ops/rank.lf_t3): the rank one text position to the left.
__device__ i64 lf_t3(const ResolveArgs& a, i64 k) {
  if (k == a.primary) return 0;
  const int inb = static_cast<int>(k & 127);
  const u32 w = a.t3[(k >> 7) * 64 + 32 + (inb >> 2)];
  int c = (w >> ((3 - (inb & 3)) * 8)) & 3;
  // rows with SA < 3 store sym 0: fix the char (the SA == 0 row, which has
  // none, is the primary, handled above)
  for (int i = 0; i < 3; ++i)
    if (k == a.t3_exc_pos[i]) c = static_cast<int>(a.t3_exc_chr[i]);
  return a.l2[c] + 1 +
         occ_t3(a.t3, a.t3_major, a.t3_exc_pos, a.t3_exc_chr, k, false, c);
}

__global__ void resolve_sa_kernel(const ResolveArgs a) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  i64 k = a.k[i];
  i64 steps = 0;
  const i64 mask = a.sa_intv - 1;
  while (k & mask) {
    k = lf_t3(a, k);
    ++steps;
  }
  const int log2_intv = __ffsll(a.sa_intv) - 1;
  a.out[i] = (steps + a.sa[k >> log2_intv]) % (a.seq_len + 1);
}

}  // namespace

// C entry points. args points to a host struct of device pointers and
// scalars; stream is a cudaStream_t. Each returns a CUDA error code: of the
// launch (0 = launched), or of the call that prepared it.

namespace {

cudaLaunchConfig_t launch_config(i64 blocks, int threads, size_t shared,
                                 void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cfg;
}

// The error code of a launch that returned e. Reading the last error also
// clears it, so that a refused launch does not show up after the next one.
int launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// A block may use more than 48 KB of dynamic shared memory only after the
// kernel has been allowed it.
template <class K>
cudaError_t allow_shared(K kernel, size_t shared) {
  if (shared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shared));
}

size_t scan_shared(int head, int warps, i64 win_words) {
  return head * sizeof(u64) +
         static_cast<size_t>(warps) * 2 * win_words * sizeof(u32);
}

template <class K>
cudaError_t resident_blocks(K kernel, size_t shared, int* blocks) {
  cudaError_t e = allow_shared(kernel, shared);
  if (e != cudaSuccess) return e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kLockWarps * 32, shared);
  *blocks = per_sm * n_sm;
  return e;
}

template <class K>
int launch_lockstep(K kernel, const SeedArgs* args, size_t shared,
                    void* stream) {
  cudaError_t e = allow_shared(kernel, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg =
      launch_config(args->blocks, kLockWarps * 32, shared, stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return launched(cudaLaunchKernelEx(&cfg, kernel, *args));
}

}  // namespace

extern "C" int gsalign_seed_scan(const SeedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const size_t shared = scan_shared(kScanHead, kScanWarps, args->win_words);
  cudaError_t e = allow_shared(seed_scan_kernel, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaLaunchConfig_t cfg =
      launch_config((args->B + kScanWarps - 1) / kScanWarps, kScanWarps * 32,
                    shared, stream);
  return launched(cudaLaunchKernelEx(&cfg, seed_scan_kernel, *args));
}

// The most blocks of seed_lockstep that the current device holds at once:
// with each warp's query window of win_words words a plane staged in shared
// memory, or (win_words < 0) with no window. 0 blocks: the window does not
// fit a block's shared memory.
extern "C" int gsalign_seed_lockstep_blocks(i64 win_words, int* blocks) {
  *blocks = 0;
  if (win_words < 0)
    return static_cast<int>(resident_blocks(seed_lockstep_kernel<false>,
                                            scan_shared(kLockHead, 0, 0),
                                            blocks));
  const size_t shared = scan_shared(kLockHead, kLockWarps, win_words);
  if (shared > 227 * 1024) return 0;
  return static_cast<int>(
      resident_blocks(seed_lockstep_kernel<true>, shared, blocks));
}

// args->blocks blocks, launched cooperatively: a grid that the device cannot
// hold at once is refused (an error code), never shrunk.
extern "C" int gsalign_seed_lockstep(const SeedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  if (args->blocks <= 0 || args->lanes_per_warp <= 0 ||
      args->blocks * kLockWarps * args->lanes_per_warp < args->B)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->lanes_per_warp == 1 && args->win_words > 0)
    return launch_lockstep(
        seed_lockstep_kernel<true>, args,
        scan_shared(kLockHead, kLockWarps, args->win_words), stream);
  return launch_lockstep(seed_lockstep_kernel<false>, args,
                         scan_shared(kLockHead, 0, 0), stream);
}

extern "C" int gsalign_resolve_sa(const ResolveArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int threads = 128;
  const cudaLaunchConfig_t cfg =
      launch_config((args->n + threads - 1) / threads, threads, 0, stream);
  return launched(cudaLaunchKernelEx(&cfg, resolve_sa_kernel, *args));
}
