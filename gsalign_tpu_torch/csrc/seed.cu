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
//   seed_step   <- one iteration of that loop's body over all lanes, one
//                  thread per lane, driven by a host loop. "pallas" SA mode
//                  needs it (its K slots couple the lanes); in the other
//                  modes it is the lane-by-lane diffing tool.
//   resolve_sa  <- gsalign_tpu/ops/rank.py resolve_sa (with lf_t3), the
//                  LF walk of sampled-SA indexes, an XLA while_loop on the
//                  TPU. One thread per rank, walking to its sampled row.
//
// Each is held against its plain torch version: seed_scan against
// ops/seeding.seed_scan_plain, seed_step against ops/seeding.seed_step_plain,
// resolve_sa against ops/rank.resolve_sa. seed_scan and seed_step run the
// SAME step function (lane_step below) over two memory policies, so they
// cannot drift apart. The word tables (q_rows, t3, t3_major, text_rows) are
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
// An LF-walk step of resolve_sa is two dependent reads (a t3 row, then its
// major row), up to sa_intv - 1 steps on average.
//
// uint32 shifts by 32 are undefined in C++ (the torch version relies on
// int64 shifts clearing the word), so word extraction special-cases a zero
// bit offset and the rank mask skips bytes that keep nothing.

#include <cstdint>

#include <cuda_runtime.h>

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
  const i64* slot;         // [B] (seed_step, pallas mode)
  const int32_t* res_k;    // [K] (seed_step, pallas mode)
  int32_t* live;           // [2] (seed_step)
  i64 B, max_out, min_seed_length, max_seed_freq, sensitive, order;
  i64 use_init, use8, seq_len, n_look, mode;
  i64 it;                  // seed_step: the iteration, for the live counter
  i64 win_words, step_cap; // seed_scan: staged words per plane; step limit
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
// seed_scan's shared 64-bit words before the query windows: the comb_pairs
// class rows, init_corr, t3_exc_pos, t3_exc_chr
constexpr int kScanHead = 136 + 12 + 3 + 3;

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

// ---- memory policy of seed_step: one thread, everything from device
// memory ----
struct ThreadMem {
  const SeedArgs& a;
  __device__ __forceinline__ bool writer() const { return true; }
  __device__ __forceinline__ u32 qword(int plane, i64 look, int j) const {
    return word_at(a.q_rows + (look >> 8) * 64 + plane * 32,
                   static_cast<int>(look & 255), j);
  }
  __device__ __forceinline__ u64 comb(i64 row) const {
    return static_cast<u64>(a.comb_pairs[row]);
  }
  __device__ __forceinline__ int corr_n(i64 cls_init) const {
    int n = 0;
    for (int i = 0; i < 12; ++i) n += a.init_corr[i] == cls_init;
    return n;
  }
  __device__ __forceinline__ void occ_pair(i64 ka, i64 kb, bool triple,
                                           int cls, i64& tk, i64& tl) const {
    tk = occ_t3(a.t3, a.t3_major, a.t3_exc_pos, a.t3_exc_chr, ka, triple, cls);
    tl = occ_t3(a.t3, a.t3_major, a.t3_exc_pos, a.t3_exc_chr, kb, triple, cls);
  }
  // first mismatch of the 256 text bases at field toff of trow against the
  // query at `look`; 256 if none
  __device__ __forceinline__ int run256(const u32* trow, int toff,
                                        i64 look) const {
    for (int j = 0; j < 16; ++j) {
      const u32 mm = mismatch_mask(word_at(trow, toff, j), qword(0, look, j),
                                   qword(1, look, j));
      if (mm != 0) return 16 * j + (__clz(mm) >> 1);
    }
    return 256;
  }
};

// ---- memory policy of seed_scan: a warp, the query window and the small
// tables in shared memory, rank rows and text rows by coalesced loads ----
struct WarpMem {
  const SeedArgs& a;
  const u64* comb_tail;    // shared: comb_pairs[kCombTail .. +136)
  const i64* corr;         // shared: init_corr[12]
  const i64* exc_pos;      // shared: t3_exc_pos[3]
  const i64* exc_chr;      // shared: t3_exc_chr[3]
  const u32* win;          // shared: [2, win_words] code | ambiguity words
  i64 base;                // query position of the window's first field
  int t;                   // this thread's index in the warp

  __device__ __forceinline__ bool writer() const { return t == 0; }
  __device__ __forceinline__ u32 qword(int plane, i64 look, int j) const {
    return word_at(win + plane * a.win_words, static_cast<int>(look - base),
                   j);
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
// thread that runs it for a lane holds the same Lane and computes the same
// values (in seed_scan the whole warp; m.writer() names the thread that
// writes the record).
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
        const i64 sl = a.slot[b];             // -1: past the K slots, stall
        enter = sl >= 0;
        if (enter) rc_pos = a.res_k[sl];
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

__global__ void seed_step_kernel(const SeedArgs a) {
  const i64 b = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  // this launch counts into live[it & 1]; it clears the other counter for
  // the next launch (the host has already read it)
  if (b == 0) a.live[(a.it + 1) & 1] = 0;
  if (b >= a.B) return;
  Lane s;
  load_lane(s, a.state, a.B, b);
  const i64 stop = a.stops[b];
  if (!lane_live(s, stop)) return;            // a finished lane is inert
  lane_step(s, a, ThreadMem{a}, b, a.starts[b], stop);
  store_lane(s, a.state, a.B, b);
  if (lane_live(s, stop)) atomicAdd(&a.live[a.it & 1], 1);
}

// Every lane to its end, a warp per lane. Dynamic shared memory:
// kScanHead 64-bit words, then per warp 2 * win_words 32-bit words. A lane
// that would take more than step_cap steps stops with F_STEPS = -1, which
// the wrapper turns into an exception.
__global__ void __launch_bounds__(kScanWarps * 32)
seed_scan_kernel(const SeedArgs a) {
  extern __shared__ u64 shared64[];
  u64* comb_tail = shared64;
  i64* corr = reinterpret_cast<i64*>(shared64 + 136);
  i64* exc_pos = corr + 12;
  i64* exc_chr = exc_pos + 3;
  for (int i = threadIdx.x; i < 136; i += blockDim.x)
    comb_tail[i] = static_cast<u64>(a.comb_pairs[kCombTail + i]);
  if (threadIdx.x < 12) corr[threadIdx.x] = a.init_corr[threadIdx.x];
  if (threadIdx.x < 3) {
    exc_pos[threadIdx.x] = a.t3_exc_pos[threadIdx.x];
    exc_chr[threadIdx.x] = a.t3_exc_chr[threadIdx.x];
  }
  __syncthreads();          // the only block-wide barrier: warps part here

  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const i64 b = static_cast<i64>(blockIdx.x) * kScanWarps + warp;
  if (b >= a.B) return;
  const i64 start = a.starts[b], stop = a.stops[b];

  // stage the lane's query window: flat word W of a plane (bases 16W ..
  // 16W + 15) is column W - 16 * row of q_rows row min(W >> 4, R - 1)
  u32* win = reinterpret_cast<u32*>(shared64 + kScanHead) +
             static_cast<i64>(warp) * 2 * a.win_words;
  const i64 w0 = start >> 4, last_row = (a.n_look >> 8) - 1;
  for (i64 i = t; i < a.win_words; i += 32) {
    const i64 row = min((w0 + i) >> 4, last_row);
    const i64 col = w0 + i - 16 * row;
    const bool in = col < 32;           // past the last row's lookahead: 0
    win[i] = in ? a.q_rows[row * 64 + col] : 0u;
    win[a.win_words + i] = in ? a.q_rows[row * 64 + 32 + col] : 0u;
  }
  __syncwarp();

  const WarpMem m{a, comb_tail, corr, exc_pos, exc_chr, win, w0 << 4, t};
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
// scalars; stream is a cudaStream_t. Each returns cudaGetLastError() after
// the launch (0 = launched).

extern "C" int gsalign_seed_scan(const SeedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const size_t shared = kScanHead * sizeof(u64) +
                        static_cast<size_t>(kScanWarps) * 2 * args->win_words *
                            sizeof(u32);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        seed_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks =
      static_cast<int>((args->B + kScanWarps - 1) / kScanWarps);
  seed_scan_kernel<<<blocks, kScanWarps * 32, shared,
                     static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsalign_seed_step(const SeedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const int threads = 128;
  const int blocks = static_cast<int>((args->B + threads - 1) / threads);
  seed_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsalign_resolve_sa(const ResolveArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int threads = 128;
  const int blocks = static_cast<int>((args->n + threads - 1) / threads);
  resolve_sa_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}
