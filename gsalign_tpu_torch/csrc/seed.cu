// The seed stage's device loops, hand-written for Hopper (sm_90a). Bound to
// Python through ops/seed_cuda.py (ctypes).
//
//   seed_scan   <- the whole of the JAX package's seed-scan while_loop
//                  (gsalign_tpu/ops/seeding.py, _seed_scan_impl, with
//                  rank.occ_t3, _meta16 and _extract256), an XLA loop on
//                  the TPU: every lane run to its end in ONE launch, a warp
//                  per lane. Serves the "xla" and "none" SA modes, where a
//                  lane's trajectory depends on its own state and the
//                  read-only tables alone. A lane has the JAX scan's three
//                  bounds (emit, ext, hard: Span), so a speculative
//                  segment's lane is poisoned where its extension is
//                  clipped at its artificial bound.
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
//                  TPU. A group of G threads a rank: 16 on narrow rows,
//                  32 on wide (the faster of 8, 16 and 32 on an H100 for
//                  each layout).
//   occ_rows    <- rank.occ_t3 over given ranks, the row decode alone: not
//                  on any path; the tests hold it against the plain occ_t3
//                  on rows whose checkpoints no small genome reaches.
//
// Each kernel but occ_rows reads its tables whole (WholeTable) or, on an
// index whose t3 and sa_samples rows are cut into blocks, one block a mesh
// entry (ops/rank.RowShards, parallel/mesh.shard_index_rows), through the
// blocks' addresses (ShardedTable) <- the JAX package's row-sharded mode
// (gsalign_tpu/ops/rank.py _t3_row_fetch and _plane_fetch inside
// seeding.py _rowshard_scan and _rowshard_resolve), where every device
// gathers the rows it owns, masked, and a psum over the mesh assembles
// them. A run-to-completion kernel has no collective a step: it reads row
// r from the block that owns it, row r % rows of block r / rows, which is
// that sum (the owner's row plus zeros). Each is a template instance of its
// own, so the whole-table instances are the code they were.
//
// Two t3 row layouts (ops/rank.py): narrow, 64 words plus a major row every
// 256 rows, and wide (seq_len >= 2^31), 100 words of u32 low checkpoints,
// 2-bit carries and symbols, no major rows. Both are a policy (NarrowRows,
// WideRows) of ONE row decode (RowGroup): a group of threads reads a rank's
// row region by region and each counts its words; the scans' occ_pair (a
// warp) and resolve_sa (a group of G) call it, so they cannot drift apart.
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
//     is read by the row decode below with the warp as its group (thread j
//     takes word j of each 32-word region: narrow, minor word j, symbol
//     word j and major words j and j + 32), counted by one popcount and a
//     few adds per thread and one warp sum; the two ranks of a step are
//     issued together and share a row when they fall into one; the
//     256-base compare is 16 words on 16 threads, a ballot and a
//     find-first-set;
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
// resolve_sa: a rank's walk is about sa_intv - 1 LF steps on average, with
// a tail, each a rank query whose row address comes out of the step
// before; it too is bound by the latency of dependent reads, not by bytes
// (a 256- or 400-byte row a step) nor operations. A thread a rank would
// take two dependent round trips a step (one read for the char, then the
// row word by word) and scatter its warp's reads over 32 rows. Here a
// group of G threads takes a rank: the group reads the row and, narrow,
// its major row in one round trip (both are addressed by k alone), the
// char comes out of the symbol word one thread holds (a shuffle), each
// thread counts its words and the group sums them. Groups of one warp walk
// to different depths, so every shuffle names the group's own mask: a
// finished group never holds a live one.
//
// The device code these kernels share with the cost probes (csrc/probe.cu)
// lives in seed_core.cuh: SeedArgs, the row layouts and their decode, the
// scans' memory policy (WarpMem), the query metadata and the compare.
//
// uint32 shifts by 32 are undefined in C++ (the torch version relies on
// int64 shifts clearing the word), so word extraction special-cases a zero
// bit offset and the rank mask skips bytes that keep nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "gather_dev.cuh"
#include "seed_core.cuh"
#include "seed_dev.cuh"

// The argument structs of the other C entry points (SeedArgs is in
// seed_core.cuh).

// Must match ops/seed_cuda._ResolveArgs field for field.
struct ResolveArgs {
  const u32* t3;
  const int32_t* t3_major;
  const i64* t3_exc_pos;
  const i64* t3_exc_chr;
  const i64* l2;           // [5]
  const int32_t* sa;       // narrow: sa_samples (or sa_rows, sa_intv == 1)
  const i64* sa64;         // wide: sa_samples
  const i64* k;            // [n] ranks in
  i64* out;                // [n] SA values out
  i64 n, primary, seq_len, sa_intv;
  i64 wide;                // row layout (0 narrow, 1 wide)
  Shards t3_shards;        // by blocks (t3_shards.rows > 0: both are), else
  Shards sa_shards;        // t3 and sa / sa64 are read whole
};

// Must match ops/seed_cuda._OccArgs field for field.
struct OccArgs {
  const u32* t3;
  const int32_t* t3_major;
  const i64* t3_exc_pos;
  const i64* t3_exc_chr;
  const i64* k;            // [n] ranks
  const i64* cls;          // [n] classes (< 64 triple, < 4 single)
  const i64* triple;       // [n] 1: triple mode
  i64* out;                // [n] strict ranks out
  i64 n, wide;
};

namespace {

constexpr i64 kPhaseInit = 0, kPhaseExt = 1;
constexpr i64 kPoisonNone = 0x7FFFFFFF;
// SA modes, as ops/seeding.SA_MODES; "xla" (1) reads sa_rows directly
constexpr int kModeNone = 0, kModePallas = 2;
constexpr int kResolveThreads = 256;    // threads a resolve_sa block
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

// A lane's bounds (ops/seeding.ScanLanes): the JAX scan's starts,
// emit_stops, ext_stops and hard_stops.
struct Span {
  i64 start, emit, ext, hard;
};

__device__ __forceinline__ Span lane_span(const SeedArgs& a, i64 b) {
  return {a.starts[b], a.emit_stops[b], a.ext_stops[b], a.hard_stops[b]};
}

// A lane is live in EXT phase, or in INIT phase before its emit bound.
__device__ __forceinline__ bool lane_live(const Lane& s, i64 emit) {
  return s.phase == kPhaseExt || s.cursor < emit;
}

// One step of a live lane b of bounds sp: the JAX scan body. The INIT
// jumps, the triples and both extensions stop at sp.ext; an extension
// clipped there before the chunk's end (sp.ext < sp.hard) poisons the lane
// from its start, as a full emit buffer does. Every thread that runs it
// for a lane (the whole warp) holds the same Lane and computes the same
// values; m.writer() names the thread that writes the record.
template <class Mem>
__device__ __forceinline__ void lane_step(Lane& s, const SeedArgs& a,
                                          const Mem& m, i64 b,
                                          const Span& sp) {
  const i64 phase = s.phase, cursor = s.cursor, ext_start = s.ext_start;
  const i64 ext_pos = s.ext_pos, ik1 = s.ik1, ik2 = s.ik2;
  const bool tri_failed = s.tri_failed, dir_set = s.dir_set;
  i64 dir_off = s.dir_off;
  const int order = static_cast<int>(a.order);
  const bool in_ext = phase == kPhaseExt;
  const bool in_init = !in_ext;               // live, so cursor < emit
  const bool in_dir = in_ext && a.mode != kModeNone && ik2 == 1;
  const bool iv_ext = in_ext && !in_dir;

  // ---- query metadata (_meta16): the 16 bases at `look` ----
  i64 look = in_ext ? ext_pos : cursor;
  look = look < 0 ? 0 : (look > a.n_look - 1 ? a.n_look - 1 : look);
  const u32 w = m.qword(0, look, 0);
  const u32 amb = m.qword(1, look, 0);
  const Meta16 q = meta16(w, amb);
  const u32 cls12 = q.cls12;
  const bool real8 = q.real8, real3 = q.real3, b1ok = q.b1ok;
  const i64 cls_init = cls12 & ((1u << (2 * order)) - 1u);
  const int cls8 = cls12 & 0xFFFF, cls3 = cls12 & 63, cls1 = cls12 & 3;
  const u32 init_mask = 0xFFFFFFFFu << (32 - 2 * order);   // order 10 or 12

  // ---- INIT class choice: INIT-order jump, else 8, 3, 1 ----
  const bool init_can12 = a.use_init && b1ok && (amb & init_mask) == 0 &&
                          cursor + (order - 1) < sp.ext;
  const bool init_can8 = a.use8 && b1ok && real8 && cursor + 7 < sp.ext &&
                         !init_can12;
  const bool init_can3 = b1ok && real3 && cursor + 2 < sp.ext &&
                         !init_can8 && !init_can12;
  // ---- EXT class choice: triple when possible, else single ----
  const bool can3 = iv_ext && ext_pos + 2 < sp.ext && real3 && !tri_failed;
  const int cls = can3 ? cls3 : cls1;

  const i64 i3 = kCombTail + cls3, i1 = kCombTail + 64 + (3 - cls1);
  const i64 row_idx = in_init ? (init_can8   ? cls8
                                 : init_can3 ? i3
                                             : i1)
                              : (can3 ? i3 : i1);
  i64 sel_a, sel_b;
  m.comb(row_idx, in_init && init_can12, cls_init, sel_a, sel_b);
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
  // the extension reached sp.ext (JAX hb_eff: the interval path's
  // hit_boundary, or in direct mode bound_dir)
  bool at_bound = false;
  if (iv_ext) {
    i64 tk, tl;
    m.occ_pair(ik1, ik1 + ik2, can3, cls, tk, tl);
    e_ik1 = sel_a + tk;
    e_ik2 = tl - tk;
    at_bound = ext_pos >= sp.ext;
    const bool dead_end = e_ik2 == 0 && !can3;
    fin_iv = at_bound || !b1ok || dead_end;
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
      const i64 lim_q = sp.ext - ext_pos;
      const i64 lim_t = a.seq_len - p;
      const i64 limit = min(min(lim_q, lim_t), static_cast<i64>(256));
      const i64 adv = min(static_cast<i64>(run), max(limit, static_cast<i64>(0)));
      const bool reach = run >= limit;
      // boundary (checked first, like the interval path) > text-end dead
      // end > plain continue at a full 256-base window
      at_bound = reach && lim_q <= min(lim_t, static_cast<i64>(256));
      const bool tdead_dir = reach && !at_bound && lim_t <= 256;
      const bool cont_dir = reach && !at_bound && !tdead_dir;
      fin_dir = !reach || at_bound || tdead_dir;
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
  // an extension clipped at an artificial bound (a speculative segment's,
  // not the chunk's end) poisons the lane, as a full emit buffer does: from
  // this start position on its results are unknowable or unrecorded, so it
  // retires here and the host re-scans from the poison position with the
  // real clip and a fresh buffer. A clipped hit is still recorded; the host
  // drops records from the poison position on.
  const bool overflow = is_hit && s.out_n >= a.max_out;
  const bool poisoned = (finalize && at_bound && sp.ext < sp.hard) || overflow;
  if (is_hit && !overflow) {
    if (m.writer()) {
      i64* rec = a.out + (b * a.max_out + s.out_n) * 3;
      rec[0] = (ext_start - sp.start) | (length << 16);
      // direct hits know their occurrence: k0 < 0 encodes -(r_start + 1)
      rec[1] = in_dir ? -(dir_off + ext_start) - 1 : ik1;
      rec[2] = min(freq, a.max_seed_freq + 1);
    }
    s.out_n += 1;
  }

  // ---- state updates ----
  s.cursor = poisoned ? sp.emit
             : ((in_init && !b1ok) || init_dead) ? cursor + 1
             : finalize ? advance
                        : cursor;
  if (poisoned && s.poison == kPoisonNone) s.poison = ext_start;
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
// Heads::kScanHead 64-bit words, then per warp 2 * win_words 32-bit words.
// A lane that would take more than step_cap steps stops with F_STEPS = -1,
// which the wrapper turns into an exception.
template <class Rows, class Table>
__global__ void __launch_bounds__(kScanWarps * 32)
seed_scan_kernel(const __grid_constant__ SeedArgs a) {
  u64* shared64 = seeddev::dyn_smem64();
  // the only block-wide barrier: warps part after it
  const SharedTables tb = stage_tables<Rows>(a, shared64);

  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const i64 b = static_cast<i64>(blockIdx.x) * kScanWarps + warp;
  if (b >= a.B) return;
  const Span sp = lane_span(a, b);
  u32* win = reinterpret_cast<u32*>(shared64 + Heads<Rows>::kScanHead) +
             static_cast<i64>(warp) * 2 * a.win_words;
  const i64 base = stage_window(a, win, sp.start, t);

  const WarpMem<true, Rows, Table> m{a, tb.comb_tail, tb.corr, tb.exc_pos,
                                     tb.exc_chr, win, base, t, false, 0};
  Lane s;
  load_lane(s, a.state, a.B, b);
  while (lane_live(s, sp.emit)) {
    if (s.steps >= a.step_cap) {
      s.steps = -1;
      break;
    }
    lane_step(s, a, m, b, sp);
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
template <class Mem>
__device__ __forceinline__ void lockstep_lane(Lane& s, const SeedArgs& a,
                                              Mem& m, i64 b, const Span& sp,
                                              i64& pos, i64& gathered,
                                              i64& stalled) {
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
  lane_step(s, a, m, b, sp);
}

// The whole lock-step scan: every lane one step an iteration until none is
// live, max_iters iterations have run (max_iters > 0) or step_cap
// iterations have (the wrapper raises if lanes are live then). Launched
// cooperatively with a.blocks blocks of kLockWarps warps; warp w of the
// grid owns lanes [w * lanes_per_warp, (w + 1) * lanes_per_warp), so blocks
// and warps hold the lanes in lane order. kStaged (lanes_per_warp == 1):
// the lane's state stays in registers and its query window in shared
// memory, as in seed_scan; otherwise each step loads and stores the state
// tensor and reads q_rows. Dynamic shared memory: Heads::kLockHead words,
// then (kStaged) per warp 2 * win_words 32-bit words.
//
// An iteration: every warp has counted, at the end of its last step, how
// many of its lanes need an SA word next and how many are live; thread 0
// of the block publishes the block's sums to block_counts[parity]; one
// grid barrier; every warp reads all blocks' sums (the live total decides
// whether the loop goes on, the same for every block) and steps its lanes.
// Two parities suffice: a block writes parity p again only after the
// barrier in between, which no block passes before all have read.
template <bool kStaged, class Rows, class Table>
__global__ void __launch_bounds__(kLockWarps * 32)
seed_lockstep_kernel(const __grid_constant__ SeedArgs a) {
  u64* shared64 = seeddev::dyn_smem64();
  const SharedTables tb = stage_tables<Rows>(a, shared64);
  u64* warp_counts = shared64 + Heads<Rows>::kScanHead;   // [2, kLockWarps]

  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int n_blocks = static_cast<int>(gridDim.x);
  const i64 w = static_cast<i64>(blockIdx.x) * kLockWarps + warp;
  const i64 lo = min(w * a.lanes_per_warp, a.B);
  const i64 hi = min(lo + a.lanes_per_warp, a.B);
  const bool pallas = a.mode == kModePallas;

  WarpMem<kStaged, Rows, Table> m{a, tb.comb_tail, tb.corr, tb.exc_pos,
                                  tb.exc_chr, nullptr, 0, t, false, 0};
  Lane s;                          // kStaged: this warp's one lane
  Span sp{};                       // kStaged: its bounds
  u32 need = 0, live = 0;          // this warp's lanes, for the next step
  if (kStaged) {
    if (lo < hi) {
      sp = lane_span(a, lo);
      u32* win = reinterpret_cast<u32*>(shared64 + Heads<Rows>::kLockHead) +
                 static_cast<i64>(warp) * 2 * a.win_words;
      m.base = stage_window(a, win, sp.start, t);
      m.win = win;
      load_lane(s, a.state, a.B, lo);
      live = lane_live(s, sp.emit);
      need = pallas && lane_needs_sa(s);
    }
  } else {
    for (i64 b = lo; b < hi; ++b) {
      load_lane(s, a.state, a.B, b);
      live += lane_live(s, a.emit_stops[b]);
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
        lockstep_lane(s, a, m, lo, sp, pos, gathered, stalled);
        live = lane_live(s, sp.emit);
        need = pallas && lane_needs_sa(s);
      }
    } else {
      need = live = 0;
      for (i64 b = lo; b < hi; ++b) {
        load_lane(s, a.state, a.B, b);
        const Span lane_sp = lane_span(a, b);
        if (!lane_live(s, lane_sp.emit)) continue;   // a finished lane is inert
        lockstep_lane(s, a, m, b, lane_sp, pos, gathered, stalled);
        // the threads of a warp are not in step: every one has loaded this
        // lane's state before thread 0 overwrites it
        __syncwarp();
        if (t == 0) store_lane(s, a.state, a.B, b);
        live += lane_live(s, lane_sp.emit);
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

// The SA values of ranks k: each rank's LF walk (ops/rank.lf_t3) to its
// sampled row by a group of Rows::kGroup threads, kResolveThreads threads a
// block; t3 and the samples whole or by blocks (Table).
// LF(k) = l2[c] + 1 + the strict single-mode rank of c at k, for c the char
// before row k's suffix; the SA == 0 row (the primary) maps to row 0. The
// SA < 3 rows store symbol 0: their char comes from t3_exc_chr, except the
// primary's (stored as 255), which is never used.
template <class Rows, class Table>
__global__ void __launch_bounds__(kResolveThreads)
resolve_sa_kernel(const __grid_constant__ ResolveArgs a) {
  constexpr int G = Rows::kGroup;
  const int lane = threadIdx.x & 31, t = lane & (G - 1);
  const unsigned mask = group_mask<G>(lane);
  const i64 i = (static_cast<i64>(blockIdx.x) * kResolveThreads +
                 threadIdx.x) / G;
  if (i >= a.n) return;                 // the whole group, together
  i64 exc_pos[3], exc_chr[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    exc_pos[e] = a.t3_exc_pos[e];
    exc_chr[e] = a.t3_exc_chr[e];
  }
  // l2 in four registers: an array indexed by c would live on the stack
  const i64 l2_0 = a.l2[0], l2_1 = a.l2[1], l2_2 = a.l2[2], l2_3 = a.l2[3];
  const i64 intv_mask = a.sa_intv - 1;
  i64 k = a.k[i], steps = 0;
  while (k & intv_mask) {
    RowGroup<Rows, G> row;
    row.load(Table::row(a.t3, a.t3_shards, k >> 7, Rows::kWords), a.t3_major,
             k, t);
    const int m = static_cast<int>(k & 127);
    int c = (row.sym_word(mask, lane & ~(G - 1), m >> 2) >>
             ((3 - (m & 3)) * 8)) & 3;
#pragma unroll
    for (int e = 0; e < 3; ++e)
      if (k == exc_pos[e] && k != a.primary) c = static_cast<int>(exc_chr[e]);
    const i64 rank = group_sum<Rows, G>(mask, row.part(t, m, c, false)) +
                     exc_corr(exc_pos, exc_chr, k, false, c);
    const i64 l2c = c == 0 ? l2_0 : c == 1 ? l2_1 : c == 2 ? l2_2 : l2_3;
    k = k == a.primary ? 0 : l2c + 1 + rank;
    ++steps;
  }
  if (t == 0) {
    const i64 s = k >> (__ffsll(a.sa_intv) - 1);
    const i64 base = Rows::kWide ? *Table::row(a.sa64, a.sa_shards, s, 1)
                                 : *Table::row(a.sa, a.sa_shards, s, 1);
    a.out[i] = (steps + base) % (a.seq_len + 1);
  }
}

// Strict ranks of given (k, cls, triple) by the row decode, a group of
// Rows::kGroup threads a query (the tests' window on RowGroup).
template <class Rows>
__global__ void __launch_bounds__(kResolveThreads)
occ_rows_kernel(const OccArgs a) {
  constexpr int G = Rows::kGroup;
  const int lane = threadIdx.x & 31, t = lane & (G - 1);
  const i64 i = (static_cast<i64>(blockIdx.x) * kResolveThreads +
                 threadIdx.x) / G;
  if (i >= a.n) return;
  const i64 k = a.k[i];
  const int cls = static_cast<int>(a.cls[i]);
  const bool triple = a.triple[i] != 0;
  const int m = static_cast<int>(k & 127);
  RowGroup<Rows, G> row;
  row.load(a.t3 + (k >> 7) * Rows::kWords, a.t3_major, k, t);
  const i64 rank =
      group_sum<Rows, G>(group_mask<G>(lane), row.part(t, m, cls, triple));
  if (t == 0)
    a.out[i] = rank + exc_corr(a.t3_exc_pos, a.t3_exc_chr, k, triple, cls);
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

// The kernel instances for a row layout and a table source (sharded: t3
// by blocks). seed_lockstep has sharded instances for narrow rows only: the
// lock step is pallas mode's, which needs a direct, so narrow, index.
typedef void (*SeedKernel)(const SeedArgs);

SeedKernel scan_kernel(i64 wide, bool sharded) {
  if (sharded)
    return wide ? seed_scan_kernel<WideRows, ShardedTable>
                : seed_scan_kernel<NarrowRows, ShardedTable>;
  return wide ? seed_scan_kernel<WideRows, WholeTable>
              : seed_scan_kernel<NarrowRows, WholeTable>;
}

SeedKernel lockstep_kernel(bool staged, i64 wide, bool sharded) {
  if (sharded) {
    if (wide) return nullptr;
    return staged ? seed_lockstep_kernel<true, NarrowRows, ShardedTable>
                  : seed_lockstep_kernel<false, NarrowRows, ShardedTable>;
  }
  if (staged)
    return wide ? seed_lockstep_kernel<true, WideRows, WholeTable>
                : seed_lockstep_kernel<true, NarrowRows, WholeTable>;
  return wide ? seed_lockstep_kernel<false, WideRows, WholeTable>
              : seed_lockstep_kernel<false, NarrowRows, WholeTable>;
}

// A launch of n queries, Rows::kGroup threads a query.
template <class Rows, class Args>
int launch_groups(void (*kernel)(const Args), const Args* args, void* stream) {
  const cudaLaunchConfig_t cfg = launch_config(
      (args->n * Rows::kGroup + kResolveThreads - 1) / kResolveThreads,
      kResolveThreads, 0, stream);
  return launched(cudaLaunchKernelEx(&cfg, kernel, *args));
}

int scan_head_words(i64 wide) {
  return wide ? Heads<WideRows>::kScanHead : Heads<NarrowRows>::kScanHead;
}
int lock_head_words(i64 wide) {
  return wide ? Heads<WideRows>::kLockHead : Heads<NarrowRows>::kLockHead;
}

}  // namespace

extern "C" int gsalign_seed_scan(const SeedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const size_t shared = scan_shared(scan_head_words(args->wide), kScanWarps,
                                    args->win_words);
  const SeedKernel kernel = scan_kernel(args->wide, args->t3_shards.rows > 0);
  cudaError_t e = allow_shared(kernel, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaLaunchConfig_t cfg =
      launch_config((args->B + kScanWarps - 1) / kScanWarps, kScanWarps * 32,
                    shared, stream);
  return launched(cudaLaunchKernelEx(&cfg, kernel, *args));
}

// seed_scan's registers a thread and the warps an SM holds at once, for
// the row layout `wide` and query windows of win_words words a plane (the
// whole-table instance).
extern "C" int gsalign_seed_scan_occupancy(i64 wide, i64 win_words, int* regs,
                                           int* warps) {
  const size_t shared =
      scan_shared(scan_head_words(wide), kScanWarps, win_words);
  const SeedKernel kernel = scan_kernel(wide, false);
  const cudaError_t e = allow_shared(kernel, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  return occupancy(kernel, kScanWarps * 32, shared, regs, warps);
}

// The most blocks of seed_lockstep that the current device holds at once,
// for the row layout `wide` and the table source `sharded`: with each
// warp's query window of win_words words a plane staged in shared memory,
// or (win_words < 0) with no window. 0 blocks: the window does not fit a
// block's shared memory.
extern "C" int gsalign_seed_lockstep_blocks(i64 win_words, i64 wide,
                                            i64 sharded, int* blocks) {
  *blocks = 0;
  const SeedKernel kernel = lockstep_kernel(win_words >= 0, wide, sharded);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (win_words < 0)
    return static_cast<int>(resident_blocks(
        kernel, scan_shared(lock_head_words(wide), 0, 0), blocks));
  const size_t shared =
      scan_shared(lock_head_words(wide), kLockWarps, win_words);
  if (shared > 227 * 1024) return 0;
  return static_cast<int>(resident_blocks(kernel, shared, blocks));
}

// args->blocks blocks, launched cooperatively: a grid that the device cannot
// hold at once is refused (an error code), never shrunk.
extern "C" int gsalign_seed_lockstep(const SeedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  if (args->blocks <= 0 || args->lanes_per_warp <= 0 ||
      args->blocks * kLockWarps * args->lanes_per_warp < args->B)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head = lock_head_words(args->wide);
  const bool staged = args->lanes_per_warp == 1 && args->win_words > 0;
  const SeedKernel kernel =
      lockstep_kernel(staged, args->wide, args->t3_shards.rows > 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_lockstep(
      kernel, args,
      staged ? scan_shared(head, kLockWarps, args->win_words)
             : scan_shared(head, 0, 0),
      stream);
}

extern "C" int gsalign_resolve_sa(const ResolveArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const bool sharded = args->t3_shards.rows > 0;
  if (args->wide)
    return launch_groups<WideRows>(
        sharded ? resolve_sa_kernel<WideRows, ShardedTable>
                : resolve_sa_kernel<WideRows, WholeTable>,
        args, stream);
  return launch_groups<NarrowRows>(
      sharded ? resolve_sa_kernel<NarrowRows, ShardedTable>
              : resolve_sa_kernel<NarrowRows, WholeTable>,
      args, stream);
}

extern "C" int gsalign_occ_rows(const OccArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  return args->wide ? launch_groups<WideRows>(occ_rows_kernel<WideRows>,
                                              args, stream)
                    : launch_groups<NarrowRows>(occ_rows_kernel<NarrowRows>,
                                                args, stream);
}

// Let the current device's kernels read device `peer`'s memory (the blocks
// of a row-sharded table on another card). Enabling it twice is no error.
extern "C" int gsalign_enable_peer(int peer) {
  const cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(e);
}
