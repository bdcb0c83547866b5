// The seed stage's two device loops, hand-written for Hopper (sm_90a). Bound
// to Python through ops/seed_cuda.py (ctypes).
//
//   seed_step   <- one iteration of the JAX package's seed-scan while_loop
//                  body (gsalign_tpu/ops/seeding.py, _seed_scan_impl.body,
//                  with rank.occ_t3, _meta16 and _extract256), an XLA loop
//                  on the TPU. One thread per lane.
//   resolve_sa  <- gsalign_tpu/ops/rank.py resolve_sa (with lf_t3), the
//                  LF walk of sampled-SA indexes, an XLA while_loop on the
//                  TPU. One thread per rank, walking to its sampled row.
//
// Both are held against their plain torch versions: seed_step against
// ops/seeding.seed_step_plain, resolve_sa against ops/rank.resolve_sa. The
// tables are the port's DeviceFMIndex tensors as they are: 32-bit packed
// words held in int64, so every word is read as an int64 and truncated to
// uint32 before any bit arithmetic.
//
// What bounds them on this card: neither bytes nor operations. A lane does
// one query-window read, one comb_pairs read and two order-3 rank queries
// (256-byte rows) or one direct 256-base compare per iteration: a chain of
// about six dependent random reads of device memory, on a few hundred to a
// few thousand lanes. So the step is latency-bound and a few microseconds
// long, and the scan's wall is the host loop around it (one launch and one
// 4-byte read-back per iteration). An LF-walk step is two dependent reads
// (a t3 row, then its major row), up to sa_intv - 1 steps on average.
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
  const i64* q_rows;       // [R, 64]: 32 packed code words | 32 ambiguity words
  const i64* t3;           // [n3, 64]: 32 u16-pair minor words | 32 sym words
  const i64* t3_major;     // [ceil(n3/256), 64]
  const i64* t3_exc_pos;   // [3]
  const i64* t3_exc_chr;   // [3]
  const i64* comb_pairs;   // packed lo | sz << 32
  const i64* init_corr;    // [12], -1 padded
  const i64* text_rows;    // [n4, 128] (direct indexes)
  const int32_t* sa_rows;  // [pad1024(seq_len + 1)] (direct indexes)
  const i64* starts;       // [B]
  const i64* stops;        // [B]
  i64* state;              // [11, B]
  i64* out;                // [B, max_out, 3]
  const i64* slot;         // [B] (pallas mode)
  const int32_t* res_k;    // [K] (pallas mode)
  int32_t* live;           // [2]
  i64 B, max_out, min_seed_length, max_seed_freq, sensitive, order;
  i64 use_init, use8, seq_len, n_look, mode, it;
};

// Must match ops/seed_cuda._ResolveArgs field for field.
struct ResolveArgs {
  const i64* t3;
  const i64* t3_major;
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
constexpr i64 kInitOff = 65536 + 136;   // ops/rank.INIT_OFF
// SA modes, as ops/seeding.SA_MODES; "xla" (1) reads sa_rows directly
constexpr int kModeNone = 0, kModePallas = 2;

// rows of the lane-state tensor, as ops/seeding.F_*
enum {
  F_PHASE, F_CURSOR, F_EXT_START, F_EXT_POS, F_IK1, F_IK2, F_TRI_FAILED,
  F_DIR_SET, F_DIR_OFF, F_OUT_N, F_POISON
};

__device__ __forceinline__ u32 w32(i64 v) { return static_cast<u32>(v); }

// 32-bit word j of the 2-bit fields starting at field offset `off` of a
// window of packed words (held in int64).
__device__ __forceinline__ u32 word_at(const i64* row, int off, int j) {
  const int ow = (off >> 4) + j;
  const int sh = (off & 15) << 1;
  const u32 a = w32(row[ow]);
  if (sh == 0) return a;
  return (a << sh) | (w32(row[ow + 1]) >> (32 - sh));
}

// u16 minor checkpoint of class j in a fused t3 row
__device__ __forceinline__ i64 minor_cp(const i64* row, int j) {
  return (w32(row[j >> 1]) >> ((j & 1) * 16)) & 0xFFFF;
}

// Single-class STRICT rank over the order-3 table (ops/rank.occ_t3):
// triple mode counts 8-bit symbols == cls (cls < 64) in T3[0, k), with the
// SA < 3 exception rows subtracted from class 0; single mode counts rows
// whose preceding char is cls (cls < 4), with the exceptions corrected.
__device__ i64 occ_t3(const i64* t3, const i64* t3_major,
                      const i64* exc_pos, const i64* exc_chr, i64 k,
                      bool triple, int cls) {
  const i64* row = t3 + (k >> 7) * 64;
  const i64* mrow = t3_major + (k >> 15) * 64;
  i64 cp = 0;
  if (triple) {
    cp = mrow[cls] + minor_cp(row, cls);
  } else {
    for (int j = cls; j < 64; j += 4) cp += mrow[j] + minor_cp(row, j);
  }
  const int m = static_cast<int>(k & 127);
  const u32 pat = static_cast<u32>(cls) * 0x01010101u;
  int cnt = 0;
  for (int j = 0; 4 * j < m; ++j) {
    const int keep = min(m - 4 * j, 4);           // bytes of word j counted
    const u32 mask = keep == 4 ? 0xFFFFFFFFu : (0xFFFFFFFFu << (32 - 8 * keep));
    const u32 x = w32(row[32 + j]) ^ pat;
    u32 eq;
    if (triple) {       // per-byte zero detect (symbols < 0x40)
      u32 s = x | (x >> 4);
      s |= s >> 2;
      s |= s >> 1;
      eq = ~s & 0x01010101u;
    } else {            // low two bits of each byte equal cls
      const u32 x2 = x & 0x03030303u;
      eq = ~(x2 | (x2 >> 1)) & 0x01010101u;
    }
    cnt += __popc(eq & mask);
  }
  int nbelow = 0, chr_match = 0;
  for (int i = 0; i < 3; ++i) {
    const bool below = exc_pos[i] < k;
    nbelow += below;
    chr_match += below && exc_chr[i] == cls;
  }
  const int zero_cls = cls == 0;
  const int corr = triple ? -zero_cls * nbelow : -zero_cls * nbelow + chr_match;
  return cp + cnt + corr;
}

__global__ void seed_step_kernel(const SeedArgs a) {
  const i64 b = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  // this launch counts into live[it & 1]; it clears the other counter for
  // the next launch (the host has already read it)
  if (b == 0) a.live[(a.it + 1) & 1] = 0;
  if (b >= a.B) return;
  i64* st = a.state;
  const i64 B = a.B;
  const i64 phase = st[F_PHASE * B + b], cursor = st[F_CURSOR * B + b];
  const i64 stop = a.stops[b];
  const bool in_init = phase == kPhaseInit && cursor < stop;
  const bool in_ext = phase == kPhaseExt;
  if (!in_init && !in_ext) return;           // a finished lane is inert
  const i64 ext_start = st[F_EXT_START * B + b];
  const i64 ext_pos = st[F_EXT_POS * B + b];
  const i64 ik1 = st[F_IK1 * B + b], ik2 = st[F_IK2 * B + b];
  const bool tri_failed = st[F_TRI_FAILED * B + b] != 0;
  const bool dir_set = st[F_DIR_SET * B + b] != 0;
  i64 dir_off = st[F_DIR_OFF * B + b];
  i64 out_n = st[F_OUT_N * B + b];
  i64 poison = st[F_POISON * B + b];
  const int order = static_cast<int>(a.order);

  const bool in_dir = in_ext && a.mode != kModeNone && ik2 == 1;
  const bool iv_ext = in_ext && !in_dir;

  // ---- query metadata (_meta16): the 16 bases at `look` ----
  i64 look = in_ext ? ext_pos : cursor;
  look = look < 0 ? 0 : (look > a.n_look - 1 ? a.n_look - 1 : look);
  const i64* qrow = a.q_rows + (look >> 8) * 64;
  const int qoff = static_cast<int>(look & 255);
  const u32 w = word_at(qrow, qoff, 0);
  const u32 amb = word_at(qrow + 32, qoff, 0);
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

  const i64 i3 = 65536 + cls3, i1 = 65536 + 64 + (3 - cls1);
  const i64 row_idx =
      in_init ? (init_can12  ? kInitOff + cls_init
                 : init_can8 ? cls8
                 : init_can3 ? i3
                             : i1)
              : (can3 ? i3 : i1);
  const u64 v = static_cast<u64>(a.comb_pairs[row_idx]);
  const i64 sel_a = static_cast<i64>(v & 0xFFFFFFFFull);
  const i64 sel_b = static_cast<i64>(v >> 32);
  int corr_n = 0;
  for (int i = 0; i < 12; ++i) corr_n += a.init_corr[i] == cls_init;
  const i64 init_sz = init_can12 ? sel_b - sel_a - corr_n : sel_b;

  // ---- INIT step ----
  const bool init_dead =
      in_init && (init_can12 || init_can8 || init_can3) && init_sz == 0;
  const bool start_ext = in_init && b1ok && !init_dead;
  const int init_jump = init_can12 ? order : init_can8 ? 8 : init_can3 ? 3 : 1;

  // ---- interval EXT step ----
  i64 e_ik1 = 0, e_ik2 = 0;
  bool fin_iv = false, tri_miss = false, ext_ok = false;
  if (iv_ext) {
    const i64 tk = occ_t3(a.t3, a.t3_major, a.t3_exc_pos, a.t3_exc_chr, ik1,
                          can3, cls);
    const i64 tl = occ_t3(a.t3, a.t3_major, a.t3_exc_pos, a.t3_exc_chr,
                          ik1 + ik2, can3, cls);
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
        const i64 s = a.slot[b];              // -1: past the K slots, stall
        enter = s >= 0;
        if (enter) rc_pos = a.res_k[s];
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
      const i64* trow = a.text_rows + (jrow >> 2) * 128 + (jrow & 3) * 32;
      const int toff = static_cast<int>(p_safe & 255);
      int run = 256;                          // first mismatch, 256 if none
      for (int j = 0; j < 16; ++j) {
        const u32 x = word_at(trow, toff, j) ^ word_at(qrow, qoff, j);
        const u32 mm = ((x | (x >> 1)) & 0x55555555u) | word_at(qrow + 32, qoff, j);
        if (mm != 0) {
          run = 16 * j + (__clz(mm) >> 1);
          break;
        }
      }
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
  const bool overflow = is_hit && out_n >= a.max_out;
  if (is_hit && !overflow) {
    i64* rec = a.out + (b * a.max_out + out_n) * 3;
    rec[0] = (ext_start - a.starts[b]) | (length << 16);
    // direct hits know their occurrence: k0 < 0 encodes -(r_start + 1)
    rec[1] = in_dir ? -(dir_off + ext_start) - 1 : ik1;
    rec[2] = min(freq, a.max_seed_freq + 1);
    out_n += 1;
  }

  // ---- state updates ----
  const i64 new_cursor = overflow ? stop
                         : ((in_init && !b1ok) || init_dead) ? cursor + 1
                         : finalize ? advance
                                    : cursor;
  if (overflow && poison == kPoisonNone) poison = ext_start;
  const i64 new_ext_pos = start_ext ? cursor + init_jump
                          : ext_ok  ? ext_pos + (can3 ? 3 : 1)
                          : dir_adv ? dir_ext_pos
                                    : ext_pos;
  const bool reset = start_ext || finalize;
  const i64 new_phase = start_ext ? kPhaseExt : finalize ? kPhaseInit : phase;
  st[F_PHASE * B + b] = new_phase;
  st[F_CURSOR * B + b] = new_cursor;
  st[F_EXT_START * B + b] = start_ext ? cursor : ext_start;
  st[F_EXT_POS * B + b] = new_ext_pos;
  st[F_IK1 * B + b] = start_ext ? sel_a : ext_ok ? e_ik1 : ik1;
  st[F_IK2 * B + b] = start_ext ? init_sz : ext_ok ? e_ik2 : ik2;
  st[F_TRI_FAILED * B + b] = !reset && (tri_miss || (!ext_ok && tri_failed));
  st[F_DIR_SET * B + b] = !reset && (in_dir_eff || dir_set);
  st[F_DIR_OFF * B + b] = dir_off;
  st[F_OUT_N * B + b] = out_n;
  st[F_POISON * B + b] = poison;
  if (new_phase == kPhaseExt || new_cursor < stop) atomicAdd(&a.live[a.it & 1], 1);
}

// LF mapping (ops/rank.lf_t3): the rank one text position to the left.
__device__ i64 lf_t3(const ResolveArgs& a, i64 k) {
  if (k == a.primary) return 0;
  const int inb = static_cast<int>(k & 127);
  const u32 w = w32(a.t3[(k >> 7) * 64 + 32 + (inb >> 2)]);
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
