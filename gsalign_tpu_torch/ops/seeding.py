"""Batched LMEM seeding on a torch device.

The reference walks each 10 kb query chunk sequentially, extending an exact
match through the FM-index one base at a time and restarting after each
emitted seed (src/GSAlign.cpp:51-107, src/bwt_search.cpp:141-185). Chunks are
independent (extension is clipped at the chunk end), so each chunk is a
lane here, and every lane runs the same state machine (one step of it is
seed_step_plain below).

Lane state machine (exact emulation of IdentifyLocalMEM + BWT_Search):
  INIT: read code[cursor]; ambiguous -> cursor+1; else start extension.
  EXT:  extend; on boundary/ambiguous/dead-end finalize:
        len = ext_pos - ext_start;
        hit iff len >= min_seed_length and 0 < freq <= max_seed_freq;
        hit  -> emit (qPos, len, rank_start, freq); cursor = ext_start +
                (sensitive ? 5 : len+1)
        miss -> cursor = ext_start + 1.
Lane done when cursor >= its emit bound in INIT phase.

Shortcuts that keep the seed set exact (as in the JAX package):
  INIT jump: the interval of the first 10 (12 above 64 M text rows) or 8
           bases is one row of comb_pairs; an empty row proves a miss.
  Triples: EXT steps consume three bases per rank query through the
           order-3 table whenever three unambiguous in-chunk bases remain.
  Direct:  on a full-SA index, once the interval is unique, the lane
           resolves its occurrence (one SA read) and compares 256 query
           bases against the packed text per iteration; the hit records
           the resolved position (k0 < 0 encodes it) instead of a rank.
           Sampled-SA and wide indexes have no direct mode; their hits are
           resolved afterwards by resolve_sa's LF walks.
On a wide index (ops/rank.py) ranks pass 2^31: the lane state and the
records are int64 throughout, so only the class-row reads differ.

How a lane entering direct mode reads its SA word (sa_mode, from
GSALIGN_SA_MODE as the JAX package's _pick_sa_mode): "xla" (the default)
reads sa_rows directly; "pallas" compacts the entering lanes, in lane
order, into _SA_GATHER_K slots whose words one masked gather reads (the
port of gather_pallas), and a lane beyond the slots stalls for one
iteration. Stalls change the iteration count, never the seeds.

Two ways to run the lanes to their ends (scan_lanes), one kernel launch a
scan round each:
  seed_scan      every lane runs to completion on its own
           (ops/seed_cuda.seed_scan). In the "xla" and "none" modes a
           lane's trajectory depends on nothing but its own state and the
           read-only tables, so lanes need no lock step. Its plain version
           is seed_scan_plain.
  seed_lockstep  every lane takes one step an iteration, and the loop, the
           slot compaction and the gather run on the card
           (ops/seed_cuda.seed_lockstep). "pallas" mode needs the lock
           step, because its K slots couple the lanes; in the other modes
           it remains as the lane-by-lane diffing tool (max_iters stops it
           after so many iterations; seed_cuda.seed_step is one).
The plain version of both is the host loop scan_lockstep: one
seed_step_plain over all lanes an iteration, in pallas mode after _sa_slots
and masked_gather_plain. It runs on the CPU and, beside the kernels, in the
comparisons on a card; nothing on a card's main path calls it.

Both give every lane the same steps, so the same records, final state and
per-lane step counts (F_STEPS), whose maximum is the lock-step loop's
iteration count. A lane has three bounds, as in the JAX scan: it records
starts up to its emit bound, its extensions stop at its ext bound, and the
chunk's end is its hard bound. With one segment a chunk (the main path)
all three are the chunk's end. With speculative segments (find_seeds_all
n_segments > 1) a lane scans one segment and extends up to slack bases
past it; an extension clipped there poisons the lane, as a full emit
buffer does, and the host reconciles each chunk's path from the lanes'
records and re-scans what it cannot join in further rounds. The JAX
package's halving-width lane cascade, power-of-two lane padding and its
"xlak" and "pallas_interp" SA modes are not carried.

Over a mesh (parallel/mesh.py) a round's lanes are cut into contiguous
stripes, one an entry, each scanned by its own launch on its entry's device
and stream (pallas mode: with its own K slots, as each JAX device has), all
launched before any is read back, and joined in mesh order, which is lane
order. The lock-step stripes of one card run in turn on one stream: a
cooperative grid of the card's size must not wait for another's blocks. A
row-sharded index (mesh.shard_index_rows) scans its lanes whole on the first
entry, reading the tables by blocks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from gsalign_tpu_torch.ops import rank as rank_ops
from gsalign_tpu_torch.ops.rank import DeviceFMIndex, M32
from gsalign_tpu_torch.utils import trace

PHASE_INIT = 0
PHASE_EXT = 1
POISON_NONE = 0x7FFFFFFF


def build_qrows(qcodes: torch.Tensor) -> torch.Tensor:
    """Overlapping 512-base query windows at stride 256: row r = [32 packed
    2-bit code words | 32 words of the ambiguity plane] covering bases
    [256r, 256r+512), int32 [R, 64] holding the uint32 words' bit patterns
    (as the index's word tables, see ops/rank.py). The ambiguity plane
    stores (code >= 4) in each 2-bit field's LOW bit. qcodes: uint8 [n] on
    the target device."""
    n = qcodes.shape[0]
    R = -(-n // 256)
    q = torch.full(((R + 1) * 256,), 4, dtype=torch.uint8,
                   device=qcodes.device)
    q[:n] = qcodes
    q = q.view(-1, 16)
    sh = ((15 - torch.arange(16, device=q.device)) * 2)[None, :]
    pk = (q.clamp(max=3).to(torch.int64) << sh).sum(1).view(R + 1, 16)
    am = ((q >= 4).to(torch.int64) << sh).sum(1).view(R + 1, 16)
    rows = torch.cat([pk[:-1], pk[1:], am[:-1], am[1:]], dim=1)
    # values in [0, 2^32) to the int32 with the same bits
    return (((rows + 0x80000000) & M32) - 0x80000000).to(torch.int32)


def _words_at(rows: torch.Tensor, off: torch.Tensor, n: int) -> torch.Tensor:
    """n aligned 32-bit words starting at 2-bit-field offset off (0..255) of
    [B, 32]-word windows (off + 16n fields must stay inside the window)."""
    ow = off >> 4
    sh = ((off & 15) << 1)[:, None]
    g = rows.gather(1, ow[:, None] + torch.arange(n + 1, device=off.device))
    # shifting right by 32 clears a 32-bit word: no sh == 0 special case
    return ((g[:, :n] << sh) & M32) | (g[:, 1:] >> (32 - sh))


def _meta16(qrow: torch.Tensor, off: torch.Tensor):
    """Scan metadata for the 16 bases at 2-bit-field offset `off` of
    [B, 64]-word query windows: (cls12, real3, b1ok, real8, amb_word).
    cls12 is the 12-mer class of bases p..p+11, (3 - base) in ASCENDING
    2-bit fields (the shorter classes nest: cls8 = cls12 & 0xFFFF, ...)."""
    w = _words_at(qrow[:, :32], off, 1)[:, 0]
    a = _words_at(qrow[:, 32:], off, 1)[:, 0]
    v = ~w & M32                                 # 3 - base, per field
    r = ((v << 2) & 0xCCCCCCCC) | ((v >> 2) & 0x33333333)
    r = ((r << 4) & 0xF0F0F0F0) | ((r >> 4) & 0x0F0F0F0F)
    r = ((r << 8) & 0xFF00FF00) | ((r >> 8) & 0x00FF00FF)
    r = ((r << 16) | (r >> 16)) & M32
    cls12 = r & 0xFFFFFF
    real8 = (a & 0xFFFF0000) == 0
    real3 = (a & 0xFC000000) == 0
    b1ok = (a & 0xC0000000) == 0
    return cls12, real3, b1ok, real8, a


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of nonzero 32-bit values held in int64 (binary search;
    torch has no clz)."""
    n = torch.zeros_like(x)
    for s, lim in ((16, 0xFFFF), (8, 0xFFFFFF), (4, 0xFFFFFFF),
                   (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        m = x <= lim
        n = n + m.to(x.dtype) * s
        x = torch.where(m, x << s, x)
    return n


# rows of the lane-state tensor (int64 [N_FIELDS, B]); csrc/seed.cu reads
# the same rows. F_STEPS counts the steps a lane has taken while live.
(F_PHASE, F_CURSOR, F_EXT_START, F_EXT_POS, F_IK1, F_IK2, F_TRI_FAILED,
 F_DIR_SET, F_DIR_OFF, F_OUT_N, F_POISON, F_STEPS) = range(12)
N_FIELDS = 12

# rows of a scan's counters (int64 [N_COUNTERS]), which the lock-step scan
# fills: iterations run, lanes still live after the last, SA words gathered
# through the compaction slots, and lane-iterations stalled past the slots
C_ITERS, C_LIVE, C_GATHERED, C_STALLED = range(4)
N_COUNTERS = 4

SA_MODES = ("none", "xla", "pallas")   # the kernel's mode argument: index
_SA_GATHER_K = 512     # pallas-mode compaction slots per iteration (tests
                       # shrink it to exercise the stall-retry path)


def pick_sa_mode(dfm: DeviceFMIndex) -> str:
    """The direct-mode SA read: GSALIGN_SA_MODE "xla" (the default when
    unset) or "pallas"; "none" for an index without direct mode. Any other
    value raises."""
    env = os.environ.get("GSALIGN_SA_MODE") or "xla"
    if env not in ("xla", "pallas"):
        raise ValueError(f"GSALIGN_SA_MODE must be xla or pallas, got "
                         f"{env!r} (the JAX package's xlak and pallas_interp "
                         f"are not carried)")
    return env if dfm.direct_ok else "none"


@dataclasses.dataclass(frozen=True)
class ScanParams:
    min_seed_length: int
    max_seed_freq: int
    sensitive: bool
    max_out: int
    sa_mode: str          # one of SA_MODES
    init12: bool = True   # the INIT-order jump (JAX init12)


def lane_bounds(starts, stops) -> np.ndarray:
    """A scan's lane bounds as int64 [3, B] (rows emit, ext, hard): stops
    int [B] is one bound for all three, int [3, B] gives them apart. A lane
    records starts in [start, emit); an extension is clipped at ext, which
    lies before the chunk's end hard for a speculative segment's lane.
    Raises unless emit <= ext <= hard for every lane."""
    starts = np.asarray(starts, dtype=np.int64)
    b = np.asarray(stops, dtype=np.int64)
    if b.ndim == 1:
        b = np.broadcast_to(b, (3,) + b.shape)
    if b.shape != (3, starts.shape[0]):
        raise ValueError(f"lane bounds must be [B] or [3, B] for B = "
                         f"{starts.shape[0]} lanes, got {b.shape}")
    if ((b[0] > b[1]) | (b[1] > b[2])).any():
        raise ValueError("lane bounds must keep emit <= ext <= hard")
    return np.ascontiguousarray(b)


@dataclasses.dataclass
class ScanLanes:
    """The device state of one scan round, updated in place by the scans.
    st and counters are views of one buffer, so that one copy reads both
    back (read_back)."""
    starts: torch.Tensor  # int64 [B]
    bounds: torch.Tensor  # int64 [3, B]: emit, ext, hard (lane_bounds)
    st: torch.Tensor      # int64 [N_FIELDS, B] lane state (F_* rows)
    out: torch.Tensor     # int64 [B, max_out, 3] records (meta, k0, freq)
    counters: torch.Tensor  # int64 [N_COUNTERS] (C_* rows)
    buf: torch.Tensor     # int64 [N_FIELDS * B + N_COUNTERS]: st | counters
    max_len: int          # longest extension, max(ext - starts, 0), bases
    max_emit: int         # longest emit span, max(emit - starts, 0), bases

    @property
    def emit_stops(self) -> torch.Tensor:
        return self.bounds[0]

    @property
    def ext_stops(self) -> torch.Tensor:
        return self.bounds[1]

    @property
    def hard_stops(self) -> torch.Tensor:
        return self.bounds[2]

    @staticmethod
    def start(starts: np.ndarray, stops: np.ndarray, max_out: int,
              device) -> "ScanLanes":
        """New lanes [starts, stops): stops int [B] (emit = ext = hard) or
        int [3, B] (lane_bounds)."""
        B = len(starts)
        bounds = lane_bounds(starts, stops)
        spans = bounds[:2] - np.asarray(starts, dtype=np.int64)
        host = np.zeros(N_FIELDS * B + N_COUNTERS, dtype=np.int64)
        st = host[:N_FIELDS * B].reshape(N_FIELDS, B)
        st[F_CURSOR] = starts
        st[F_POISON] = POISON_NONE

        def up(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        buf = up(host)
        # the state, and starts and bounds: int64 [B] and [3, B]
        trace.copied("h2d.seed", host.nbytes + 8 * 4 * B, device)
        return ScanLanes(
            starts=up(starts), bounds=up(bounds),
            st=buf[:N_FIELDS * B].view(N_FIELDS, B),
            out=torch.zeros((B, max_out, 3), dtype=torch.int64,
                            device=device),
            counters=buf[N_FIELDS * B:], buf=buf,
            max_len=max(0, int(spans[1].max())) if B else 0,
            max_emit=max(0, int(spans[0].max())) if B else 0)

    def read_back(self):
        """(lane state int64 [N_FIELDS, B], counters int64 [N_COUNTERS]) on
        the host, by one copy: on a card the scan's one synchronisation."""
        host = self.buf.cpu().numpy()
        trace.copied("d2h.seed", host.nbytes, self.buf.device)
        n = host.shape[0] - N_COUNTERS
        return host[:n].reshape(N_FIELDS, -1), host[n:]


def seed_step_plain(dfm: DeviceFMIndex, q_rows: torch.Tensor,
                    lanes: ScanLanes, prm: ScanParams,
                    slot: Optional[torch.Tensor] = None,
                    res_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One lock-step iteration of every lane, plain torch: updates
    lanes.st and lanes.out in place and returns the number of lanes still
    live (a 0-d tensor). In pallas mode slot (int64 [B], -1 for none) and
    res_k (int32 [K]) carry the compacted SA reads (_sa_slots). A lane
    records starts up to its emit bound; its INIT jumps, triples and
    extensions stop at its ext bound, and an extension clipped there before
    the chunk's end (ext < hard) poisons the lane (JAX seeding.py:446-490)."""
    i64 = torch.int64
    st = lanes.st
    starts_t = lanes.starts
    emit_t, ext_t, hard_t = lanes.emit_stops, lanes.ext_stops, \
        lanes.hard_stops
    B = st.shape[1]
    order = dfm.init_order
    use_init = prm.min_seed_length > order and prm.init12
    # INIT-8 is only emission-exact when any sub-8 match is a sure miss
    use8 = prm.min_seed_length > 8
    n_sa = dfm.seq_len + 1
    n_look = q_rows.shape[0] * 256
    seq_len = dfm.seq_len
    max_out = prm.max_out
    init_mask = (M32 << (32 - 2 * order)) & M32
    no = torch.zeros(B, dtype=torch.bool, device=st.device)
    phase, cursor, ext_start, ext_pos = (st[F_PHASE], st[F_CURSOR],
                                         st[F_EXT_START], st[F_EXT_POS])
    ik1, ik2, dir_off, out_n, poison = (st[F_IK1], st[F_IK2], st[F_DIR_OFF],
                                        st[F_OUT_N], st[F_POISON])
    tri_failed = st[F_TRI_FAILED] != 0
    dir_set = st[F_DIR_SET] != 0

    in_init = (phase == PHASE_INIT) & (cursor < emit_t)
    in_ext = phase == PHASE_EXT
    in_dir = in_ext & (ik2 == 1) if prm.sa_mode != "none" else no
    iv_ext = in_ext & ~in_dir

    # one metadata fetch: INIT lanes look at `cursor`, EXT at `ext_pos`;
    # the direct comparator's query window is the same row
    look = torch.where(in_ext, ext_pos, cursor).clamp(0, n_look - 1)
    qrow = rank_ops.widen(q_rows[look >> 8])                     # [B, 64]
    cls12, real3, b1ok, real8, amb_w = _meta16(qrow, look & 255)
    cls_init = cls12 & ((1 << (2 * order)) - 1)
    cls8 = cls12 & 0xFFFF
    cls3 = cls12 & 63
    cls1 = cls12 & 3

    # ---- INIT class choice: INIT-order jump, else 8, 3, 1 ----
    init_amb = ~b1ok
    if use_init:
        init_can12 = b1ok & ((amb_w & init_mask) == 0) \
            & (cursor + (order - 1) < ext_t)
    else:
        init_can12 = no
    init_can8 = b1ok & real8 & (cursor + 7 < ext_t) & ~init_can12 \
        if use8 else no
    init_can3 = b1ok & real3 & (cursor + 2 < ext_t) \
        & ~init_can8 & ~init_can12

    # ---- EXT class choice: triple (3 bases) when possible, else 1 ----
    can3 = iv_ext & (ext_pos + 2 < ext_t) & real3 & ~tri_failed
    cls = torch.where(can3, cls3, cls1)

    # one class row per lane; the INIT-order rows carry starts[g+1], so
    # their sz is starts[g+1] - starts[g] minus the short-suffix step keys
    # in init_corr. Narrow: one packed (lo | sz << 32) word a row. Wide:
    # two reads in the flattened planes, sz at lo + COMB_HALF, or for an
    # INIT-order row starts[g+1] at lo + 1.
    i3_lo_idx = 65536 + cls3
    i1_lo_idx = 65536 + 64 + (3 - cls1)
    init_off = rank_ops.INIT_OFF_WIDE if dfm.wide else rank_ops.INIT_OFF
    init_lo_idx = torch.where(
        init_can12, init_off + cls_init,
        torch.where(init_can8, cls8,
                    torch.where(init_can3, i3_lo_idx, i1_lo_idx)))
    ext_lo_idx = torch.where(can3, i3_lo_idx, i1_lo_idx)
    idx_a = torch.where(in_init, init_lo_idx, ext_lo_idx)
    if dfm.wide:
        idx_b = torch.where(
            in_init, init_lo_idx + torch.where(init_can12, 1,
                                               rank_ops.COMB_HALF), idx_a)
        v = dfm.comb_pairs[torch.cat([idx_a, idx_b])]
        sel_a, sel_b = v[:B], v[B:]
    else:
        v = dfm.comb_pairs[idx_a]
        sel_a = v & M32
        sel_b = v >> 32
    corr_n = (cls_init[:, None] == dfm.init_corr[None, :]).sum(1)
    init_sz = torch.where(init_can12, sel_b - sel_a - corr_n, sel_b)

    # ---- INIT step ----
    init_dead = in_init & (init_can12 | init_can8 | init_can3) \
        & (init_sz == 0)
    start_ext = in_init & b1ok & ~init_dead
    init_jump = torch.where(
        init_can12, order,
        torch.where(init_can8, 8, torch.where(init_can3, 3, 1)))

    # ---- interval EXT step ----
    cnt = rank_ops.occ_t3(dfm, torch.cat([ik1, ik1 + ik2]),
                          torch.cat([can3, can3]), torch.cat([cls, cls]))
    tk, tl = cnt[:B], cnt[B:]
    e_ik1 = sel_a + tk
    e_ik2 = tl - tk
    hit_boundary = ext_pos >= ext_t
    dead_end = (e_ik2 == 0) & ~can3
    fin_iv = iv_ext & (hit_boundary | ~b1ok | dead_end)
    tri_miss = iv_ext & can3 & (e_ik2 == 0)
    ext_ok = iv_ext & ~fin_iv & ~tri_miss

    # ---- DIRECT step: unique-interval lanes compare text to query ----
    if prm.sa_mode != "none":
        need = in_dir & ~dir_set          # lanes resolving their SA now
        if prm.sa_mode == "pallas":
            # compacted reads: a lane past the K slots stalls this
            # iteration (enter stays False, so none of its state moves)
            enter = need & (slot >= 0)
            rc_pos = res_k[slot.clamp(0, res_k.shape[0] - 1)].to(i64)
        else:
            enter = need
            rc_pos = dfm.sa_rows[ik1.clamp(0, n_sa - 1)].to(i64)
        in_dir_eff = in_dir & (dir_set | enter)
        dir_off = torch.where(enter, seq_len - rc_pos - ext_pos, dir_off)
        p = dir_off + ext_pos             # text pos of next compare
        p_safe = p.clamp(0, seq_len - 1)
        jrow = p_safe >> 8
        trow4 = rank_ops.widen(dfm.text_rows[jrow >> 2])         # [B, 128]
        trow = trow4.view(B, 4, 32).gather(
            1, (jrow & 3)[:, None, None].expand(B, 1, 32))[:, 0]
        tw = _words_at(trow, p_safe & 255, 16)
        qw = _words_at(qrow[:, :32], look & 255, 16)
        aw = _words_at(qrow[:, 32:], look & 255, 16)
        x = tw ^ qw
        mm = ((x | (x >> 1)) & 0x55555555) | aw                  # [B, 16]
        # first mismatch = min over words of 16j + clz/2; 256 if none
        j16 = torch.arange(16, device=st.device)[None, :] * 16
        cand = torch.where(mm == 0, 4096, j16 + (_clz32(mm) >> 1))
        run = cand.min(1).values.clamp(max=256)
        lim_q = ext_t - ext_pos
        lim_t = seq_len - p
        limit = torch.minimum(torch.minimum(lim_q, lim_t),
                              torch.full_like(lim_q, 256))
        adv = torch.minimum(run, limit.clamp(min=0))
        reach = run >= limit
        # boundary (checked first, like the interval path) > text-end
        # dead-end > plain continue at a full 256-base window
        bound_dir = reach & (lim_q <= lim_t.clamp(max=256))
        tdead_dir = reach & ~bound_dir & (lim_t <= 256)
        cont_dir = reach & ~bound_dir & ~tdead_dir
        fin_dir = in_dir_eff & (~reach | bound_dir | tdead_dir)
        dir_adv = in_dir_eff & cont_dir
        dir_ext_pos = ext_pos + adv
    else:
        in_dir_eff = fin_dir = dir_adv = bound_dir = no
        dir_ext_pos = ext_pos

    # ---- finalize ----
    finalize = fin_iv | fin_dir
    length = torch.where(in_dir, dir_ext_pos, ext_pos) - ext_start
    freq = ik2
    is_hit = finalize & (length >= prm.min_seed_length) & (freq > 0) \
        & (freq <= prm.max_seed_freq)
    advance = torch.where(
        is_hit, ext_start + (5 if prm.sensitive else length + 1),
        ext_start + 1)
    # an extension clipped at an artificial bound (a speculative segment's,
    # not the chunk's end) poisons the lane, as a full emit buffer does: it
    # retires here and the host re-scans it from this start position
    overflow = is_hit & (out_n >= max_out)
    poisoned = (finalize & torch.where(in_dir, bound_dir, hit_boundary)
                & (ext_t < hard_t)) | overflow
    do_emit = is_hit & ~overflow
    # direct hits already know their occurrence: k0 < 0 encodes the
    # resolved text position -(r_start+1) instead of a rank
    k0 = torch.where(in_dir, -(dir_off + ext_start) - 1, ik1)
    rec = torch.stack([(ext_start - starts_t) | (length << 16), k0,
                       freq.clamp(max=prm.max_seed_freq + 1)], dim=1)
    out = lanes.out
    slot_o = out_n.clamp(max=max_out - 1)[:, None, None].expand(B, 1, 3)
    out.scatter_(1, slot_o, torch.where(do_emit[:, None, None],
                                        rec[:, None, :],
                                        out.gather(1, slot_o)))

    # ---- state updates ----
    new_cursor = torch.where(
        poisoned, emit_t,
        torch.where((in_init & init_amb) | init_dead, cursor + 1,
                    torch.where(finalize, advance, cursor)))
    new_poison = torch.where(poisoned & (poison == POISON_NONE), ext_start,
                             poison)
    new_ext_pos = torch.where(
        start_ext, cursor + init_jump,
        torch.where(ext_ok, ext_pos + torch.where(can3, 3, 1),
                    torch.where(dir_adv, dir_ext_pos, ext_pos)))
    reset = start_ext | finalize
    new_phase = torch.where(start_ext, PHASE_EXT,
                            torch.where(finalize, PHASE_INIT, phase))
    st.copy_(torch.stack([
        new_phase, new_cursor,
        torch.where(start_ext, cursor, ext_start),
        new_ext_pos,
        torch.where(start_ext, sel_a, torch.where(ext_ok, e_ik1, ik1)),
        torch.where(start_ext, init_sz, torch.where(ext_ok, e_ik2, ik2)),
        (~reset & (tri_miss | (~ext_ok & tri_failed))).to(i64),
        (~reset & (in_dir_eff | dir_set)).to(i64),
        dir_off, out_n + do_emit.to(i64), new_poison,
        st[F_STEPS] + (in_init | in_ext).to(i64)]))
    live = ((new_phase == PHASE_INIT) & (new_cursor < emit_t)) \
        | (new_phase == PHASE_EXT)
    return live.sum()


def _sa_need(st: torch.Tensor) -> torch.Tensor:
    """The lanes that enter direct mode this iteration and have their SA
    word still to read (bool [B])."""
    return (st[F_PHASE] == PHASE_EXT) & (st[F_IK2] == 1) \
        & (st[F_DIR_SET] == 0)


def _sa_slots(dfm: DeviceFMIndex, lanes: ScanLanes, K: int, gather):
    """pallas mode: compact the lanes that enter direct mode this
    iteration, in lane order, into K slots and read their SA words with one
    masked gather (JAX seeding.py:366-386). Returns (slot int64 [B], -1
    past the K slots; res_k int32 [K])."""
    st = lanes.st
    need = _sa_need(st)
    pos = torch.cumsum(need, 0) - 1
    slot = torch.where(need & (pos < K), pos, -1)
    idx = torch.full((K + 1,), -1, dtype=torch.int32, device=st.device)
    # slots past min(n_need, K) keep -1; every other lane writes slot K,
    # which is dropped
    idx.scatter_(0, torch.where(slot >= 0, slot, K),
                 st[F_IK1].clamp(0, dfm.seq_len).to(torch.int32))
    return slot, gather(dfm.sa_rows, idx[:K])


def scan_lockstep(dfm: DeviceFMIndex, q_rows: torch.Tensor,
                  lanes: ScanLanes, prm: ScanParams, plain: bool,
                  max_iters: int = 0) -> int:
    """Run every lane of `lanes` in lock step, in place: one step over all
    lanes per iteration, until none is live or (max_iters > 0) max_iters
    iterations have run. plain runs the host loop of the plain torch step,
    slots and gather on any device: the plain version of the seed_lockstep
    kernel, which runs otherwise (ops/seed_cuda.seed_lockstep). Fills
    lanes.counters and returns the iteration count (without stalls, the
    maximum of the lanes' F_STEPS)."""
    if not plain:
        from gsalign_tpu_torch.ops import seed_cuda
        return int(seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm,
                                           max_iters)[1][C_ITERS])
    from gsalign_tpu_torch.ops.gather import masked_gather_plain
    K = min(_SA_GATHER_K, lanes.st.shape[1])
    n_iter = 0
    lanes.counters.zero_()
    live = ((lanes.st[F_PHASE] == PHASE_EXT)
            | (lanes.st[F_CURSOR] < lanes.emit_stops)).sum()
    # reading the live count is the host loop's one sync an iteration
    while int(live) > 0 and (max_iters <= 0 or n_iter < max_iters):
        slot = res_k = None
        if prm.sa_mode == "pallas":
            slot, res_k = _sa_slots(dfm, lanes, K, masked_gather_plain)
            got = (slot >= 0).sum()
            lanes.counters[C_GATHERED] += got
            lanes.counters[C_STALLED] += _sa_need(lanes.st).sum() - got
        live = seed_step_plain(dfm, q_rows, lanes, prm, slot, res_k)
        n_iter += 1
    lanes.counters[C_ITERS] = n_iter
    lanes.counters[C_LIVE] = live
    return n_iter


def seed_scan_plain(dfm: DeviceFMIndex, q_rows: torch.Tensor,
                    lanes: ScanLanes, prm: ScanParams) -> np.ndarray:
    """The plain version of the seed_scan kernel (ops/seed_cuda.py): every
    lane of `lanes` to its end, in place, by the lock-step loop of
    seed_step_plain. Returns the final lane state on the host (int64
    [N_FIELDS, B])."""
    if prm.sa_mode == "pallas":
        raise ValueError("seed_scan runs the xla and none SA modes: pallas "
                         "mode couples the lanes and needs the lock step")
    scan_lockstep(dfm, q_rows, lanes, prm, plain=True)
    return lanes.read_back()[0]


def _scan_launch(dfm, q_rows, starts, stops, prm, plain):
    """Start one scan of lanes [starts, stops) on q_rows' device and current
    stream; returns what _scan_result reads back."""
    from gsalign_tpu_torch.ops import seed_cuda
    lanes = ScanLanes.start(starts, stops, prm.max_out, q_rows.device)
    if plain:
        scan_lockstep(dfm, q_rows, lanes, prm, plain=True)
        cap = None
    elif prm.sa_mode == "pallas":
        seed_cuda.lockstep_launch(dfm, q_rows, lanes, prm)
        cap = None
    else:
        cap = seed_cuda.scan_launch(dfm, q_rows, lanes, prm)
    return lanes, cap


def _records(lanes: ScanLanes, prm: ScanParams) -> np.ndarray:
    """The emitted records on the host, in lane-major order."""
    keep = torch.arange(prm.max_out, device=lanes.st.device)[None, :] \
        < lanes.st[F_OUT_N][:, None]
    recs = lanes.out[keep].cpu().numpy()
    trace.copied("d2h.seed", recs.nbytes, lanes.out.device)
    return recs


def _scan_result(pending, prm, plain):
    """(st, recs) of a scan _scan_launch started."""
    from gsalign_tpu_torch.ops import seed_cuda
    lanes, cap = pending
    if plain:
        st = lanes.read_back()[0]
    elif prm.sa_mode == "pallas":
        st = seed_cuda.lockstep_result(lanes)[0]
    else:
        st = seed_cuda.scan_result(lanes, cap)
    return st, _records(lanes, prm)


def scan_lanes(dfm: DeviceFMIndex, q_rows: torch.Tensor, starts: np.ndarray,
               stops: np.ndarray, prm: ScanParams, plain: bool = False):
    """Run every lane from starts[i] to completion: stops is int [B] (the
    lane's end, emit = ext = hard) or int [3, B] (emit, ext and hard
    bounds, lane_bounds). Returns host arrays (st, recs): the final lane
    state int64 [N_FIELDS, B] (F_CURSOR the exit position, F_POISON,
    F_OUT_N, F_STEPS per lane) and the emitted records int64 [sum(out_n),
    3] in lane-major order. plain runs the plain torch versions on any
    device; otherwise one kernel launch runs the scan: seed_scan in the xla
    and none modes, seed_lockstep in pallas mode."""
    return _scan_lanes(dfm, q_rows, starts, stops, prm, plain, None)[:2]


def _scan_lanes(dfm, q_rows, starts, stops, prm, plain, mesh, fm=None):
    """scan_lanes, or over a mesh (parallel/mesh.Mesh) one such scan a
    stripe of the lanes (module docstring), a stripe that holds no lane not
    launched; and the number of scans it ran. fm, the host index dfm was
    laid out from, lays the tables out on the mesh's other devices
    (parallel/mesh.shard_index)."""
    if prm.min_seed_length <= 3:
        raise ValueError("the triple-step shortcuts need min_seed_length > 3")
    if mesh is None:
        return (*_scan_result(_scan_launch(dfm, q_rows, starts, stops, prm,
                                           plain), prm, plain), 1)
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    B = len(starts)
    n = mesh.size
    per = mesh_lib.pad_to_multiple(max(B, 1), n) // n
    # the bounds cut along the lanes; the padding lanes are empty
    parts = zip(mesh_lib.stripes(np.asarray(starts, np.int64), n, 0),
                mesh_lib.stripes(lane_bounds(starts, stops).T, n, 0))
    tables = mesh_lib.shard_index(dfm, mesh, fm)
    rows = {dev: q_rows.to(dev) for dev in tables}
    shared = prm.sa_mode == "pallas" and not plain
    pending = []
    for i, (st_i, sp_i) in enumerate(parts):
        real = min(per, max(0, B - i * per))
        if real == 0:
            continue
        dev = mesh.devices[i]
        with mesh.on(i, shared=shared):
            pending.append((i, real, _scan_launch(tables[dev], rows[dev],
                                                  st_i, sp_i.T, prm, plain)))
    st_parts, rec_parts = [], []
    for i, real, p in pending:
        with mesh.on(i, shared=shared):
            st, recs = _scan_result(p, prm, plain)
        st_parts.append(st[:, :real])       # the padding lanes emit nothing
        rec_parts.append(recs)
    if not pending:
        return (np.zeros((N_FIELDS, 0), np.int64),
                np.zeros((0, 3), np.int64), 0)
    return (np.concatenate(st_parts, axis=1), np.concatenate(rec_parts),
            len(pending))


def record_starts(starts: np.ndarray, st: np.ndarray,
                  recs: np.ndarray) -> np.ndarray:
    """The query position of every record of a scan round (lane-major, as
    scan_lanes returns them)."""
    lane = np.repeat(np.arange(len(starts), dtype=np.int64), st[F_OUT_N])
    return (recs[:, 0] & 0xFFFF) + np.asarray(starts, np.int64)[lane]


def poison_causes(st: np.ndarray, qs: np.ndarray, max_out: int):
    """(lanes poisoned at a bound, lanes poisoned with a full emit buffer)
    of a scan round, qs its records' positions (record_starts). A poisoned
    lane whose buffer has room, or whose last record stands at its poison
    position (the clipped hit), was clipped at its ext bound; any other had
    a full buffer (an overflow, or a clipped miss that filled nothing)."""
    n, poison = st[F_OUT_N], st[F_POISON]
    last = np.full(n.shape[0], -1, dtype=np.int64)
    has = n > 0
    last[has] = qs[np.cumsum(n)[has] - 1]
    bad = poison != POISON_NONE
    bound = bad & ((n < max_out) | (last == poison))
    return int(bound.sum()), int((bad & ~bound).sum())


def find_seeds_all(dfm: DeviceFMIndex,
                   codes_list,
                   min_seed_length: int = 15,
                   max_seed_freq: int = 100,
                   sensitive: bool = False,
                   chunk: int = 10000,
                   n_segments: int = 1,
                   slack: int = 600,
                   mesh=None,
                   max_out_cap: Optional[int] = None,
                   init12: bool = True,
                   *,
                   stats: Optional[dict] = None,
                   plain: bool = False,
                   rounds: Optional[list] = None,
                   fm=None):
    """Seed ALL query chromosomes, exactly reproducing the reference's
    per-chunk sequential scan: the lanes of every chromosome's chunks, all
    in one device scan per round (scan_lanes), or one a stripe over `mesh`
    (parallel/mesh.Mesh, whose first entry is dfm's device; a row-sharded
    dfm scans its lanes whole). fm, the host FMIndex dfm was laid out
    from, lays the tables out on the mesh's other devices; a mesh of dfm's
    device alone needs none. The seeds are the same for any mesh and any
    n_segments.

    n_segments = 1: one lane a chunk, its extensions clipped at the chunk's
    end. n_segments > 1 (speculative segments, as the JAX package's
    find_seeds_all): each chunk is cut into segments of chunk // n_segments
    bases, each scanned by a lane of its own from the segment's start, its
    extensions clipped at seg_end + slack; an extension clipped there
    poisons the lane from that start position, and the host reconciles each
    chunk's true path (_reconcile) and re-scans the spans it cannot join,
    with the real clip, in further rounds. init12=False turns the
    INIT-order jump off.

    Returns [(q_pos, r_pos, length), ...] per chromosome, each sorted by
    (PosDiff, qPos), identical to the reference scan. With `stats`, records
    per round the most steps any lane took ("scan_iterations": the
    lock-step loop's iteration count), the scans run ("scan_launches": one
    a stripe that holds lanes), and the lanes poisoned at a bound and with
    a full emit buffer ("poisoned_at_bound", "poisoned_full":
    poison_causes); and the first round's lane count ("scan_lanes"). With
    `rounds`, appends each round's scan_lanes arguments and results, (q_rows,
    starts, stops, prm, st, recs): the tests and the comparison of the
    kernels with their plain versions scan these lanes again, and the
    tools read each lane's steps (F_STEPS) and records (F_OUT_N) there.
    GSALIGN_SA_MODE picks the SA mode (see pick_sa_mode). plain runs the
    plain torch versions of the seed-stage kernels (seed_scan,
    seed_lockstep, resolve_sa) on any device: the comparison with the
    kernels on a card uses it.

    In the run's recorder (utils/trace): spans seed.lanes, seed.scan (one
    a round, from the launch to the lane state and records on the host),
    seed.hits, seed.expand and seed.split (the host's seconds between the
    rounds); counters seed.rounds,
    seed.lanes, seed.steps, seed.records, seed.hits, seed.resolved and the
    bytes h2d.seed, h2d.resolve and d2h.seed."""
    # a record packs its start's offset from the lane's start and its
    # length into 16-bit fields
    if chunk + slack > 0xFFFF:
        raise ValueError("seed chunk plus slack too large for the packed "
                         "emit record")
    if n_segments < 1:
        raise ValueError(f"n_segments must be at least 1, got {n_segments}")
    with trace.span("seed.lanes"):
        sa_mode = pick_sa_mode(dfm)
        offs = []
        chunk_bounds = []            # (concat_start, concat_stop) per chunk
        off = 0
        for codes in codes_list:
            L = int(codes.shape[0])
            n_chunks = max(1, -(-L // chunk))
            offs.append(off)
            for c in range(n_chunks):
                s = off + c * chunk
                chunk_bounds.append((s, min(s + chunk, off + L)))
            off += n_chunks * chunk
        qc = np.full(off, 4, dtype=np.uint8)
        for codes, o in zip(codes_list, offs):
            qc[o:o + len(codes)] = codes
        q_rows = build_qrows(torch.from_numpy(qc).to(dfm.device))
        trace.copied("h2d.seed", qc.nbytes, dfm.device)
        del qc      # its pages go back here, in the span, not at return

        # a lane records starts over one segment at most
        seg_len = max(1, chunk // n_segments)
        hard_max = seg_len // (5 if sensitive else (min_seed_length + 1)) + 2
        if max_out_cap is None:
            max_out_cap = 512 if sensitive else 96
        max_out = min(hard_max, max(2, max_out_cap))
        prm = ScanParams(min_seed_length=min_seed_length,
                         max_seed_freq=max_seed_freq, sensitive=sensitive,
                         max_out=max_out, sa_mode=sa_mode, init12=init12)
    lane_mesh = None if dfm.row_shards is not None else mesh
    log = {"scan_iterations": [], "scan_launches": [],
           "poisoned_at_bound": [], "poisoned_full": []}

    def scan(starts, stops):
        """One round (span seed.scan, its records' positions seed.hits):
        (st, recs, the records' positions)."""
        with trace.span("seed.scan"):
            st, recs, n_scans = _scan_lanes(dfm, q_rows, starts, stops, prm,
                                            plain, lane_mesh, fm)
        log.setdefault("scan_lanes", len(starts))
        if rounds is not None:
            rounds.append((q_rows, starts, stops, prm, st, recs))
        with trace.span("seed.hits"):
            qs = record_starts(starts, st, recs)
            log["scan_iterations"].append(int(st[F_STEPS].max())
                                          if len(starts) else 0)
            log["scan_launches"].append(n_scans)
            for key, n in zip(("poisoned_at_bound", "poisoned_full"),
                              poison_causes(st, qs, max_out)):
                log[key].append(n)
            trace.count("seed.rounds")
            trace.count("seed.lanes", len(starts))
            trace.count("seed.steps", int(st[F_STEPS].sum()))
            trace.count("seed.records", len(recs))
        return st, recs, qs

    if n_segments == 1:
        hits = _chunk_lanes(scan, chunk_bounds, chunk, max_out)
    else:
        hits = _segment_lanes(scan, chunk_bounds, chunk, seg_len, slack,
                              n_segments, max_out, sensitive)
    if stats is not None:
        stats.update(log)
    with trace.span("seed.expand"):
        flat = [np.concatenate(h) if h else np.zeros(0, np.int64)
                for h in hits]
        trace.count("seed.hits", len(flat[0]))
        q_pos, r_pos, length = _expand_hits(dfm, *flat, plain)
    with trace.span("seed.split"):
        return _split_per_chromosome(q_pos, r_pos, length, codes_list, offs)


def _chunk_lanes(scan, chunk_bounds, chunk, max_out):
    """n_segments = 1: one lane a chunk, extensions clipped at its end. The
    seeds are the records below each lane's poison position, plus re-scan
    rounds from the poison positions of lanes whose emit buffer overflowed.
    Returns the hits' (qs, ls, k0, fr) as lists of arrays."""
    with trace.span("seed.lanes"):
        starts = np.asarray([s for s, _ in chunk_bounds], dtype=np.int64)
        stops = np.asarray([e for _, e in chunk_bounds], dtype=np.int64)
    hits = ([], [], [], [])
    # each round advances an overflowing lane by >= max_out hits
    for _round in range(2 + -(-chunk // max(1, max_out))):
        st, recs, qs = scan(starts, stops)
        with trace.span("seed.hits"):
            poison = st[F_POISON]
            keep = qs < np.repeat(poison, st[F_OUT_N])
            for h, col in zip(hits, (qs, recs[:, 0] >> 16, recs[:, 1],
                                     recs[:, 2])):
                h.append(col[keep])
            pend = np.flatnonzero(poison != POISON_NONE)
        if pend.size == 0:
            return hits
        starts = poison[pend]
        stops = stops[pend]
    raise RuntimeError("seed overflow re-scan did not converge")


class _Lane:
    """One scanned lane's results, as the reconciliation reads them: its
    start, its records' positions (qs), lengths, k0 and freq, the position
    its scan advanced to after each record (adv), its exit cursor and its
    poison position."""
    __slots__ = ("start", "qs", "ls", "k0", "fr", "adv", "exit", "poison")

    def __init__(self, start, qs, ls, k0, fr, adv, exit_, poison):
        (self.start, self.qs, self.ls, self.k0, self.fr, self.adv, self.exit,
         self.poison) = start, qs, ls, k0, fr, adv, exit_, poison

    def visited(self, e: int) -> bool:
        """Was position e a scan start of this lane's path? True iff no
        record jumped over it (between records the scan advances by one;
        the JAX package's seeding._visited)."""
        h = int(np.searchsorted(self.qs, e, side="left")) - 1  # qs[h] < e
        return h < 0 or e >= self.adv[h]


def _lanes_of(starts, st, recs, qs, sensitive):
    """_Lane of every lane of a scan round."""
    n = st[F_OUT_N]
    ends = np.cumsum(n)
    ls = recs[:, 0] >> 16
    adv = qs + (5 if sensitive else ls + 1)
    return [_Lane(int(starts[i]), qs[b:e], ls[b:e], recs[b:e, 1],
                  recs[b:e, 2], adv[b:e], int(st[F_CURSOR, i]),
                  int(st[F_POISON, i]))
            for i, (b, e) in enumerate(zip((ends - n).tolist(),
                                           ends.tolist()))]


def _segment_lanes(scan, chunk_bounds, chunk, seg_len, slack, n_segments,
                   max_out, sensitive):
    """n_segments > 1: round 1 scans a lane from every segment's start,
    each recording over its segment and extending to seg_end + slack; then
    the host reconciles (_reconcile) and scans the spans it could not join
    in fixup rounds, with the chunk's end as the real clip. Returns the
    hits' (qs, ls, k0, fr) as lists of arrays."""
    starts, bounds, keys = [], [], []
    with trace.span("seed.lanes"):
        for ci, (cs, ce) in enumerate(chunk_bounds):
            for k, p in enumerate(range(cs, ce, seg_len)):
                starts.append(p)
                bounds.append((min(p + seg_len, ce),
                               min(p + seg_len + slack, ce), ce))
                keys.append((ci, k))
        starts = np.asarray(starts, dtype=np.int64)
    st, recs, qs = scan(starts, np.asarray(bounds, dtype=np.int64).T)
    with trace.span("seed.hits"):
        lanes = dict(zip(keys, _lanes_of(starts, st, recs, qs, sensitive)))
    hits = ([], [], [], [])
    entry = np.asarray([cs for cs, _ in chunk_bounds], dtype=np.int64)
    done = np.zeros(len(chunk_bounds), dtype=bool)
    # the reconciliation passes, and overflow re-scans (each advances an
    # overflowing chunk by >= max_out hits)
    for _round in range(n_segments + 1 + -(-chunk // max(1, max_out))):
        with trace.span("seed.hits"):
            fixups = _reconcile(lanes, chunk_bounds, seg_len, entry, done,
                                hits)
        if not fixups:
            break
        f = np.asarray(fixups, dtype=np.int64)          # ci, k, e, emit, ce
        # the fixup lanes clip at the chunk's end: never poisoned at a
        # bound, though a full emit buffer still poisons
        st, recs, qs = scan(f[:, 2], f[:, [3, 4, 4]].T)
        with trace.span("seed.hits"):
            lanes.update(zip(map(tuple, f[:, :2].tolist()),
                             _lanes_of(f[:, 2], st, recs, qs, sensitive)))
    else:
        raise RuntimeError("seed reconciliation did not converge")
    return hits


def _reconcile(lanes, chunk_bounds, seg_len, entry, done, hits) -> list:
    """One reconciliation pass: walk each chunk not done from its entry
    position e through its segments' lanes. A lane that started at e, or
    whose path visited e (_Lane.visited), holds the true path from e up to
    its poison position (a path is a function of the position alone), or
    else to its exit: its records there are the chunk's hits, appended to
    `hits`, and e moves on. A lane that started past e, e inside a lane's
    poisoned span, or a lane whose path jumped over e stops the walk: e
    starts a fixup lane over the rest of its segment. Updates entry and
    done in place; returns the fixups [(ci, k, e, emit, ce)]."""
    fixups = []
    for ci, (cs, ce) in enumerate(chunk_bounds):
        if done[ci]:
            continue
        e = int(entry[ci])
        while e < ce:
            k = (e - cs) // seg_len
            lane = lanes.get((ci, k))
            if lane is not None and (lane.start > e or e >= lane.poison):
                lane = None
            if lane is None or (lane.start < e and not lane.visited(e)):
                fixups.append((ci, k, e, min(cs + (k + 1) * seg_len, ce),
                               ce))
                break
            i = int(np.searchsorted(lane.qs, e))
            j = int(np.searchsorted(lane.qs, lane.poison)) \
                if lane.poison != POISON_NONE else len(lane.qs)
            for h, col in zip(hits, (lane.qs, lane.ls, lane.k0, lane.fr)):
                h.append(col[i:j])
            e = lane.poison if lane.poison != POISON_NONE else lane.exit
        else:
            done[ci] = True
        entry[ci] = e
    return fixups


def _split_per_chromosome(q_pos, r_pos, length, codes_list, offs):
    """Split concatenated-coordinate hits per chromosome, sorted by
    (PosDiff, qPos) — identical to the reference scan order."""
    results = []
    for codes, o in zip(codes_list, offs):
        L = int(codes.shape[0])
        m = (q_pos >= o) & (q_pos < o + L)
        qp = q_pos[m] - o
        rp = r_pos[m]
        ln = length[m]
        order = np.lexsort((qp, rp - qp))
        results.append((qp[order], rp[order], ln[order]))
    return results


def hit_ranks(k0: np.ndarray, fr: np.ndarray):
    """One entry per occurrence of flat hits: (rep, ranks, k0r) — the hit
    of each occurrence, the SA rank it resolves (0 where the hit carries a
    pre-resolved position, k0 < 0), and the hit's k0."""
    fr = fr.astype(np.int64)
    total = int(fr.sum())
    rep = np.repeat(np.arange(fr.shape[0]), fr)
    offset = np.arange(total) - np.repeat(np.cumsum(fr) - fr, fr)
    k0r = k0[rep].astype(np.int64)
    return rep, np.where(k0r < 0, 0, k0r + offset), k0r


def _expand_hits(dfm: DeviceFMIndex, qs, ls, k0, fr, plain: bool = False):
    """Resolve occurrence positions for flat hit arrays: a host gather on
    a full-SA index, resolve_sa on the device on a sampled one."""
    if qs.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    rep, ranks, k0r = hit_ranks(k0, fr)
    if dfm.host_sa is not None:
        rc_pos = dfm.host_sa[ranks].astype(np.int64)
    else:
        from gsalign_tpu_torch.ops import seed_cuda
        resolve = rank_ops.resolve_sa if plain else seed_cuda.resolve_sa
        rc_pos = resolve(dfm, torch.from_numpy(ranks).to(dfm.device)
                         ).cpu().numpy()
        trace.count("seed.resolved", ranks.size)
        trace.copied("h2d.resolve", ranks.nbytes, dfm.device)
        trace.copied("d2h.seed", rc_pos.nbytes, dfm.device)
    lens = ls[rep].astype(np.int64)
    # direct-extension hits carry a pre-resolved occurrence position
    # encoded as k0 = -(r_start+1) (always freq 1); the other ranks index
    # RC(P) occurrences, and the fwd+RC text is its own reverse complement,
    # so P occurs at the mirrored positions.
    r_pos = np.where(k0r < 0, -k0r - 1, dfm.seq_len - rc_pos - lens)
    return qs[rep].astype(np.int64), r_pos, lens


def find_seeds(dfm: DeviceFMIndex,
               query_codes: np.ndarray,
               min_seed_length: int = 15,
               max_seed_freq: int = 100,
               sensitive: bool = False,
               chunk: int = 10000,
               n_segments: int = 1,
               slack: int = 600,
               mesh=None,
               max_out_cap: Optional[int] = None,
               init12: bool = True,
               **kw):
    """Find all LMEM seeds of one query chromosome (see find_seeds_all;
    kw: its stats, plain, rounds and fm)."""
    return find_seeds_all(
        dfm, [query_codes], min_seed_length=min_seed_length,
        max_seed_freq=max_seed_freq, sensitive=sensitive, chunk=chunk,
        n_segments=n_segments, slack=slack, mesh=mesh,
        max_out_cap=max_out_cap, init12=init12, **kw)[0]
