"""FM-index: BWT + occ checkpoints + sampled suffix array.

Array layout designed for batched device rank queries (see ops/rank.py),
mirroring the semantics (not the bytes) of the reference index
(src/BWT_Index/bwtindex.c:53-75 interleaved layout, src/bwt_search.cpp:45-119
occ queries, src/BWT_Index/bwt.c:101-123 SA sampling):

- ``bwt_packed``: uint32 words, 16 bases/word, base k at bits ``(~k & 15)*2``
  (same within-word order as BWA so masks line up with the reference math).
- ``occ_cp``:    [n_blocks, 4] counts of each base in B'[0 : 128*b) — one
  checkpoint per 128-base block, gathered then refined by popcount.
- ``sa_samples``: SA_full[k] for k % sa_intv == 0 (rank space includes the
  sentinel row: sa_samples[0] == seq_len).
- ``l2``:        L2[c] = # of symbols < c in the text (L2[0]=0, L2[4]=seq_len).
- ``primary``:   rank of the full-text suffix (the $ row the BWT omits).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.suffix_array import build_suffix_array

OCC_INTERVAL = 128          # bases per checkpoint block
WORDS_PER_BLOCK = OCC_INTERVAL // 16


T3_BLOCK = 128              # order-3 symbols per T3 checkpoint block

# INIT jump order switches from 10 to 12 above this text length; it also
# decides whether the order-12 jump table is built (ops/rank.py reads it).
INIT12_MIN_SEQLEN = 64 * 2 ** 20


@dataclasses.dataclass
class FMIndex:
    seq_len: int                 # 2N (fwd + RC)
    primary: int
    l2: np.ndarray               # int64 [5]
    bwt_packed: np.ndarray       # uint32 [n_blocks * 8]
    occ_cp: np.ndarray           # int32/int64 [n_blocks, 4]
    sa_samples: np.ndarray       # int32/int64 [ceil((seq_len+1)/intv)]
    sa_intv: int
    genome: Optional[Genome] = None
    # order-3 (alphabet-64) BWT over ALL SA_full rows (no $-row removal, no
    # primary shift): T3[i] = the THREE bases preceding suffix SA[i]
    # (T[SA-3]*16 + T[SA-2]*4 + T[SA-1]). One rank query consumes three
    # query-genome bases; a fused row (64 class checkpoints + 128 packed
    # syms, 384 B) answers it with a single gather. Rows with SA < 3 are
    # exceptions (stored as 0; corrected at query time via t3_exc_*).
    t3_packed: Optional[np.ndarray] = None     # uint32 [n3_blocks*32], 8b/sym
    t3_cp: Optional[np.ndarray] = None         # int32 [n3_blocks, 64]
    c64: Optional[np.ndarray] = None           # int64 [65]
    t3_exc_pos: Optional[np.ndarray] = None    # int32 [3] ranks with SA < 3
    t3_exc_chr: Optional[np.ndarray] = None    # int32 [3] true prev char|-1
    # order-8 jump table: c8[g] = (SA interval start, size) of the suffix
    # block whose first 8 chars are 8-mer g. Seeding INIT consumes 8 query
    # bases with ZERO rank queries (an empty interval proves the local match
    # is < 8 < MinSeedLength, i.e. a miss — exactly the reference scan's
    # outcome, src/GSAlign.cpp:75-86).
    c8: Optional[np.ndarray] = None            # int64 [65536, 2]
    # order-12 jump table (same contract, 12 bases per INIT step; only
    # usable when MinSeedLength > 12 — a dead 12-mer must prove a miss)
    c12: Optional[np.ndarray] = None           # int64 [4^12, 2]

    @property
    def rank_dtype(self):
        return self.occ_cp.dtype


def pack_bwt_codes(bcodes: np.ndarray,
                   threads: Optional[int] = None) -> np.ndarray:
    """Pack base codes (uint8, 0..3) into uint32 words, 16/word, BWA bit order."""
    from gsalign_tpu_torch import native_lib
    out = native_lib.pack_2bit(bcodes, threads)
    if out is not None:
        return out
    n = bcodes.shape[0]
    n_words = -(-n // 16)
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = bcodes
    lanes = padded.reshape(n_words, 16)
    shifts = ((15 - np.arange(16)) * 2).astype(np.uint32)
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def build_fmindex(genome: Genome, sa_intv: Optional[int] = None,
                  prefer_device: bool = True,
                  sa_full: Optional[np.ndarray] = None,
                  force_wide: bool = False,
                  threads: Optional[int] = None,
                  on_phase: Optional[Callable[[str], None]] = None
                  ) -> FMIndex:
    """Build the FM-index over the genome's fwd+RC text.

    sa_intv None picks automatically: the FULL suffix array (interval 1 —
    occurrence resolution becomes a single gather, no LF walks, and the
    seed scan's direct-extension path activates) up to 640M text rows
    (~320 Mb genomes; SA 2.56 GB device-side, split out of comb_pairs
    above rank.SA_SPLIT_BYTES), else every-8th sampling.

    Texts with seq_len >= 2^31 (the reference handles these via 64-bit
    bwtint_t, src/BWT_Index/bwt.h:36-40) keep int64 checkpoints/SA; the
    device layout splits them into u32 low words + 2-bit carries (see
    ops/rank.DeviceFMIndex). force_wide builds that layout for small
    genomes too (test path). prefer_device lets the suffix array fall back
    to the torch build on the CUDA card where the native SA-IS library
    cannot be built (index/suffix_array.build_suffix_array).

    Host memory, in bytes a text row (the text is 1, the genome's forward
    codes 0.5): SA-IS holds the SA (8 for an int64 SA) and one byte of
    types; then everything that needs the SA (the t3 exception rows and
    among them the primary row, sa_samples, the C64 block starts, the
    order-3 symbols and the BWT) is taken before the SA is dropped, so the peak
    there is SA + sa_samples + t3 + BWT codes; the checkpoint tables come
    after. on_phase(name) is called at "sa-in", "sa", "gather", "tables"
    and "jump", as each part ends (a memory probe's hook)."""
    mark = on_phase or (lambda name: None)
    text = genome.codes_fwd_rc()
    n = int(text.shape[0])
    wide = force_wide or n >= (1 << 31)
    if sa_intv is None:
        sa_intv = 1 if (n <= 640_000_000 and not wide) else 8
    assert sa_intv & (sa_intv - 1) == 0, "sa_intv must be a power of two"
    cp_dtype = np.int64 if wide else np.int32
    mark("sa-in")
    if sa_full is None:
        sa_full = build_suffix_array(text, prefer_device=prefer_device,
                                     wide=wide)
    assert sa_full.shape[0] == n + 1 and sa_full[0] == n
    mark("sa")

    t3_exc_pos, t3_exc_chr, exc_rows = _t3_exceptions(
        sa_full, text, n, cp_dtype)
    # the row holding text position 0 is one of the exception rows
    primary = int(exc_rows[sa_full[exc_rows] == 0][0])
    sa_samples = sa_full[::sa_intv].astype(cp_dtype)
    c64 = _c64_starts(sa_full, text, n)
    # ONE random gather serves BWT extraction and the order-3 BWT: the
    # context (text[i-3..i-1], text[i..i+2]) of each SA row packed into 15
    # bits of a uint16 — prev chars are always 0..3 (2-bit fields, laid out
    # so the order-3 symbol is a single shift+mask), cur/next may be 4 = $
    # (3-bit fields). Out-of-range -> 0 on the left, 4 on the right. The
    # native path fuses context build + gather + symbol extraction in one
    # multithreaded pass and keeps no context array
    # (native/buildtools.cpp ctx_gather_extract).
    from gsalign_tpu_torch import native_lib
    fused = native_lib.ctx_gather_extract(text, sa_full, primary, threads,
                                          with_ctx=False)
    if fused is not None:
        t3, bcodes = fused
    else:
        ctx = np.zeros(n + 1, dtype=np.uint16)
        t16 = text.astype(np.uint16)
        ctx[3:] |= t16[:n - 2] << 13     # prev3
        ctx[2:] |= t16[:n - 1] << 11     # prev2
        ctx[1:] |= t16 << 9              # prev1
        ctx[:n] |= t16 << 6              # cur   (position n: cur = 4 = $)
        ctx[n] |= 4 << 6
        ctx[:n - 1] |= t16[1:] << 3      # nxt1
        ctx[n - 1:] |= np.uint16(4 << 3)
        ctx[:n - 2] |= t16[2:]           # nxt2
        ctx[n - 2:] |= np.uint16(4)
        g_ctx = ctx[sa_full]             # [n+1] — the only big gather
        del ctx, t16
        # order-3 symbol per row: bits 9..14 == prev3*16 + prev2*4 + prev1
        t3 = (g_ctx >> 9).astype(np.uint8)
        t3 &= 0x3F
        del g_ctx
        bcodes = (t3 & 3)[sa_full > 0]   # $-removed BWT (prev1 field)
    mark("gather")
    # this function's reference to the SA goes before anything else is
    # allocated (the array frees when the SA was built in here; a
    # caller-supplied sa_full stays alive on the caller's reference)
    sa_full = None
    t3[exc_rows] = 0

    # chunked: np.bincount internally casts its input to intp, an 8n-byte
    # transient
    counts = np.zeros(4, dtype=np.int64)
    for s in range(0, n, 1 << 28):
        counts += np.bincount(text[s:s + (1 << 28)], minlength=4)[:4]
    l2 = np.zeros(5, dtype=np.int64)
    l2[1:] = np.cumsum(counts)

    # occ checkpoints: exclusive cumulative per-char counts at block starts
    n_blocks = -(-n // OCC_INTERVAL)
    per_block = native_lib.block_counts(bcodes, 4, threads)
    if per_block is None:
        bpad = np.full(n_blocks * OCC_INTERVAL, 255, dtype=np.uint8)
        bpad[:n] = bcodes
        blk2d = bpad.reshape(n_blocks, OCC_INTERVAL)
        per_block = np.empty((n_blocks, 4), dtype=np.int64)
        for c in range(4):               # bool temp per char beats 8B ids
            per_block[:, c] = np.count_nonzero(blk2d == c, axis=1)
    occ_cp = np.zeros((n_blocks, 4), dtype=cp_dtype)
    np.cumsum(per_block[:n_blocks - 1], axis=0, out=occ_cp[1:])

    bwt_packed = pack_bwt_codes(bcodes)
    # pad packed words to whole blocks so rank gathers are unconditional
    want = n_blocks * WORDS_PER_BLOCK
    if bwt_packed.shape[0] < want:
        bwt_packed = np.concatenate(
            [bwt_packed, np.zeros(want - bwt_packed.shape[0], dtype=np.uint32)])
    del bcodes, per_block                # n bytes freed before the t3 build

    t3_packed, t3_cp = _build_t3_index(t3, n, cp_dtype, threads)
    del t3                               # n bytes freed before c8/c12
    mark("tables")
    c8 = _build_c8(text, n, threads)
    # The order-12 jump table only serves the INIT-12 device path, which
    # activates above INIT12_MIN_SEQLEN (ops/rank.py); below it the 268 MB
    # table (and its multi-MB sparse persistence) is pure build overhead —
    # the INIT-10 starts derive from a direct 4^10 histogram instead.
    c12 = _build_c12(text, n, threads) if n > INIT12_MIN_SEQLEN else None
    mark("jump")

    return FMIndex(
        seq_len=n, primary=primary, l2=l2, bwt_packed=bwt_packed,
        occ_cp=occ_cp, sa_samples=sa_samples, sa_intv=sa_intv, genome=genome,
        t3_packed=t3_packed, t3_cp=t3_cp, c64=c64,
        t3_exc_pos=t3_exc_pos, t3_exc_chr=t3_exc_chr, c8=c8, c12=c12,
    )


def _build_c8(text: np.ndarray, n: int,
              threads: Optional[int] = None) -> np.ndarray:
    """Order-8 jump table, built WITHOUT touching the suffix array.

    Suffix order coarsened to 8-char granularity equals the order of base-5
    keys over the first 8 chars with char c -> c+1 and a missing char (the
    $ row / short suffixes) -> 0 (the same argument as the C64 build above:
    $ sorts below every real char). So the start of 8-mer g's suffix block
    is #{rows with key < key(g)} and its size is #{rows with key == key(g)}
    — both read off an exclusive-cumsum'd bincount over the 5^8 key space.
    """
    from gsalign_tpu_torch import native_lib
    counts = native_lib.c8_counts(text[:n], threads)
    if counts is None:
        key = np.zeros(n + 1, dtype=np.int32)
        tp = text.astype(np.int32) + 1
        w = 1
        for j in range(7, -1, -1):       # key += (t[i+j]+1) * 5^(7-j)
            key[:n - j] += tp[j:] * w
            w *= 5
        counts = np.bincount(key, minlength=5 ** 8).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # map the 4^8 real 8-mers into the 5^8 key space; 8-mer id g stores its
    # FIRST char in the HIGH 2 bits (same convention as the C64 classes)
    g = np.arange(65536, dtype=np.int64)
    key8 = np.zeros(65536, dtype=np.int64)
    for p in range(8):                   # p = char position, 0 = first
        key8 += (((g >> (2 * (7 - p))) & 3) + 1) * 5 ** (7 - p)
    out = np.empty((65536, 2), dtype=np.int64)
    out[:, 0] = starts[key8]
    out[:, 1] = counts[key8]
    return out


def _build_c12(text: np.ndarray, n: int,
               threads: Optional[int] = None) -> np.ndarray:
    """Order-12 jump table over BASE-4 keys + short-suffix corrections.

    The 5^12 key space of the c8 construction would need a 2 GB histogram;
    base-4 keys over full 12-mers give the block SIZES directly, and the
    only rows base-4 misses are the <= 12 suffixes shorter than 12 chars
    (incl. the sentinel row). A short suffix S (k chars) sorts below a
    12-mer block g iff g >= S zero-padded ($ and missing chars sort below
    every real char), so each one is a +1 step function on the starts.
    """
    from gsalign_tpu_torch import native_lib
    n_keys = 4 ** 12
    counts = native_lib.c12_counts(text[:n], threads)
    if counts is None:
        if n >= 12:
            t = text.astype(np.int64)
            key = np.zeros(n - 11, dtype=np.int64)
            for j in range(12):
                key += t[j: n - 11 + j] << (2 * (11 - j))
            counts = np.bincount(key, minlength=n_keys)
        else:
            counts = np.zeros(n_keys, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for k in range(0, min(12, n + 1)):      # suffix of length k at n - k
        lb = 0
        for j in range(k):
            lb += int(text[n - k + j]) << (2 * (11 - j))
        starts[lb:] += 1
    out = np.empty((n_keys, 2), dtype=np.int64)
    out[:, 0] = starts
    out[:, 1] = counts
    return out


def c12_step_keys(c12: np.ndarray) -> np.ndarray:
    """Recover the short-suffix +1 step positions lb from a c12 table:
    starts = exclusive-cumsum(counts) + sum over steps of 1[lb <= g]
    (see _build_c12). The diff against the bare cumsum is a nondecreasing
    staircase with <= 12 unit steps; returns the lb of each step."""
    counts = c12[:, 1]
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    diff = c12[:, 0] - base
    n_steps = int(diff[-1]) if diff.size else 0
    return np.searchsorted(diff, np.arange(1, n_steps + 1),
                           side="left").astype(np.int64)


def _t3_exceptions(sa_full: np.ndarray, text: np.ndarray, n: int,
                   cp_dtype=np.int32):
    """The 3 t3 rows with SA in {0, 1, 2} (suffixes lacking a full 3-base
    left context): returns (t3_exc_pos, t3_exc_chr, rows-to-zero). Found
    by chunked scan (a whole-array nonzero materializes a 200 MB bool temp
    at 100 Mb). This is the ONLY t3-build consumer of the full SA."""
    rows = n + 1
    found = []
    CH = 1 << 24
    for s in range(0, rows, CH):
        hits = np.nonzero(sa_full[s:s + CH] < 3)[0]
        found.extend((hits + s).tolist())
        if len(found) >= 3:
            break
    small = np.asarray(found[:3], dtype=np.int64)
    t3_exc_pos = small.astype(cp_dtype)
    assert t3_exc_pos.shape[0] == 3
    sa_small = sa_full[small]
    t3_exc_chr = np.where(sa_small == 0, -1,
                          text[np.maximum(sa_small, 1) - 1]).astype(np.int32)
    return t3_exc_pos, t3_exc_chr, small


def _c64_starts(sa_full: np.ndarray, text: np.ndarray, n: int) -> np.ndarray:
    """C64[c]: rows sorting strictly below the suffix block whose first
    three chars are c (c = c0*16 + c1*4 + c2). The key coarsens suffix
    order to 3-char granularity with each char mapped to c+1 and a missing
    char (past the text's end: the $ row or a short suffix) to 0 — $ sorts
    below every real char, so key order matches suffix order and each block
    start is a bisection over the SA rows: 64 * log2(rows) reads of the SA
    and the text, no rows-sized array."""
    rows = n + 1
    cls = np.arange(64)
    qkeys = ((cls >> 4) + 1) * 25 + (((cls >> 2) & 3) + 1) * 5 + (cls & 3) + 1
    c64 = np.empty(65, dtype=np.int64)

    def key_at(i):
        p = int(sa_full[i])
        key = 0
        for j, w in ((0, 25), (1, 5), (2, 1)):
            if p + j < n:
                key += (int(text[p + j]) + 1) * w
        return key

    for ci in range(64):
        qk = int(qkeys[ci])
        lo, hi = 0, rows                 # first i with key_at(i) >= qk
        while lo < hi:
            mid = (lo + hi) // 2
            if key_at(mid) < qk:
                lo = mid + 1
            else:
                hi = mid
        c64[ci] = lo
    c64[64] = rows
    return c64


def _build_t3_index(t3: np.ndarray, n: int, cp_dtype=np.int32,
                    threads: Optional[int] = None):
    """Order-3 (alphabet-64) BWT over all SA_full rows: T3[i] = the three
    bases preceding suffix SA[i] as T[SA-3]*16 + T[SA-2]*4 + T[SA-1]. Rows
    with SA < 3 lack a full 3-base left context: stored as 0 and corrected
    at query time (class-0 subtraction for triple ranks; the true single
    preceding char, kept in t3_exc_chr, re-added for single-char ranks) —
    see _t3_exceptions, computed by the caller so the full SA can be freed
    before these tables allocate. One backward step with a triple symbol
    consumes three query bases — a third of the rank queries of the
    seeding scan vs single-char stepping.

    t3 is the order-3 symbol array gathered by the caller (see
    build_fmindex); returns (t3_packed, t3_cp). The C64 block starts come
    from _c64_starts.
    """
    rows = n + 1
    # per-block class checkpoints + 8-bit packed symbols (MSB-first in word)
    # -- built slab-wise: a single flat (block*64 + sym) id array is 8 bytes
    # per row, which at >2^31 rows dominated the build's memory footprint
    n3_blocks = rows // T3_BLOCK + 1
    # accumulate in the final dtype (counts cumsum to <= rows, which fits
    # cp_dtype by construction) — a separate int64 buffer + astype cost
    # seconds of page faults at 100 Mb scale
    t3_cp = np.zeros((n3_blocks + 1, 64), dtype=cp_dtype)
    from gsalign_tpu_torch import native_lib
    # windowed: one whole-range native call returns [n_blocks, 64] int64 —
    # ~25 GB of transients at 6.2 G rows (the 3 Gb config) — so the count
    # pass streams fixed windows of rows into t3_cp instead (the fixed-
    # memory-budget arithmetic of the reference's index build,
    # src/BWT_Index/bwt_gen.c:162-205, reborn); at most 2^22 rows (32 MB)
    # and a 32nd of the rows a window, so the transient stays under 0.125
    # bytes a row at any size, identical totals (windows align to blocks)
    CNT_WINDOW = 1 << max(16, min(22, (rows >> 5).bit_length() - 1))
    cnt_ok = native_lib.get_lib() is not None
    if cnt_ok:
        for s in range(0, rows, CNT_WINDOW):
            e = min(s + CNT_WINDOW, rows)
            cnt = native_lib.block_counts(t3[s:e], 64, threads)
            b0 = s >> 7
            t3_cp[b0 + 1: b0 + 1 + cnt.shape[0]] = cnt     # casts in place
    else:
        # small slabs keep each bincount's bin range (slab/128*64 ids)
        # inside L2 — the same bincount over one 2^27 slab is 36x slower
        # (cache-miss random increments across a ~100 MB bin array)
        SLAB = 1 << 18                  # rows per slab (multiple of 128)
        for s in range(0, rows, SLAB):
            e = min(s + SLAB, rows)
            b0 = s >> 7
            nb = ((e - 1) >> 7) - b0 + 1
            ids = np.repeat(np.arange(nb, dtype=np.int32) << 6, T3_BLOCK)
            ids = ids[:e - s]
            ids += t3[s:e]
            cnt = np.bincount(ids, minlength=nb * 64).reshape(nb, 64)
            # shifted: exclusive cumsum (cast: t3_cp may be int32)
            t3_cp[b0 + 1: b0 + 1 + nb] += cnt.astype(cp_dtype)
    # in place by slabs: a whole-array cumsum into its own input makes a
    # copy of it first (4 bytes a row for int64 checkpoints)
    carry = np.zeros(64, dtype=cp_dtype)
    for s in range(0, t3_cp.shape[0], 1 << 16):
        slab = t3_cp[s:s + (1 << 16)]
        slab[0] += carry
        np.cumsum(slab, axis=0, out=slab)
        carry = slab[-1].copy()
    t3_cp = np.ascontiguousarray(t3_cp[:n3_blocks])
    padded = np.zeros(n3_blocks * T3_BLOCK, dtype=np.uint8)
    padded[:rows] = t3
    # MSB-first 4x8-bit packing == the big-endian reading of each 4 bytes:
    # swapped in place (no second copy of the symbols)
    t3_packed = padded.view(">u4").view(np.uint32)
    if np.little_endian:
        t3_packed.byteswap(inplace=True)
    return t3_packed, t3_cp


# ---- host-side (numpy) reference queries, used by tests ----

def occ4_np(fm: FMIndex, k: int) -> np.ndarray:
    """Counts of each base in B'[0..k_adj] — mirrors bwt_occ4
    (src/bwt_search.cpp:69-86). k == -1 returns zeros."""
    if k == -1:
        return np.zeros(4, dtype=np.int64)
    ka = k - (1 if k >= fm.primary else 0)
    block = ka >> 7
    cnt = fm.occ_cp[block].astype(np.int64).copy()
    word0 = block * WORDS_PER_BLOCK
    widx = (ka >> 4) & 7
    words = fm.bwt_packed[word0: word0 + WORDS_PER_BLOCK]
    m_in_word = (ka & 15) + 1
    for j in range(WORDS_PER_BLOCK):
        if j > widx:
            break
        m = 16 if j < widx else m_in_word
        w = int(words[j])
        for pos in range(m):
            cnt[(w >> ((15 - pos) * 2)) & 3] += 1
    return cnt


def bwt_code_at_np(fm: FMIndex, x: int) -> int:
    w = int(fm.bwt_packed[x >> 4])
    return (w >> ((~x & 15) << 1)) & 3


def occ1_np(fm: FMIndex, k: int, c: int) -> int:
    """Single-char occ — mirrors bwt_occ (src/bwt_search.cpp:45-67)."""
    if k == fm.seq_len:
        return int(fm.l2[c + 1] - fm.l2[c])
    if k == -1:
        return 0
    return int(occ4_np(fm, k)[c])


def inv_psi_np(fm: FMIndex, k: int) -> int:
    """bwt_invPsi (src/bwt_search.cpp:121-127)."""
    x = k - (1 if k > fm.primary else 0)
    c = bwt_code_at_np(fm, x)
    x = int(fm.l2[c]) + occ1_np(fm, k, c)
    return 0 if k == fm.primary else x


def _t3_sym_np(fm: FMIndex, j: int) -> int:
    w = int(fm.t3_packed[j >> 2])
    return (w >> ((3 - (j & 3)) * 8)) & 0xFF


def rank64_np(fm: FMIndex, c: int, k: int) -> int:
    """# rows j in [0, k) with triple-symbol c (exceptions excluded)."""
    block = k // T3_BLOCK
    cnt = int(fm.t3_cp[block, c])
    for j in range(block * T3_BLOCK, k):
        if _t3_sym_np(fm, j) == c:
            cnt += 1
    if c == 0:
        cnt -= int((fm.t3_exc_pos < k).sum())
    return cnt


def rank1_t3_np(fm: FMIndex, c: int, k: int) -> int:
    """# rows j in [0, k) whose true preceding char is c, via the T3 table
    (sym & 3 == c plus the SA<3 exception corrections)."""
    block = k // T3_BLOCK
    cnt = int(fm.t3_cp[block].reshape(16, 4)[:, c].sum())
    for j in range(block * T3_BLOCK, k):
        if _t3_sym_np(fm, j) & 3 == c:
            cnt += 1
    for pos, ch in zip(fm.t3_exc_pos, fm.t3_exc_chr):
        if pos < k:
            if c == 0:
                cnt -= 1           # stored sym 0 wrongly counted
            if ch == c:
                cnt += 1           # true preceding char
    return cnt


def extend_rc_t3_np(fm: FMIndex, ik1: int, ik2: int, b1: int, b2: int,
                    b3: int):
    """Append bases (b1, b2, b3) to P by backward-extending RC(P) with the
    triple (comp(b3), comp(b2), comp(b1)). Returns (new_ik1, new_ik2)."""
    c = (3 - b3) * 16 + (3 - b2) * 4 + (3 - b1)
    lo = rank64_np(fm, c, ik1)
    hi = rank64_np(fm, c, ik1 + ik2)
    return int(fm.c64[c]) + lo, hi - lo


def extend_rc_single_np(fm: FMIndex, ik1: int, ik2: int, b1: int):
    """Append one base to P via the T3 table's single-char ranks."""
    c = 3 - b1
    lo = rank1_t3_np(fm, c, ik1)
    hi = rank1_t3_np(fm, c, ik1 + ik2)
    return int(fm.l2[c]) + 1 + lo, hi - lo


def sa_lookup_np(fm: FMIndex, k: int) -> int:
    """bwt_sa (src/bwt_search.cpp:129-139): LF-walk to a sampled rank."""
    sa = 0
    mask = fm.sa_intv - 1
    while k & mask:
        sa += 1
        k = inv_psi_np(fm, k)
    return (sa + int(fm.sa_samples[k // fm.sa_intv])) % (fm.seq_len + 1)
