"""FM-index rank tables on a torch device, and the rank queries of the scan.

DeviceFMIndex.from_host lays out, array by array, the same tables as the
JAX package's ops/rank.DeviceFMIndex.from_host: the single-char rank rows,
the fused order-3 rows, the class-pair table with the INIT jump rows and
the INIT short-suffix corrections; then either (full suffix array,
"direct") the overlapping text windows and the 1024-padded suffix array,
or (sampled suffix array) the SA samples, which resolve_sa reaches by LF
walks. The tables of 32-bit words (union, t3, t3_major, text_rows) are
torch.int32 tensors that hold the words' bit patterns: torch has no usable
uint32 arithmetic, so the plain rank queries widen what they have gathered
to int64 (`& M32`) before any bit arithmetic, and the kernels
(csrc/seed.cu) read the words as they are. Values the JAX package keeps in
int64 stay int64.

Two row layouts, as in the JAX package:
  narrow (seq_len < 2^31): a 64-word t3 row [32 words of u16 minor
    checkpoints | 32 symbol words] plus a major checkpoint row every 256
    rows; comb_pairs packs (lo | sz << 32) in one word a class row.
  wide (seq_len >= 2^31, or force_wide): a 100-word t3 row [64 u32 low
    checkpoints | 4 words of 2-bit carries (checkpoint bits 32-33) | 32
    symbol words], no major rows; comb_pairs is flattened into planes
    [c8 lo | class lo | c8 sz | class sz | INIT starts | seq_len + 1]; the
    SA samples are int64. A wide index is never direct.
lf_t3 and resolve_sa here are the plain torch versions of the resolve_sa
kernel (ops/seed_cuda.py).

Row-sharded tables (parallel/mesh.shard_index_rows): t3 and sa_samples cut
into equal row blocks, one a mesh entry (RowShards), the other tables whole
on the first entry's device. Every read of those two tables goes through
t3_row_fetch and plane_fetch: a masked local gather per block, summed over
the blocks, as the JAX package's _t3_row_fetch and _plane_fetch gather and
psum over the mesh.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from gsalign_tpu_torch.index.fmindex import (FMIndex, INIT12_MIN_SEQLEN,
                                             WORDS_PER_BLOCK)
from gsalign_tpu_torch.ops import layout_cuda
from gsalign_tpu_torch.utils import trace
from gsalign_tpu_torch.utils.device import resolve_device

UNION_ROW = 16   # uint32 words per row of the single-char rank table
T3_ROW_WIDE = 100  # wide t3 rows: 64 low checkpoints, 4 carry words, 32 syms
# comb_pairs layout: rows [0, 65536) INIT-8, then 136 class rows (triple
# INIT, single INIT, triple EXT, single EXT), then the INIT-order rows
INIT_OFF = 65536 + 136
# wide (flattened) comb_pairs: the sz plane starts at COMB_HALF, the INIT
# starts at INIT_OFF_WIDE (one entry a k-mer, and seq_len + 1 after them)
COMB_HALF = 65536 + 136
INIT_OFF_WIDE = 2 * COMB_HALF
WIDE_SLAB = 1 << 22   # t3 rows laid out at a time on a wide index
SA_ROW_BLOCK = 1024   # sa_rows is padded to a multiple of this many entries
M32 = 0xFFFFFFFF
# the tables of 32-bit words, torch.int32 on the device
WORD_TABLES = ("union", "t3", "t3_major", "text_rows")
# held while from_host lays out an index's tables, so that threads asking
# for the same tables at once lay them out once
_TABLES_LOCK = threading.Lock()


def widen(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held as int32 bit patterns -> their values in int64."""
    return words.to(torch.int64) & M32


def comb_rows(order: int) -> int:
    """Total comb_pairs rows for an INIT order."""
    return INIT_OFF + 4 ** order


@dataclasses.dataclass(frozen=True)
class RowShards:
    """A table's rows cut into equal blocks, one a mesh entry, each on its
    entry's device; the last is zero-padded. Row r is row r % rows of block
    r // rows."""
    blocks: tuple             # torch.Tensor [rows, ...] each
    rows: int


@dataclasses.dataclass(frozen=True)
class DeviceFMIndex:
    """Device rank tables (see the JAX package's DeviceFMIndex for the
    layout of each). Every tensor lives on `device`."""
    union: torch.Tensor       # int32 [n_rows, 16] (uint32 words); wide [1, 16]
    t3: torch.Tensor          # int32 [n3_rows, 64] | wide [n3_rows, 100]
    t3_major: torch.Tensor    # int32 [ceil(n3/256), 64]; wide [1, 64]
    l2: torch.Tensor          # int64 [5]
    c64: torch.Tensor         # int64 [65]
    t3_exc_pos: torch.Tensor  # int64 [3]
    t3_exc_chr: torch.Tensor  # int64 [3]
    comb_pairs: torch.Tensor  # int64 [comb_rows(init_order)] | wide planes
    init_corr: torch.Tensor   # int64 [12], padded with -1
    # direct (full SA) indexes: the text windows and the suffix array;
    # [1, 1] and [1] dummies for the others
    text_rows: torch.Tensor   # int32 [ceil(2N/1024), 128] (uint32 words)
    sa_rows: torch.Tensor     # int32 [pad1024(seq_len+1)]
    # the others: SA_full[k] for k % sa_intv == 0; [1] dummy if direct
    sa_samples: torch.Tensor  # int32 (wide: int64) [ceil((seq_len+1)/intv)]
    host_sa: Optional[np.ndarray]   # full SA on the host (None if not direct)
    seq_len: int
    primary: int
    init_order: int           # INIT jump k-mer order (10 or 12)
    sa_intv: int
    direct_ok: bool           # full SA: direct extension, host hit expansion
    wide: bool                # wide row layout (module docstring)
    # row-sharded tables: {field: RowShards}; the field itself then holds
    # no rows, so that no read can miss the blocks
    row_shards: Optional[dict] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    @property
    def device(self) -> torch.device:
        return self.t3.device

    @staticmethod
    def host_tables(fm: FMIndex, card_init10: bool = False) -> dict:
        """The tables as numpy arrays, in the JAX package's dtypes. An
        index without its genome lays out every table that does not need
        the text, with direct mode off (as the JAX package does); a table
        that needs the text then raises.

        card_init10: where the INIT-10 rows would come from the host's
        histogram of the text (a narrow index of INIT order 10 without a
        c12 table), leave them out: comb_pairs then ends at INIT_OFF, and
        "init10" holds what the card needs to build them (with_init10): the
        step keys and, on an index without text rows, the packed text."""
        wide = fm.rank_dtype == np.int64
        text = []            # the genome's text, made at its first use

        def need_text(what):
            if fm.genome is None:
                raise ValueError(f"{what} needs the index's genome (the "
                                 f"index carries none)")
            if not text:
                text.append(fm.genome.codes_fwd_rc())
            return text[0]
        direct_ok = fm.sa_intv == 1 and not wide and fm.genome is not None
        if wide:
            union = np.zeros((1, UNION_ROW), dtype=np.uint32)
            major3 = np.zeros((1, 64), dtype=np.int32)
            rows3 = _wide_rows(fm.t3_cp, fm.t3_packed)
        else:
            n3 = fm.t3_cp.shape[0]
            n1 = fm.occ_cp.shape[0]
            union = np.zeros((n1, UNION_ROW), dtype=np.uint32)
            union[:, :4] = fm.occ_cp.astype(np.int32).view(
                np.uint32).reshape(n1, 4)
            union[:, 4:12] = fm.bwt_packed.reshape(n1, WORDS_PER_BLOCK)
            cp3 = fm.t3_cp.astype(np.int32)                  # [n3, 64]
            major3 = np.ascontiguousarray(cp3[::256])        # [n3/256, 64]
            minor = (cp3 - major3[np.arange(n3) >> 8]).astype(np.uint32)
            rows3 = np.empty((n3, 64), dtype=np.uint32)
            rows3[:, :32] = minor[:, 0::2] | (minor[:, 1::2] << 16)
            rows3[:, 32:] = fm.t3_packed.reshape(n3, 32)

        lut = np.zeros((136, 2), dtype=np.int64)
        c64 = np.asarray(fm.c64, dtype=np.int64)
        l2 = np.asarray(fm.l2, dtype=np.int64)
        lut[0:64, 0] = c64[:64]
        lut[0:64, 1] = c64[1:65] - c64[:64]
        for c in range(4):
            lut[64 + c] = (l2[3 - c] + 1, l2[c + 1] - l2[c])
            lut[132 + c, 0] = l2[c] + 1
        lut[68:132, 0] = c64[:64]

        if direct_ok:
            from gsalign_tpu_torch.index.fmindex import pack_bwt_codes
            # four overlapping 512-base windows (own 16 words + 256-base
            # lookahead) per row: row r >> 2, quarter r & 3 = words
            # [16r, 16r+32)
            n_rows_t = -(-fm.seq_len // 256)
            n4 = -(-n_rows_t // 4)
            padded = np.zeros((n4 * 4 + 1) * 256, dtype=np.uint8)
            padded[:fm.seq_len] = need_text("direct mode's text rows")
            pk = pack_bwt_codes(padded).reshape(n4 * 4 + 1, 16)
            text_rows = np.concatenate([pk[:-1], pk[1:]],
                                       axis=1).reshape(n4, 128)
        else:
            text_rows = np.zeros((1, 1), dtype=np.uint32)

        c8 = fm.c8
        if c8 is None:                     # pre-v4 in-memory index
            from gsalign_tpu_torch.index.fmindex import _build_c8
            c8 = _build_c8(need_text("the order-8 jump table"), fm.seq_len)
        init_order = 12 if fm.seq_len > INIT12_MIN_SEQLEN else 10
        if init_order == 12:
            c12 = fm.c12
            if c12 is None:                # small index: c12 never built
                from gsalign_tpu_torch.index.fmindex import _build_c12
                c12 = _build_c12(need_text("the order-12 jump table"),
                                 fm.seq_len)
            starts_init = c12[:, 0]
            from gsalign_tpu_torch.index.fmindex import c12_step_keys
            steps = c12_step_keys(c12)     # lb values of the +1 steps
        elif fm.c12 is not None:           # big index carries c12: reuse
            starts_init, steps = _derive_c10(
                fm.c12[:, 1], need_text("the order-10 jump table"),
                fm.seq_len)
        elif card_init10 and not wide:     # small index: on the card
            text10 = need_text("the order-10 jump table")
            starts_init, steps = None, _c10_steps(text10, fm.seq_len)
        else:                              # small index: direct histogram
            starts_init, steps = _build_c10(
                need_text("the order-10 jump table"), fm.seq_len)
        corr = np.full(12, -1, dtype=np.int64)
        # a step at lb bumps starts[lb:], i.e. block lb-1's naive size;
        # lb == 0 only shifts the whole table (no block affected)
        keys = steps[steps > 0] - 1
        corr[:keys.shape[0]] = keys
        init10 = None
        if starts_init is None:            # the INIT rows: on the card
            init10 = {"steps": steps, "words": None if direct_ok
                      else _text_words(text10)}
            starts_ext = np.zeros(1, np.int64)  # lo and sz end at INIT_OFF
        else:
            starts_ext = np.concatenate(
                [starts_init, np.asarray([fm.seq_len + 1], np.int64)])
        if wide:
            # values exceed 32 bits: flattened lo and sz planes
            comb = np.concatenate([c8[:, 0], lut[:, 0], c8[:, 1], lut[:, 1],
                                   starts_ext]).astype(np.int64)
        else:
            lo = np.concatenate([c8[:, 0], lut[:, 0], starts_ext[:-1]])
            sz = np.concatenate([c8[:, 1], lut[:, 1], starts_ext[1:]])
            comb = (lo.astype(np.uint64)
                    | (sz.astype(np.uint64) << np.uint64(32))).view(np.int64)
        n_sa = fm.sa_samples.shape[0]
        if direct_ok:
            sa_rows = np.zeros(-(-n_sa // SA_ROW_BLOCK) * SA_ROW_BLOCK,
                               dtype=np.int32)
            sa_rows[:n_sa] = fm.sa_samples
            sa_samples = np.zeros(1, dtype=np.int32)
        else:
            sa_rows = np.zeros(1, dtype=np.int32)
            sa_samples = np.asarray(fm.sa_samples,
                                    dtype=np.int64 if wide else np.int32)
        tabs = dict(union=union, t3=rows3, t3_major=major3,
                    l2=l2, c64=c64,
                    t3_exc_pos=np.asarray(fm.t3_exc_pos, dtype=np.int64),
                    t3_exc_chr=np.asarray(fm.t3_exc_chr, dtype=np.int64),
                    comb_pairs=comb, init_corr=corr, text_rows=text_rows,
                    sa_rows=sa_rows, sa_samples=sa_samples,
                    init_order=init_order, sa_intv=int(fm.sa_intv),
                    direct_ok=direct_ok, wide=wide)
        if init10 is not None:
            tabs["init10"] = init10
        return tabs

    @staticmethod
    def from_host(fm: FMIndex, device=None) -> "DeviceFMIndex":
        """Build the tables on the host and put them on `device` (None:
        the CUDA card, an error without one; "cpu": the CPU).

        The tables are laid out once per index and device and kept on the
        FMIndex (as the JAX package keeps its own): a later call for the
        same `fm` and device returns the same DeviceFMIndex. The layout
        runs under a lock, so threads that ask at once lay it out once.

        On a card, the INIT-10 rows of a narrow index of INIT order 10
        without a c12 table are built there (with_init10), after the
        upload, in order on the current stream; the host does not wait."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with _TABLES_LOCK:
            cache = fm.__dict__.setdefault("_device_tables", {})
            dfm = cache.get(str(dev))
            if dfm is not None:
                trace.count("layout.cache_hits")
                return dfm
            trace.count("layout.builds")
            with trace.span("layout.host_tables"):
                tabs = DeviceFMIndex.host_tables(
                    fm, card_init10=dev.type == "cuda")
            with trace.span("layout.upload"):
                dfm = DeviceFMIndex.from_tables(
                    tabs, host_sa=np.asarray(fm.sa_samples)
                    if tabs["direct_ok"] else None, seq_len=fm.seq_len,
                    primary=fm.primary, device=dev)
            if "init10" in tabs:
                with trace.span("layout.init10"):
                    dfm = with_init10(dfm, tabs["init10"])
                trace.count("layout.init10_card")
            cache[str(dev)] = dfm
        return dfm

    @staticmethod
    def from_tables(tabs: dict, host_sa: Optional[np.ndarray], seq_len: int,
                    primary: int, device=None) -> "DeviceFMIndex":
        """Upload numpy tables: WORD_TABLES (uint32 or int32) as int32 bit
        patterns, the SA planes as int32 (a wide index's SA samples as
        int64), the rest as int64. host_sa is the full suffix array of a
        direct index, None for the others. device as in from_host."""
        dev = resolve_device(device)
        wide = bool(tabs["wide"])

        def up(name, dtype=torch.int64):
            a = np.ascontiguousarray(tabs[name])
            if name in WORD_TABLES:
                if a.dtype not in (np.uint32, np.int32):
                    raise TypeError(f"{name} must hold 32-bit words, got "
                                    f"{a.dtype}")
                a, dtype = a.view(np.int32), torch.int32
            trace.copied("h2d.layout", a.size * dtype.itemsize, dev)
            return torch.tensor(a, dtype=dtype, device=dev)

        return DeviceFMIndex(
            union=up("union"), t3=up("t3"), t3_major=up("t3_major"),
            l2=up("l2"), c64=up("c64"), t3_exc_pos=up("t3_exc_pos"),
            t3_exc_chr=up("t3_exc_chr"), comb_pairs=up("comb_pairs"),
            init_corr=up("init_corr"), text_rows=up("text_rows"),
            sa_rows=up("sa_rows", torch.int32),
            sa_samples=up("sa_samples",
                          torch.int64 if wide else torch.int32),
            host_sa=host_sa, seq_len=int(seq_len), primary=int(primary),
            init_order=int(tabs["init_order"]), sa_intv=int(tabs["sa_intv"]),
            direct_ok=bool(tabs["direct_ok"]), wide=wide)


def with_init10(dfm: DeviceFMIndex, init10: dict,
                launch=None) -> DeviceFMIndex:
    """dfm, whose comb_pairs ends at INIT_OFF (host_tables with
    card_init10), with the INIT-10 rows built on its device after them by
    `launch` (layout_cuda.init10_rows; a test passes a host build's launch)
    from the packed text: text_rows on a direct index, else init10's words,
    uploaded here (h2d.layout)."""
    dev = dfm.device
    if dfm.direct_ok:
        text, stride = dfm.text_rows.view(-1), 32
    else:
        words = init10["words"].view(np.int32)
        trace.copied("h2d.layout", words.nbytes, dev)
        text, stride = torch.tensor(words, device=dev), 16
    comb = torch.empty(comb_rows(10), dtype=torch.int64, device=dev)
    comb[:INIT_OFF] = dfm.comb_pairs
    (launch or layout_cuda.init10_rows)(text, stride, dfm.seq_len,
                                        init10["steps"], comb[INIT_OFF:])
    return dataclasses.replace(dfm, comb_pairs=comb)


def _text_words(text: np.ndarray) -> np.ndarray:
    """The text's packed words (pack_bwt_codes) and a zero word after them,
    which the INIT-10 kernel reads beside the last."""
    from gsalign_tpu_torch.index.fmindex import pack_bwt_codes
    return np.concatenate([pack_bwt_codes(text), np.zeros(1, np.uint32)])


def _wide_rows(t3_cp: np.ndarray, t3_packed: np.ndarray) -> np.ndarray:
    """The wide t3 rows [n3, 100] uint32: the low 32 bits of the 64 class
    checkpoints, their bits 32-33 (class j in word 64 + (j >> 4), at bit
    2 (j & 15)), the 32 symbol words. Laid out WIDE_SLAB rows at a time:
    whole-table temporaries ran the JAX package's 3 Gb run out of memory."""
    n3 = t3_cp.shape[0]
    rows3 = np.empty((n3, T3_ROW_WIDE), dtype=np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    t3p = t3_packed.reshape(n3, 32)
    for s in range(0, n3, WIDE_SLAB):
        e = min(s + WIDE_SLAB, n3)
        cp = t3_cp[s:e]
        rows3[s:e, :64] = (cp & M32).astype(np.uint32)
        carry = ((cp >> 32) & 3).astype(np.uint32).reshape(e - s, 4, 16)
        rows3[s:e, 64:68] = np.bitwise_or.reduce(carry << shifts, axis=2)
        rows3[s:e, 68:] = t3p[s:e]
    return rows3


def tables_from_jax(jdfm) -> dict:
    """The JAX package's DeviceFMIndex arrays as numpy, keyed like
    DeviceFMIndex.host_tables (for the parity tests)."""
    out = {f: np.asarray(getattr(jdfm, f))
           for f in ("union", "t3", "t3_major", "l2", "c64", "t3_exc_pos",
                     "t3_exc_chr", "comb_pairs", "init_corr", "text_rows",
                     "sa_rows", "sa_samples")}
    out["init_order"] = int(jdfm.init_order)
    out["sa_intv"] = int(jdfm.sa_intv)
    out["direct_ok"] = bool(jdfm.direct_ok)
    out["wide"] = bool(jdfm.wide)
    return out


def _derive_c10(counts12: np.ndarray, text: np.ndarray, n: int):
    """ORDER-10 INIT jump starts from the stored order-12 counts.

    12-mer keys put the FIRST char in the high bits (fmindex._build_c12),
    so the low 20 bits of key12(p) are the 10-mer at p+2: summing the
    counts over the 16 high-bit values counts every 10-mer except the two
    at p in {0, 1}, added back from the text. Returns (starts[4^10] int64,
    step lbs int64[<=10])."""
    nk = 4 ** 10
    counts10 = np.ascontiguousarray(counts12.reshape(16, nk)).sum(
        axis=0, dtype=np.int64)
    for p in (0, 1):
        if n - 10 >= p:
            key = 0
            for j in range(10):
                key = (key << 2) | int(text[p + j])
            counts10[key] += 1
    return _c10_from_counts(counts10, text, n)


def _build_c10(text: np.ndarray, n: int):
    """ORDER-10 INIT jump starts straight from the text (indexes that never
    built a c12 table): one vectorized 4^10 histogram."""
    nk = 4 ** 10
    if n >= 10:
        t = text.astype(np.int64)
        key = np.zeros(n - 9, dtype=np.int64)
        for j in range(10):
            key += t[j: n - 9 + j] << (2 * (9 - j))
        counts10 = np.bincount(key, minlength=nk)
    else:
        counts10 = np.zeros(nk, dtype=np.int64)
    return _c10_from_counts(counts10, text, n)


def _c10_from_counts(counts10: np.ndarray, text: np.ndarray, n: int):
    nk = 4 ** 10
    starts10 = np.zeros(nk, dtype=np.int64)
    np.cumsum(counts10[:-1], out=starts10[1:])
    steps = _c10_steps(text, n)
    for lb in steps:
        starts10[lb:] += 1
    return starts10, steps


def _c10_steps(text: np.ndarray, n: int) -> np.ndarray:
    """The keys lb of the text's suffixes shorter than 10 bases, padded
    with A, shortest first: each is a +1 on the INIT-10 starts[lb:]."""
    steps = []
    for k in range(0, min(10, n + 1)):     # suffix of length k at n - k
        lb = 0
        for j in range(k):
            lb += int(text[n - k + j]) << (2 * (9 - j))
        steps.append(lb)
    return np.asarray(steps, dtype=np.int64)


# ---- rank queries (torch, int64 lanes) ----

_LOW = 0x55555555

# base-selection masks per in-block offset (ka & 127): _MASK_TABLE[o, j]
# keeps the first-`limit` bases of word j for a query ending at offset o
_mt = np.zeros((128, WORDS_PER_BLOCK), dtype=np.int64)
for _o in range(128):
    _widx, _m = _o >> 4, (_o & 15) + 1
    for _j in range(WORDS_PER_BLOCK):
        _limit = 16 if _j < _widx else (_m if _j == _widx else 0)
        _mt[_o, _j] = 0 if _limit == 0 else \
            (0xFFFFFFFF << (32 - 2 * _limit)) & 0xFFFFFFFF
_MASK_TABLE = _mt
del _mt


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _fetch(dfm: DeviceFMIndex, field: str, idx: torch.Tensor,
           col: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table[idx] (table[idx, col] with col) of one of the index's tables,
    on idx's device. A row-sharded table: each block gathers the rows it
    owns, zero for the others, and the blocks' results are summed."""
    shards = dfm.row_shards.get(field) if dfm.row_shards else None
    if shards is None:
        table = getattr(dfm, field)
        return table[idx] if col is None else table[idx, col]
    out = None
    for s, blk in enumerate(shards.blocks):
        loc = idx - s * shards.rows
        ok = (loc >= 0) & (loc < shards.rows)
        at = loc.clamp(0, shards.rows - 1).to(blk.device)
        v = (blk[at] if col is None else blk[at, col.to(blk.device)]
             ).to(idx.device)
        v = torch.where(ok.view(ok.shape + (1,) * (v.dim() - ok.dim())), v,
                        0)
        out = v if out is None else out + v
    return out


def t3_row_fetch(dfm: DeviceFMIndex, idx: torch.Tensor) -> torch.Tensor:
    """dfm.t3[idx], row-shard-aware (int32 [n, 64] | [n, 100])."""
    return _fetch(dfm, "t3", idx)


def plane_fetch(dfm: DeviceFMIndex, field: str,
                idx: torch.Tensor) -> torch.Tensor:
    """A 1-D table's entries at idx, row-shard-aware."""
    return _fetch(dfm, field, idx)


def occ4(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Counts of each base in B'[0..k_adj] (bwt_occ4,
    src/bwt_search.cpp:69-86), batched. k int64 [B] (-1 -> 0). [B, 4]."""
    valid = k >= 0
    ka = k - (k >= dfm.primary).to(k.dtype)
    ka_safe = ka.clamp(min=0)
    row = widen(dfm.union[ka_safe >> 7])                     # [B, 16]
    cp = row[:, :4]
    words = row[:, 4:12]
    base_mask = torch.from_numpy(_MASK_TABLE).to(k.device)[ka_safe & 127]
    hi = (words >> 1) & _LOW
    lo = words & _LOW
    mask_lo = base_mask & _LOW
    c3 = popcount32(hi & lo & mask_lo).sum(1)
    c2 = popcount32(hi & (lo ^ _LOW) & mask_lo).sum(1)
    c1 = popcount32((hi ^ _LOW) & lo & mask_lo).sum(1)
    c0 = popcount32(mask_lo).sum(1) - c1 - c2 - c3
    cnt = cp + torch.stack([c0, c1, c2, c3], dim=1)
    return torch.where(valid[:, None], cnt, 0)


def sym_offset(dfm: DeviceFMIndex) -> int:
    """The first symbol word of a t3 row."""
    return T3_ROW_WIDE - 32 if dfm.wide else 32


def occ_t3(dfm: DeviceFMIndex, k: torch.Tensor, is_triple: torch.Tensor,
           cls: torch.Tensor) -> torch.Tensor:
    """Per-lane single-class STRICT rank over the order-3 table.

    triple mode (is_triple True): # of 8-bit symbols == cls in T3[0, k)
      (cls in [0, 64)), with the SA<3 exception rows subtracted from class 0.
    single mode: # of rows in [0, k) whose true preceding char is cls
      (cls in [0, 4)) — sym & 3 plus exception corrections."""
    dev = k.device
    row = widen(t3_row_fetch(dfm, k >> 7))             # [B, 64] | [B, 100]
    B = row.shape[0]
    if dfm.wide:
        # u32 low words plus their 2-bit carries at bit 32, in int64
        cw = row[:, 64:68]
        carry = (cw[:, :, None] >> (2 * torch.arange(16, device=dev))
                 [None, None, :]) & 3                   # [B, 4, 16]
        cp = row[:, :64] + (carry.reshape(B, 64) << 32)
    else:
        mrow = dfm.t3_major[k >> 15].to(torch.int64)         # [B, 64]
        packed = row[:, :32]
        cp = mrow + torch.stack([packed & 0xFFFF, packed >> 16],
                                dim=2).reshape(B, 64)
    iota = torch.arange(64, device=dev)[None, :]
    want = torch.where(is_triple[:, None], iota == cls[:, None],
                       (iota & 3) == cls[:, None])
    cp_sel = torch.where(want, cp, 0).sum(1)
    words = row[:, sym_offset(dfm):]
    j32 = torch.arange(32, device=dev)[None, :]
    keep = ((k & 127)[:, None] - 4 * j32).clamp(0, 4)
    mask = torch.where(keep == 0, 0,
                       (torch.full_like(keep, M32)
                        << (32 - 8 * keep).clamp(0, 31)) & M32)
    x = words ^ (cls[:, None] * 0x01010101)
    # per-byte zero detect (all sym values < 0x40, so bits 6..7 are clean)
    s = x | (x >> 4)
    s = s | (s >> 2)
    s = s | (s >> 1)
    eq_t = ~s & 0x01010101
    x2 = x & 0x03030303
    eq_s = ~(x2 | (x2 >> 1)) & 0x01010101
    eq = torch.where(is_triple[:, None], eq_t, eq_s) & mask
    # bytes hold 0/1: the byte sum lands in bits 24..31 of eq * 0x01010101
    cnt = (((eq * 0x01010101) >> 24) & 0xFF).sum(1)
    below = dfm.t3_exc_pos[None, :] < k[:, None]             # [B, 3]
    nbelow = below.sum(1)
    chr_match = (below & (dfm.t3_exc_chr[None, :] == cls[:, None])).sum(1)
    zero_cls = (cls == 0).to(torch.int64)
    corr = torch.where(is_triple, -zero_cls * nbelow,
                       -zero_cls * nbelow + chr_match)
    return cp_sel + cnt + corr


def extend_rc(dfm: DeviceFMIndex, ik1: torch.Tensor, ik2: torch.Tensor,
              nt: torch.Tensor):
    """Forward extension tracking ONLY the RC interval (ik1, size ik2):
    appending base nt to P = backward-extending RC(P) with comp(nt).
    Returns (nik1, nik2)."""
    B = ik1.shape[0]
    both = occ4(dfm, torch.cat([ik1 - 1, ik1 - 1 + ik2]))
    c = (3 - nt)[:, None]
    tk = both[:B].gather(1, c)[:, 0]
    tl = both[B:].gather(1, c)[:, 0]
    return dfm.l2[c[:, 0]] + 1 + tk, tl - tk


def init_interval(dfm: DeviceFMIndex, p: torch.Tensor):
    """Initial bi-interval for a single base p (src/bwt_search.cpp:149-152)."""
    return (dfm.l2[p] + 1, dfm.l2[3 - p] + 1, dfm.l2[p + 1] - dfm.l2[p])


def lf_t3(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Batched LF mapping over SA_full rank space via the order-3 table:
    the rank whose suffix is one position to the left (bwt_invPsi
    semantics, src/bwt_search.cpp:121-127). LF(k) = L2[c] + 1 +
    strict_rank1(c, k) for c the char preceding row k's suffix; the SA == 0
    row maps to the sentinel row 0. k int64 [B]."""
    inb = k & 127
    w = widen(_fetch(dfm, "t3", k >> 7, sym_offset(dfm) + (inb >> 2)))
    c = (w >> ((3 - (inb & 3)) * 8)) & 3
    # rows with SA < 3 store sym 0: fix the char. The SA == 0 row (the
    # primary) has none (its t3_exc_chr is -1, stored as 255 by the index
    # build) and maps to row 0 below.
    for i in range(3):
        c = torch.where((k == dfm.t3_exc_pos[i]) & (k != dfm.primary),
                        dfm.t3_exc_chr[i], c)
    rank = occ_t3(dfm, k, torch.zeros_like(k, dtype=torch.bool), c)
    out = dfm.l2[c] + 1 + rank
    return torch.where(k == dfm.primary, 0, out)


def sa_table(dfm: DeviceFMIndex) -> torch.Tensor:
    """The SA plane that resolve_sa reads: every row (direct, int32) or
    every sa_intv-th row (int32; int64 on a wide index)."""
    return dfm.sa_rows if dfm.direct_ok else dfm.sa_samples


def resolve_sa(dfm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Batched bwt_sa (src/bwt_search.cpp:129-139), plain torch: LF-walk
    each rank to the nearest sampled one (k % sa_intv == 0), then add the
    stored SA value, mod seq_len + 1. k int64 [B] -> int64 [B]. With a
    full SA it is one gather."""
    mask = dfm.sa_intv - 1
    steps = torch.zeros_like(k)
    while True:
        active = (k & mask) != 0
        if not bool(active.any()):
            break
        k = torch.where(active, lf_t3(dfm, k), k)
        steps = steps + active.to(steps.dtype)
    at = k >> (dfm.sa_intv.bit_length() - 1)
    base = (dfm.sa_rows[at] if dfm.direct_ok
            else plane_fetch(dfm, "sa_samples", at)).to(k.dtype)
    return (steps + base) % (dfm.seq_len + 1)
