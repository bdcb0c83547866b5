"""The seed step's cost probes (csrc/probe.cu) and their wrappers:
instruments, on no align path.

    seedcost      B lanes take K iterations of one of six bodies over the
                  real index tables, each body the one before plus one
                  piece of the seed scan's step: the port of the loops of
                  the JAX package's tools/exp_seedcost.py (PIECES). A warp a
                  lane, on the scan's own device functions
                  (csrc/seed_core.cuh). Plain version: seedcost_plain.
    gather_sweep  K dependent random reads a lane of one int32 table, or of
                  two at the same index: the loops of the JAX package's
                  tools/exp_sweep.py. Plain version: gather_sweep_plain.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches its kernel or raises (no fallback), and counts its launches in
`.launches`. The plain versions repeat the JAX tools' arithmetic in torch
ops (int32 state that wraps, floor modulo, index clamps) and are held
against both the JAX tools (tests/test_torch_seedcost.py,
tests/test_torch_sweep.py) and the kernels (on a card).

The JAX tool's body 5 does not trace as written on a narrow index: it
stores a + cnt, an int64 sum, into its int32 out_k0 carry. Here, as in the
tests' JAX composition, the plane keeps the sum's low 32 bits (its
astype). Bodies 4 and 5 read text rows, which only a direct (full-SA,
narrow) index has; on any other the JAX tool fails there, and here they
raise ValueError.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gsalign_tpu_torch.ops import cuda_build, seed_cuda, seeding
from gsalign_tpu_torch.ops import rank as rank_ops
from gsalign_tpu_torch.ops.rank import M32, widen

# the JAX tool's lines, piece by piece
PIECES = ("floor", "+qrows+meta16", "+comb gather", "+occ_t3",
          "+text+cmp256", "+emit planes")
TEXT_PIECES = (4, 5)      # the pieces that read text rows

_vp, _ll = ctypes.c_void_p, ctypes.c_longlong
_ip = ctypes.POINTER(ctypes.c_int)


class _SeedcostArgs(ctypes.Structure):
    """csrc/probe.cu SeedcostArgs, field for field."""
    _fields_ = [("s", seed_cuda._SeedArgs)] + [(n, _vp) for n in (
        "acc", "chk", "out_meta", "out_k0", "out_fr", "out_n")] + [
            (n, _ll) for n in ("B", "K", "max_out", "look_mod", "k2_mod",
                               "text_mod", "comb_len")]


class _SweepArgs(ctypes.Structure):
    """csrc/probe.cu SweepArgs, field for field."""
    _fields_ = [(n, _vp) for n in ("ta", "tb", "idx0", "acc", "idx")] + [
        (n, _ll) for n in ("B", "K", "n")]


SIGNATURES = {
    "gsalign_seedcost": [ctypes.POINTER(_SeedcostArgs), _ll, _vp],
    "gsalign_gather_sweep": [ctypes.POINTER(_SweepArgs), _vp],
    "gsalign_seedcost_occupancy": [_ll, _ll, _ip, _ip],
    "gsalign_gather_sweep_occupancy": [_ll, _ip, _ip]}


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/probe.cu."""
    return cuda_build.bind("probe", SIGNATURES)


@dataclasses.dataclass
class SeedcostOut:
    """A seedcost run's results, int32 unless stated: acc [B]; chk [B]
    (the uint32 checksum's bits); out_meta, out_k0 [B, max_out] and out_fr
    (int8) [B, max_out], the piece-5 planes, zero where nothing was
    written (and for every other piece); out_n [B], piece 5's records."""
    acc: torch.Tensor
    chk: torch.Tensor
    out_meta: torch.Tensor
    out_k0: torch.Tensor
    out_fr: torch.Tensor
    out_n: torch.Tensor

    @staticmethod
    def zeros(B: int, max_out: int, device) -> "SeedcostOut":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return SeedcostOut(z(B), z(B), z(B, max_out), z(B, max_out),
                           z(B, max_out, dtype=torch.int8), z(B))


def mods(dfm, q_rows: torch.Tensor) -> dict:
    """The tool's moduli: of the look sequence over the query rows, of the
    rank positions over the text, of the text compare's position over the
    text rows."""
    return {"look_mod": q_rows.shape[0] * 256 - 600,
            "k2_mod": dfm.seq_len - 300,
            "text_mod": dfm.text_rows.shape[0] * 256 - 600}


def _check(dfm, q_rows: torch.Tensor, piece: int, B: int, K: int,
           max_out: int) -> None:
    if piece not in range(len(PIECES)):
        raise ValueError(f"piece must be 0..{len(PIECES) - 1}, got {piece}")
    if piece in TEXT_PIECES and not dfm.direct_ok:
        raise ValueError(f"piece {piece} reads text rows: it needs a direct "
                         f"(full-SA, narrow) index")
    if q_rows.dim() != 2 or q_rows.shape[1] != 64 or \
            q_rows.dtype != torch.int32:
        raise ValueError(f"q_rows must be int32 [R, 64], got "
                         f"{q_rows.dtype} {tuple(q_rows.shape)}")
    if B < 0 or K < 0 or max_out < 1:
        raise ValueError(f"B {B}, K {K}, max_out {max_out}")
    md = mods(dfm, q_rows)
    used = [md["look_mod"], md["k2_mod"]] + (
        [md["text_mod"]] if piece in TEXT_PIECES else [])
    if not all(0 < m < 1 << 31 for m in used):
        # the tool's int32 arithmetic: too short, or past int32
        raise ValueError(f"the probe's moduli must lie in [1, 2^31): {md}")


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to the int32 with the same low 32 bits, in int64."""
    return ((x + 0x80000000) & M32) - 0x80000000


def seedcost_plain(dfm, q_rows: torch.Tensor, piece: int, B: int, K: int,
                   max_out: int, reads: dict = None) -> SeedcostOut:
    """The plain torch version of seedcost: the JAX tool's body `piece`
    (tools/exp_seedcost.py:82-200) K times over B lanes. With `reads`, it
    appends each iteration's table rows to reads[table] (q_rows, comb,
    t3, t3_major, text_rows), the rows the body reads."""
    def read(table, rows):
        if reads is not None:
            reads.setdefault(table, []).append(rows)
    _check(dfm, q_rows, piece, B, K, max_out)
    dev = q_rows.device
    md = mods(dfm, q_rows)
    out = SeedcostOut.zeros(B, max_out, dev)
    acc = torch.zeros(B, dtype=torch.int64, device=dev)
    chk = torch.zeros_like(acc)
    out_n = torch.zeros_like(acc)
    lane = torch.arange(B, device=dev)
    idx = _i32(lane * 9973) % md["look_mod"]
    rows = widen(q_rows)
    comb = dfm.comb_pairs
    j16 = 16 * torch.arange(16, device=dev)[None, :]
    init_mask = (1 << (2 * dfm.init_order)) - 1
    for k in range(K):
        look = _i32(idx + 7 * k) % md["look_mod"]
        if piece == 0:
            acc += look
            continue
        qrow, off = rows[look >> 8], look & 255
        read("q_rows", look >> 8)
        cls12, _, b1ok, _, _ = seeding._meta16(qrow, off)
        qw = seeding._words_at(qrow[:, :32], off, 16)        # [B, 16]
        chk += qw.sum(1)
        if piece == 1:
            acc += cls12 + b1ok.to(torch.int64)
            continue
        # the tool's offsets on either layout: the narrow INIT rows, and the
        # pair of an INIT-8 row COMB_HALF past it
        ia = torch.where(b1ok, rank_ops.INIT_OFF + (cls12 & init_mask),
                         cls12 & 0xFFFF)
        ib = torch.where(b1ok, ia + 1, ia + rank_ops.COMB_HALF)
        last = comb.shape[0] - 1
        va, vb = comb[ia.clamp(max=last)], comb[ib.clamp(max=last)]
        read("comb", torch.cat([ia, ib]).clamp(max=last))
        acc += _i32(vb - va)
        if piece == 2:
            continue
        k2 = look % md["k2_mod"]
        cnt = rank_ops.occ_t3(dfm, torch.cat([k2, k2 + 100]),
                              torch.ones(2 * B, dtype=torch.bool, device=dev),
                              torch.cat([cls12 & 63] * 2))
        tk, tl = cnt[:B], cnt[B:]
        read("t3", torch.cat([k2, k2 + 100]) >> 7)
        if not dfm.wide:
            read("t3_major", torch.cat([k2, k2 + 100]) >> 15)
        chk += tl
        acc += tk
        if piece == 3:
            continue
        p = _i32(look * 3) % md["text_mod"]
        trow = widen(dfm.text_rows[p >> 8])
        read("text_rows", p >> 8)
        x = seeding._words_at(trow[:, :32], p & 255, 16) ^ qw
        mm = (x | (x >> 1)) & 0x55555555
        cand = torch.where(mm == 0, 4096, j16 + (seeding._clz32(mm) >> 1))
        run = cand.min(1).values.clamp(max=256)
        acc += run
        if piece == 5:
            do = (run & 7) == 0
            at = lane[do], out_n[do].clamp(max=max_out - 1)
            out.out_meta[at] = cls12[do].to(torch.int32)
            out.out_k0[at] = _i32(va + tk)[do].to(torch.int32)
            out.out_fr[at] = (((run[do] + 128) & 255) - 128).to(torch.int8)
            out_n += do.to(torch.int64)
    out.acc = _i32(acc).to(torch.int32)
    out.chk = _i32(chk).to(torch.int32)
    out.out_n = out_n.to(torch.int32)
    return out


def seedcost_args(dfm, q_rows: torch.Tensor, B: int, K: int, max_out: int,
                  out: SeedcostOut) -> _SeedcostArgs:
    """The argument struct of seedcost, after checking every tensor."""
    dev = q_rows.device
    i32, i64 = torch.int32, torch.int64
    if seed_cuda.sharded(dfm):
        raise ValueError("seedcost reads whole tables, not row blocks")
    tables = seed_cuda._SeedArgs(
        q_rows=seed_cuda._ptr(q_rows, i32, dev, "q_rows"),
        t3=seed_cuda._ptr(dfm.t3, i32, dev, "t3"),
        t3_major=seed_cuda._ptr(dfm.t3_major, i32, dev, "t3_major"),
        t3_exc_pos=seed_cuda._ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
        t3_exc_chr=seed_cuda._ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
        comb_pairs=seed_cuda._ptr(dfm.comb_pairs, i64, dev, "comb_pairs"),
        init_corr=seed_cuda._ptr(dfm.init_corr, i64, dev, "init_corr"),
        text_rows=seed_cuda._ptr(dfm.text_rows, i32, dev, "text_rows"),
        order=dfm.init_order, seq_len=dfm.seq_len, wide=int(dfm.wide),
        comb_half=rank_ops.COMB_HALF if dfm.wide else 0)
    for name, t, shape in (("acc", out.acc, (B,)), ("chk", out.chk, (B,)),
                           ("out_n", out.out_n, (B,)),
                           ("out_meta", out.out_meta, (B, max_out)),
                           ("out_k0", out.out_k0, (B, max_out)),
                           ("out_fr", out.out_fr, (B, max_out))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return _SeedcostArgs(
        s=tables, acc=seed_cuda._ptr(out.acc, i32, dev, "acc"),
        chk=seed_cuda._ptr(out.chk, i32, dev, "chk"),
        out_meta=seed_cuda._ptr(out.out_meta, i32, dev, "out_meta"),
        out_k0=seed_cuda._ptr(out.out_k0, i32, dev, "out_k0"),
        out_fr=seed_cuda._ptr(out.out_fr, torch.int8, dev, "out_fr"),
        out_n=seed_cuda._ptr(out.out_n, i32, dev, "out_n"),
        B=B, K=K, max_out=max_out, comb_len=dfm.comb_pairs.shape[0],
        **mods(dfm, q_rows))


def seedcost_launch(lib, stream, dfm, q_rows: torch.Tensor, piece: int,
                    B: int, K: int, max_out: int,
                    out: SeedcostOut) -> None:
    """One seedcost launch through `lib` (the card's library, or a host
    build of probe.cu) on `stream`, into `out`; raises on an error code."""
    _check(dfm, q_rows, piece, B, K, max_out)
    args = seedcost_args(dfm, q_rows, B, K, max_out, out)
    cuda_build.raise_on(lib.gsalign_seedcost(ctypes.byref(args), piece,
                                             stream), "seedcost")


def seedcost(dfm, q_rows: torch.Tensor, piece: int, B: int, K: int,
             max_out: int, out: SeedcostOut = None) -> SeedcostOut:
    """Kernel seedcost: the tool's body `piece` K times over B lanes (see
    seedcost_plain), into `out` (new zeroed tensors if None; a launch
    writes acc, chk and out_n whole and the planes where it records)."""
    dev = q_rows.device
    if dev.type == "cpu":
        return seedcost_plain(dfm, q_rows, piece, B, K, max_out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if out is None:
        out = SeedcostOut.zeros(B, max_out, dev)
    seedcost_launch(build(), cuda_build.stream(dev), dfm, q_rows, piece, B,
                    K, max_out, out)
    if B:
        cuda_build.count(seedcost)
    return out


seedcost.launches = 0


def sweep_start(B: int, n: int, device=None) -> torch.Tensor:
    """The JAX tool's start indices: (i * 2654435761) mod n, int32 [B]."""
    i = torch.arange(B, dtype=torch.int64, device=device)
    return ((i * 2654435761) % n).to(torch.int32)


def _check_sweep(ta, tb, idx0, K, n):
    for name, t in (("ta", ta), ("tb", tb), ("idx0", idx0)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 vector")
        if t.device != idx0.device:
            raise ValueError(f"{name} is on {t.device}, not {idx0.device}")
    if tb is not None and tb.shape != ta.shape:
        raise ValueError("the two tables differ in length")
    if not 0 < n <= min(ta.shape[0], (1 << 31) - 1) or K < 0:
        raise ValueError(f"n {n} (table {ta.shape[0]}), K {K}")
    if idx0.numel() and not bool(((idx0 >= 0) & (idx0 < n)).all()):
        raise ValueError("start indices must lie in [0, n)")


def gather_sweep_plain(ta: torch.Tensor, tb, idx0: torch.Tensor, K: int,
                       n: int, reads: list = None):
    """The plain torch version of gather_sweep: the JAX tool's loop body
    (tools/exp_sweep.py:46-49, or :63-66 with two tables) K times. Returns
    (acc, last index), int32 [B] each. With `reads`, it appends each
    iteration's indices (read in each table)."""
    _check_sweep(ta, tb, idx0, K, n)
    idx = idx0.to(torch.int64)
    acc = torch.zeros_like(idx)
    for _ in range(K):
        if reads is not None:
            reads.append(idx)
        v = ta[idx].to(torch.int64)
        if tb is not None:
            v = _i32(v + tb[idx])
        idx = _i32(idx * 5 + v) % n
        acc += v
    return _i32(acc).to(torch.int32), idx.to(torch.int32)


def gather_sweep_launch(lib, stream, ta, tb, idx0, K: int, n: int):
    """One gather_sweep launch through `lib` on `stream`; returns (acc,
    last index) as gather_sweep_plain does."""
    _check_sweep(ta, tb, idx0, K, n)
    dev = idx0.device
    acc, idx = torch.empty_like(idx0), torch.empty_like(idx0)
    i32 = torch.int32
    args = _SweepArgs(ta=seed_cuda._ptr(ta, i32, dev, "ta"),
                      tb=seed_cuda._ptr(tb, i32, dev, "tb"),
                      idx0=seed_cuda._ptr(idx0, i32, dev, "idx0"),
                      acc=seed_cuda._ptr(acc, i32, dev, "acc"),
                      idx=seed_cuda._ptr(idx, i32, dev, "idx"),
                      B=idx0.shape[0], K=K, n=n)
    cuda_build.raise_on(lib.gsalign_gather_sweep(ctypes.byref(args), stream),
                        "gather_sweep")
    return acc, idx


def gather_sweep(ta: torch.Tensor, tb, idx0: torch.Tensor, K: int, n: int):
    """Kernel gather_sweep: a thread a lane, K dependent reads of ta (and
    tb at the same index), idx = (5 idx + v) mod n. Returns (acc, last
    index), int32 [B] each."""
    dev = idx0.device
    if dev.type == "cpu":
        return gather_sweep_plain(ta, tb, idx0, K, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    res = gather_sweep_launch(build(), cuda_build.stream(dev), ta, tb, idx0,
                              K, n)
    if idx0.numel():
        cuda_build.count(gather_sweep)
    return res


gather_sweep.launches = 0


def _reading(fn, *args) -> dict:
    regs, warps = ctypes.c_int(0), ctypes.c_int(0)
    cuda_build.raise_on(fn(*args, ctypes.byref(regs), ctypes.byref(warps)),
                        "occupancy query")
    return {"regs": regs.value, "warps_per_sm": warps.value}


def occupancy(wide: bool, chunk: int) -> dict:
    """What the compiler and the card make of each probe instance and of
    seed_scan (on lanes of `chunk` bases): {name: {regs, warps_per_sm}},
    registers a thread (cudaFuncGetAttributes) and warps an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Needs the card."""
    lib = build()
    out = {}
    for piece in range(len(PIECES)):
        if wide and piece in TEXT_PIECES:
            continue
        out[f"seedcost{piece}"] = _reading(lib.gsalign_seedcost_occupancy,
                                           piece, int(wide))
    for two in (0, 1):
        out[f"gather_sweep{'2' if two else '1'}"] = _reading(
            lib.gsalign_gather_sweep_occupancy, two)
    out["seed_scan"] = _reading(seed_cuda.build().gsalign_seed_scan_occupancy,
                                int(wide), seed_cuda._win_words(chunk))
    return out
