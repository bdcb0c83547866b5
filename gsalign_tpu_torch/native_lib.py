"""Native (C++) kernel loading.

Builds this package's own native/sais.cpp and native/buildtools.cpp into
a shared library on first use (g++) and exposes it via ctypes. The library
goes into the package's build directory (_build/, git-ignored). Without a
compiler get_lib() returns None: the suffix array build then raises, and
the other helpers' callers take their numpy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libgsalign_native.so")
_SOURCES = ["sais.cpp", "buildtools.cpp"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    srcs = [os.path.join(_NATIVE_DIR, s) for s in _SOURCES]
    if os.path.exists(_LIB_PATH) and all(
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(s) for s in srcs):
        return True
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a private name and rename: concurrent processes (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp] + srcs
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        for bits, ct in ((32, ctypes.c_int32), (64, ctypes.c_int64)):
            fn = getattr(lib, f"sais_codes_i{bits}_mt")
            fn.restype = ctypes.c_int
            fn.argtypes = [
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), ct,
                np.ctypeslib.ndpointer(np.dtype(f"int{bits}"),
                                       flags="C_CONTIGUOUS"),
                ctypes.c_int]
        for suf, it in (("i32", np.int32), ("i64", np.int64)):
            fn = getattr(lib, f"par_gather_u16_{suf}")
            fn.restype = None
            fn.argtypes = [
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(it, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_int]
        lib.sais_marks.restype = ctypes.c_int64
        lib.sais_marks.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sais_marks_clear.restype = None
        lib.sais_marks_clear.argtypes = []
        lib.c8_counts.restype = None
        lib.c8_counts.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.block_counts_u8.restype = None
        lib.block_counts_u8.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.c12_counts.restype = None
        lib.c12_counts.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.ctx_gather_extract.restype = None
        lib.ctx_gather_extract.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.pack_2bit.restype = None
        lib.pack_2bit.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.seg_gather_u8.restype = None
        lib.seg_gather_u8.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        _i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.seg_mismatch_count.restype = None
        lib.seg_mismatch_count.argtypes = [
            _u8p, _u8p, _i64p, _i64p, _i64p, ctypes.c_int64, _i64p,
            ctypes.c_int]
        lib.seg_mismatch_fill.restype = None
        lib.seg_mismatch_fill.argtypes = [
            _u8p, _u8p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.maf_build_rows.restype = None
        lib.maf_build_rows.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int64, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        _i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.vcf_format.restype = ctypes.c_int64
        lib.vcf_format.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _i64p, _u8p, _i64p,
            ctypes.c_int64, _u8p, _u8p, _u8p, _i64p, _u8p, _u8p,
            ctypes.c_int64, ctypes.c_int]
        lib.outlier_bounds.restype = ctypes.c_int64
        lib.outlier_bounds.argtypes = [
            _i64p, _i64p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
            _i64p]
        _lib = lib
        return _lib


SAIS_PHASES = ("enter", "lms-placed", "induce1", "named", "mapped",
               "final-place", "done")


def sais_codes(codes: np.ndarray, threads: Optional[int] = None,
               wide: bool = False) -> Optional[np.ndarray]:
    """Suffix array of codes + 1 followed by the 0 sentinel (codes below
    127), built straight from `codes`: no copy of the text is made, so the
    build holds the SA, the codes and one byte of types a row. Returns
    len(codes) + 1 entries, int32 below 2^31 of them and int64 from there
    on or with `wide`; None without the library. Threaded: every SA-IS
    phase but the induction scans and the final placement runs per block
    (see native/sais.cpp)."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes, dtype=np.uint8)
    n = int(c.shape[0]) + 1
    bits = 64 if wide or n >= (1 << 31) else 32
    sa = np.empty(n, dtype=np.int32 if bits == 32 else np.int64)
    lib.sais_marks_clear()
    rc = getattr(lib, f"sais_codes_i{bits}_mt")(
        c, c.shape[0], sa, threads or default_threads())
    if rc != 0:
        raise RuntimeError(f"sais_codes_i{bits} failed: {rc}")
    return sa


def sais_marks() -> list:
    """The memory milestones of the last SA-IS build: [{"phase", "depth",
    "n", "peak_rss", "rss"}], bytes of this process, in the order the
    levels reached them (native/sais.cpp mark)."""
    lib = get_lib()
    if lib is None:
        return []
    m = int(lib.sais_marks(None, 0))
    out = np.zeros((max(m, 1), 5), dtype=np.int64)
    m = min(m, int(lib.sais_marks(out.ctypes.data, m)))
    return [{"phase": SAIS_PHASES[int(r[0])], "depth": int(r[1]),
             "n": int(r[2]), "peak_rss": int(r[3]), "rss": int(r[4])}
            for r in out[:m]]


def default_threads() -> int:
    return max(1, os.cpu_count() or 1)


def gather_u16(src: np.ndarray, idx: np.ndarray,
               threads: Optional[int] = None) -> Optional[np.ndarray]:
    """out[i] = src[idx[i]], multithreaded. None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint16)
    out = np.empty(idx.shape[0], dtype=np.uint16)
    nt = threads or default_threads()
    if idx.dtype == np.int32:
        lib.par_gather_u16_i32(src, np.ascontiguousarray(idx), out,
                               idx.shape[0], nt)
    else:
        lib.par_gather_u16_i64(
            src, np.ascontiguousarray(idx, dtype=np.int64), out,
            idx.shape[0], nt)
    return out


def c8_counts(text: np.ndarray,
              threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Order-8 key histogram over the 5^8 key space (see fmindex._build_c8)."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    counts = np.zeros(5 ** 8, dtype=np.int64)
    lib.c8_counts(t, t.shape[0], counts, threads or default_threads())
    return counts


def c12_counts(text: np.ndarray,
               threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Base-4 12-mer histogram over the 4^12 key space (fmindex._build_c12).

    Rolling-key wait: the per-thread 134 MB histograms bound threads."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    counts = np.zeros(4 ** 12, dtype=np.int64)
    nt = min(threads or default_threads(), 8)
    lib.c12_counts(t, t.shape[0], counts, nt)
    return counts


def ctx_gather_extract(text: np.ndarray, sa: np.ndarray, primary: int,
                       threads: Optional[int] = None, with_ctx: bool = True):
    """Fused context build + SA gather + symbol extraction (one parallel
    pass over the suffix array). Returns (g_ctx u16[n+1], t3 u8[n+1],
    bcodes u8[n]), or with with_ctx=False (t3, bcodes) and no g_ctx array;
    None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = int(t.shape[0])
    sa = np.ascontiguousarray(sa)
    is64 = 1 if sa.dtype == np.int64 else 0
    g_ctx = np.empty(n + 1, dtype=np.uint16) if with_ctx else None
    t3 = np.empty(n + 1, dtype=np.uint8)
    bcodes = np.empty(n, dtype=np.uint8)
    lib.ctx_gather_extract(t, n, sa.ctypes.data, is64, primary,
                           None if g_ctx is None else g_ctx.ctypes.data, t3,
                           bcodes, threads or default_threads())
    return (g_ctx, t3, bcodes) if with_ctx else (t3, bcodes)


def pack_2bit(codes: np.ndarray,
              threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Pack 0..3 codes into uint32 words (16/word, BWA bit order)."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(-(-c.shape[0] // 16), dtype=np.uint32)
    lib.pack_2bit(c, c.shape[0], out, threads or default_threads())
    return out


def seg_gather_u8(src: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  out: Optional[np.ndarray] = None,
                  offs: Optional[np.ndarray] = None,
                  threads: Optional[int] = None) -> Optional[np.ndarray]:
    """out = concat_i src[starts[i] : starts[i]+lens[i]], multithreaded.
    None if the lib is unavailable. `offs` (exclusive cumsum of lens, with
    the total appended) may be passed to skip recomputing it; `out` may be
    a preallocated buffer of the total size."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if offs is None:
        offs = np.concatenate([[0], np.cumsum(lens)])
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    if out is None:
        out = np.empty(int(offs[-1]), dtype=np.uint8)
    lib.seg_gather_u8(np.ascontiguousarray(src, dtype=np.uint8), starts,
                      lens, offs, starts.shape[0], out,
                      threads or default_threads())
    return out


def seg_mismatch(qry_codes: np.ndarray, ref_codes: np.ndarray,
                 q_starts: np.ndarray, r_starts: np.ndarray,
                 lens: np.ndarray, want_cols: bool = False,
                 threads: Optional[int] = None):
    """Per-segment mismatch counts (qc != 4 and qc != rc over NT4 codes,
    reference src/ProcessCandidateAlignment.cpp:49-61 /
    src/SeqVariant.cpp:56), threaded, no index materialization.

    Returns counts int64[k], or (counts, cols int32[total]) with
    want_cols (cols = per-mismatch column offsets, segment-major order).
    None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    q_starts = np.ascontiguousarray(q_starts, dtype=np.int64)
    r_starts = np.ascontiguousarray(r_starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    k = q_starts.shape[0]
    counts = np.empty(k, dtype=np.int64)
    qc = np.ascontiguousarray(qry_codes, dtype=np.uint8)
    rc = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    nt = threads or default_threads()
    lib.seg_mismatch_count(qc, rc, q_starts, r_starts, lens, k, counts, nt)
    if not want_cols:
        return counts
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cols = np.empty(int(offs[-1]), dtype=np.int32)
    lib.seg_mismatch_fill(qc, rc, q_starts, r_starts, lens, offs, k, cols,
                          nt)
    return counts, cols


def maf_build_rows(qry_chars: np.ndarray, ref_chars: np.ndarray,
                   q_pos: np.ndarray, r_pos: np.ndarray,
                   row_len: np.ndarray, offs: np.ndarray, cls: np.ndarray,
                   dp1, dp2, emit_len: int, rev: bool,
                   threads: Optional[int] = None,
                   out1: Optional[np.ndarray] = None,
                   out2: Optional[np.ndarray] = None):
    """Fused MAF/ALN row assembly for one block (see native maf_build_rows):
    one parallel pass emits both aligned rows with '-' counts, optionally
    reverse-complemented. dp1/dp2 are per-pair uint8 arrays (None for
    non-DP pairs; the caller must keep them alive and contiguous).
    out1/out2: optional pre-allocated uint8 buffers of capacity >=
    emit_len (buffer-pool reuse); the returned rows are slices of them.
    Returns (a1, a2, gaps1, gaps2) or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(q_pos.shape[0])
    p1 = (ctypes.c_void_p * n)()
    p2 = (ctypes.c_void_p * n)()
    keep = []                       # converted rows outlive the native call
    for j in np.nonzero(cls == 4)[0].tolist():
        a, b = dp1[j], dp2[j]
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            a = np.ascontiguousarray(a, dtype=np.uint8)
            keep.append(a)
        if b.dtype != np.uint8 or not b.flags.c_contiguous:
            b = np.ascontiguousarray(b, dtype=np.uint8)
            keep.append(b)
        p1[j] = a.ctypes.data
        p2[j] = b.ctypes.data
    a1 = out1[:emit_len] if out1 is not None \
        and out1.shape[0] >= emit_len else np.empty(emit_len, dtype=np.uint8)
    a2 = out2[:emit_len] if out2 is not None \
        and out2.shape[0] >= emit_len else np.empty(emit_len, dtype=np.uint8)
    gaps = np.zeros(2, dtype=np.int64)
    lib.maf_build_rows(
        qry_chars, ref_chars,
        np.ascontiguousarray(q_pos, dtype=np.int64),
        np.ascontiguousarray(r_pos, dtype=np.int64),
        np.ascontiguousarray(row_len, dtype=np.int64),
        np.ascontiguousarray(offs, dtype=np.int64),
        np.ascontiguousarray(cls, dtype=np.uint8), n, p1, p2,
        emit_len, 1 if rev else 0, a1, a2, gaps,
        threads or default_threads())
    return a1, a2, int(gaps[0]), int(gaps[1])


def block_counts(vals: np.ndarray, k: int,
                 threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Per-128-block counts of symbols 0..k-1 (values >= k ignored)."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vals, dtype=np.uint8)
    n_blocks = -(-v.shape[0] // 128)
    out = np.zeros((n_blocks, k), dtype=np.int64)
    lib.block_counts_u8(v, v.shape[0], k, out.reshape(-1),
                        threads or default_threads())
    return out


def vcf_format(order, chrs, pos, name_buf, name_off, n_snv, ref_c, alt_c,
               frag_buf, frag_off, types,
               threads: Optional[int] = None) -> Optional[bytes]:
    """Format the sorted VCF data lines natively (see native vcf_format):
    returns the body bytes or None when the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(order.shape[0])
    name_len = int((name_off[1:] - name_off[:-1]).max()) if \
        name_off.shape[0] > 1 else 0
    frag_total = int(frag_buf.shape[0])
    # per-line bound: name + fixed 18 + <= 19 pos digits + <= 10 type
    cap = n * (name_len + 64) + frag_total + 2 * int(n_snv)
    out = np.empty(cap, dtype=np.uint8)
    total = lib.vcf_format(
        n, np.ascontiguousarray(order, dtype=np.int64),
        np.ascontiguousarray(chrs, dtype=np.int32),
        np.ascontiguousarray(pos, dtype=np.int64),
        np.ascontiguousarray(name_buf, dtype=np.uint8),
        np.ascontiguousarray(name_off, dtype=np.int64),
        int(n_snv),
        np.ascontiguousarray(ref_c, dtype=np.uint8),
        np.ascontiguousarray(alt_c, dtype=np.uint8),
        np.ascontiguousarray(frag_buf, dtype=np.uint8),
        np.ascontiguousarray(frag_off, dtype=np.int64),
        np.ascontiguousarray(types, dtype=np.uint8),
        out, cap, threads or default_threads())
    if total < 0:
        return None
    return memoryview(out)[:total]


def outlier_bounds(cand_k, cand_qp, q_pos, u):
    """Native trigger walk for chain._outlier_pass: returns the interval
    bounds array (WITHOUT the trailing n), or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cand_k = np.ascontiguousarray(cand_k, dtype=np.int64)
    cand_qp = np.ascontiguousarray(cand_qp, dtype=np.int64)
    q_pos = np.ascontiguousarray(q_pos, dtype=np.int64)
    u = np.ascontiguousarray(u, dtype=np.int64)
    out = np.empty(cand_k.shape[0] + 2, dtype=np.int64)
    m = lib.outlier_bounds(cand_k, cand_qp, cand_k.shape[0],
                           q_pos, u, u.shape[0], out)
    return out[:m]
