"""The port's native (C++) build helpers (gsalign_tpu_torch/native_lib.py)
against their numpy formulations and against the JAX package's
native_lib on the same inputs: tests/test_native_buildtools.py's cases for
every helper the port carries, and the suffix array and the order-12
histogram beside them."""

import numpy as np
import pytest

from gsalign_tpu import native_lib as jax_native
from gsalign_tpu_torch import native_lib

pytestmark = pytest.mark.skipif(
    native_lib.get_lib() is None or jax_native.get_lib() is None,
    reason="native library unavailable")


def both(name, *args, **kw):
    """The port's helper `name` on the inputs, after checking that the JAX
    package's gives the same arrays."""
    got = getattr(native_lib, name)(*args, **kw)
    want = getattr(jax_native, name)(*args, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got


def test_gather_u16():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 2**16, 10_000).astype(np.uint16)
    for dt in (np.int32, np.int64):
        idx = rng.integers(0, src.shape[0], 50_000).astype(dt)
        out = both("gather_u16", src, idx, threads=3)
        assert np.array_equal(out, src[idx])


def test_c8_counts_matches_numpy_keys():
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, 3000).astype(np.uint8)
    n = text.shape[0]
    key = np.zeros(n + 1, dtype=np.int64)
    tp = text.astype(np.int64) + 1
    w = 1
    for j in range(7, -1, -1):
        key[:n - j] += tp[j:] * w
        w *= 5
    expect = np.bincount(key, minlength=5 ** 8)
    assert np.array_equal(both("c8_counts", text, threads=4), expect)


def test_c12_counts_matches_numpy_keys():
    rng = np.random.default_rng(6)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    n = text.shape[0]
    t = text.astype(np.int64)
    key = np.zeros(n - 11, dtype=np.int64)
    for j in range(12):
        key += t[j: n - 11 + j] << (2 * (11 - j))
    expect = np.bincount(key, minlength=4 ** 12)
    assert np.array_equal(both("c12_counts", text, threads=3), expect)


@pytest.mark.parametrize("k", [4, 64])
def test_block_counts(k):
    rng = np.random.default_rng(2)
    vals = rng.integers(0, k, 5000).astype(np.uint8)
    vals[::7] = 255          # ignored (>= K)
    got = both("block_counts", vals, k, threads=3)
    n_blocks = -(-vals.shape[0] // 128)
    expect = np.zeros((n_blocks, k), dtype=np.int64)
    for b in range(n_blocks):
        blk = vals[b * 128:(b + 1) * 128]
        for c in range(k):
            expect[b, c] = int((blk == c).sum())
    assert np.array_equal(got, expect)


@pytest.mark.parametrize("sa_dtype", [np.int32, np.int64])
def test_ctx_gather_extract_matches_numpy(sa_dtype):
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 4000).astype(np.uint8)
    n = text.shape[0]
    # the numpy formulation (build_fmindex's path without the library)
    ctx = np.zeros(n + 1, dtype=np.uint16)
    t16 = text.astype(np.uint16)
    ctx[3:] |= t16[:n - 2] << 13
    ctx[2:] |= t16[:n - 1] << 11
    ctx[1:] |= t16 << 9
    ctx[:n] |= t16 << 6
    ctx[n] |= 4 << 6
    ctx[:n - 1] |= t16[1:] << 3
    ctx[n - 1:] |= np.uint16(4 << 3)
    ctx[:n - 2] |= t16[2:]
    ctx[n - 2:] |= np.uint16(4)
    sa = rng.permutation(n + 1).astype(sa_dtype)
    primary = int(np.nonzero(sa == 0)[0][0])
    g_expect = ctx[sa]
    t3_expect = ((g_expect >> 9) & 0x3F).astype(np.uint8)
    b_expect = (t3_expect & 3)[sa > 0]
    g, t3, b = both("ctx_gather_extract", text, sa, primary, threads=3)
    assert np.array_equal(g, g_expect)
    assert np.array_equal(t3, t3_expect)
    assert np.array_equal(b, b_expect)
    # the port's form without the context array (build_fmindex's call)
    t3_only, b_only = native_lib.ctx_gather_extract(text, sa, primary,
                                                    threads=3, with_ctx=False)
    assert np.array_equal(t3_only, t3_expect)
    assert np.array_equal(b_only, b_expect)


def test_pack_2bit():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 1003).astype(np.uint8)
    got = both("pack_2bit", codes, threads=2)
    n_words = -(-codes.shape[0] // 16)
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:codes.shape[0]] = codes
    lanes = padded.reshape(n_words, 16)
    shifts = ((15 - np.arange(16)) * 2).astype(np.uint32)
    expect = np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)
    assert np.array_equal(got, expect)


def test_seg_gather_u8():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 255, 10_000).astype(np.uint8)
    starts = rng.integers(0, 9000, 300).astype(np.int64)
    lens = rng.integers(0, 900, 300).astype(np.int64)
    lens = np.minimum(lens, 10_000 - starts)
    got = both("seg_gather_u8", src, starts, lens, threads=3)
    expect = np.concatenate([src[s:s + le] for s, le in zip(starts, lens)])
    assert np.array_equal(got, expect)


def test_seg_gather_u8_dest_offsets():
    src = np.arange(100, dtype=np.uint8)
    outs = []
    for lib in (native_lib, jax_native):
        out = np.full(20, 255, dtype=np.uint8)
        lib.seg_gather_u8(src, np.asarray([10, 50]), np.asarray([5, 5]),
                          out=out, offs=np.asarray([2, 12]))
        outs.append(out)
    out = outs[0]
    assert np.array_equal(out[2:7], src[10:15])
    assert np.array_equal(out[12:17], src[50:55])
    assert out[0] == 255 and out[7] == 255
    assert np.array_equal(outs[0], outs[1])


def test_sais_matches_sorted_suffixes():
    """SA-IS over a sentinel-terminated text against the suffixes sorted
    in Python, in both packages: the JAX package's reads the text, the
    port's the codes (text - 1, the sentinel implied)."""
    rng = np.random.default_rng(8)
    t = np.concatenate([rng.integers(1, 5, 2000), [0]]).astype(np.uint8)
    expect = sorted(range(len(t)), key=lambda i: bytes(t[i:]))
    want = jax_native.sais(t, threads=2)
    assert want.tolist() == expect
    got = native_lib.sais_codes(t[:-1] - 1, threads=2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
