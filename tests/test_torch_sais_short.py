"""The port's SA-IS (gsalign_tpu_torch/native/sais.cpp through
native_lib.sais_codes) on short and degenerate texts, against the port's
numpy prefix doubling (index/suffix_array.build_suffix_array_np): every
0..3 text of 0 to 6 symbols, so n <= 2 and every shape of a short text;
texts whose only LMS suffix is the sentinel (strictly rising or falling
codes, runs of one symbol); short periodic texts. Each family at both
widths (int32 and int64) and on 1 and 4 threads. A suffix array is
unique, so every comparison is array equality. Seconds in all."""

import itertools

import numpy as np
import pytest

from gsalign_tpu.index import suffix_array as jsa
from gsalign_tpu_torch import native_lib
from gsalign_tpu_torch.index.suffix_array import build_suffix_array_np

pytestmark = pytest.mark.skipif(native_lib.get_lib() is None,
                                reason="native library unavailable")


def every_short_text() -> list:
    """Every 0..3 text of 0 to 6 symbols: 5,461 texts."""
    return [np.asarray(p, dtype=np.uint8) for n in range(7)
            for p in itertools.product(range(4), repeat=n)]


def no_lms_texts() -> list:
    """Texts in which no position but the sentinel's starts an LMS suffix:
    codes that only rise or only fall, and runs of one symbol."""
    out = [np.asarray(t, dtype=np.uint8) for t in
           ([0, 1, 2, 3], [3, 2, 1, 0], [0, 1], [3, 2], [1, 2, 3],
            [0, 0, 1, 1, 2, 2, 3, 3], [3, 3, 2, 2, 1, 1, 0, 0])]
    out += [np.full(n, c, dtype=np.uint8) for c in range(4)
            for n in (1, 2, 3, 7, 64, 1000)]
    return out


def periodic_texts() -> list:
    """Short units repeated: every unit of 1 to 4 symbols, 2 to 9 times."""
    units = [np.asarray(p, dtype=np.uint8) for n in range(1, 5)
             for p in itertools.product(range(4), repeat=n)]
    return [np.tile(u, r) for u in units for r in (2, 3, 5, 9)]


FAMILIES = {"every_short_text": every_short_text, "no_lms": no_lms_texts,
            "periodic": periodic_texts}


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_short_texts_match_prefix_doubling(family, wide, threads):
    texts = FAMILIES[family]()
    for codes in texts:
        got = native_lib.sais_codes(codes, threads=threads, wide=wide)
        assert got.dtype == (np.int64 if wide else np.int32)
        want = build_suffix_array_np(codes)
        assert got.shape == (codes.shape[0] + 1,) and got[0] == codes.shape[0]
        np.testing.assert_array_equal(got, want, err_msg=str(codes.tolist()))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_short_texts_prefix_doubling_matches_jax(family):
    """The reference of the test above equals the JAX package's numpy
    prefix doubling on the same texts."""
    for codes in FAMILIES[family]():
        np.testing.assert_array_equal(build_suffix_array_np(codes),
                                      jsa.build_suffix_array_np(codes))
