"""The PyTorch port's suffix array constructions (gsalign_tpu_torch.index.
suffix_array) against the JAX package's (build_suffix_array_np,
build_suffix_array_jax on the CPU) and the native SA-IS, on random and
repetitive texts, below and above the 2^16 symbols from which
build_suffix_array prefers the device build. Suffix arrays are integers:
every comparison is exact. The torch build on the card is held against the
native SA in test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

from gsalign_tpu.index import suffix_array as jsa
from gsalign_tpu_torch.index import suffix_array as tsa
from gsalign_tpu_torch.index import fmindex as tfmindex
from gsalign_tpu_torch.genome.packing import pack_genome
from tests.helpers import naive_suffix_array, random_genome
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def texts():
    """name -> codes: random texts, the repetitive cases of
    tests/test_suffix_array.py, and texts of 2^16 symbols and more."""
    out = {f"random{n}": random_genome(np.random.default_rng(n), n)
           for n in (1, 2, 7, 100, 1000, 20000)}
    out["period4"] = np.tile(np.array([0, 1, 2, 3], dtype=np.uint8), 64)
    out["allA"] = np.zeros(257, dtype=np.uint8)
    out["period6"] = np.tile(np.array([0, 1, 2, 3, 0, 1], dtype=np.uint8),
                             500)
    out["period3"] = np.tile(np.array([0, 1, 0], dtype=np.uint8), 500)
    out["random70000"] = random_genome(np.random.default_rng(70), 70_000)
    # a long repeat: two copies of a 30 kb unit, so doubling runs 13 rounds
    unit = random_genome(np.random.default_rng(71), 30_000)
    out["repeat66000"] = np.concatenate([unit, unit, unit[:6_000]])
    return out


TEXTS = texts()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_constructions_match_jax_and_native(name):
    codes = TEXTS[name]
    want = jsa.build_suffix_array_np(codes)
    if codes.shape[0] <= 1000:
        np.testing.assert_array_equal(want, naive_suffix_array(codes))
    np.testing.assert_array_equal(tsa.build_suffix_array_np(codes), want)
    np.testing.assert_array_equal(
        tsa.build_suffix_array_torch(codes, device="cpu"), want)
    native = tsa.build_suffix_array_native(codes)
    assert native is not None, "the native SA-IS library did not build"
    np.testing.assert_array_equal(native, want)


@pytest.mark.parametrize("name", ["random20000", "period6",
                                  "repeat66000"])
def test_torch_build_matches_jax_device_build(name):
    codes = TEXTS[name]
    np.testing.assert_array_equal(
        tsa.build_suffix_array_torch(codes, device="cpu"),
        jsa.build_suffix_array_jax(codes))


def test_torch_build_refuses_texts_past_int64_keys():
    class Huge:
        shape = (1 << 31,)
    with pytest.raises(NotImplementedError):
        tsa.build_suffix_array_torch(Huge(), device="cpu")


def test_preference_order(monkeypatch):
    """Native SA-IS first; without it the torch build (prefer_device, from
    2^16 symbols), else numpy, as the JAX package's build_suffix_array."""
    codes = TEXTS["random70000"]
    want = jsa.build_suffix_array_np(codes)
    calls = []
    real_torch = tsa.build_suffix_array_torch
    monkeypatch.setattr(tsa, "build_suffix_array_torch",
                        lambda c, device=None: calls.append("torch")
                        or real_torch(c, "cpu"))
    np.testing.assert_array_equal(tsa.build_suffix_array(codes), want)
    assert calls == []
    monkeypatch.setattr(tsa, "build_suffix_array_native", lambda c: None)
    np.testing.assert_array_equal(tsa.build_suffix_array(codes), want)
    assert calls == ["torch"]
    np.testing.assert_array_equal(
        tsa.build_suffix_array(codes, prefer_device=False), want)
    small = TEXTS["random1000"]
    np.testing.assert_array_equal(tsa.build_suffix_array(small),
                                  jsa.build_suffix_array_np(small))
    assert calls == ["torch"]


def test_fmindex_through_the_torch_build_matches_native(monkeypatch):
    """build_fmindex(prefer_device=True) without the native library takes
    the torch build; its index equals the one on the native SA."""
    ref, _ = make_pair(total_len=40_000, seed=5, inversion=False)
    g = pack_genome(ref)
    want = tfmindex.build_fmindex(g)
    real_torch = tsa.build_suffix_array_torch
    monkeypatch.setattr(tsa, "build_suffix_array_native", lambda c: None)
    monkeypatch.setattr(tsa, "build_suffix_array_torch",
                        lambda c, device=None: real_torch(c, "cpu"))
    got = tfmindex.build_fmindex(g, prefer_device=True)
    for f in ("sa_samples", "bwt_packed", "occ_cp", "t3_cp", "t3_packed",
              "c64", "l2", "c8"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.primary == want.primary
