"""The port's host reference queries (gsalign_tpu_torch/index/fmindex.py
occ4_np ... sa_lookup_np) against brute counts over the true suffix array,
as tests/test_fmindex.py holds the JAX package's (:48-72 and its rank and
extension cases), and against the JAX package's own functions on its index
of the same genome; the port's device occ_t3 against them. A 600-base
random genome, sa_intv 8. Integers throughout: every comparison is exact."""

import numpy as np
import pytest
import torch

from gsalign_tpu.genome.packing import Genome as JGenome
from gsalign_tpu.index import fmindex as jfm
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import (
    build_fmindex, extend_rc_single_np, extend_rc_t3_np, inv_psi_np, occ1_np,
    occ4_np, rank1_t3_np, rank64_np, sa_lookup_np)
from gsalign_tpu_torch.ops import rank as trank
from tests.helpers import naive_occurrences, naive_suffix_array, random_genome
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def genome_of(cls, codes):
    return cls(names=["c"], lengths=np.asarray([len(codes)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=codes)


@pytest.fixture(scope="module")
def codes():
    return random_genome(np.random.default_rng(7), 600)


@pytest.fixture(scope="module")
def fm(codes):
    return build_fmindex(genome_of(Genome, codes), sa_intv=8,
                         prefer_device=False)


@pytest.fixture(scope="module")
def jax_fm(codes):
    return jfm.build_fmindex(genome_of(JGenome, codes), sa_intv=8,
                             prefer_device=False)


@pytest.fixture(scope="module")
def sa_full(fm):
    return naive_suffix_array(fm.genome.codes_fwd_rc())


def test_occ4_np_vs_brute(fm, sa_full):
    text = fm.genome.codes_fwd_rc()
    bwt = text[sa_full[sa_full > 0] - 1]
    n = fm.seq_len
    for k in [-1, 0, 1, 5, 127, 128, 129, 255, 300, n - 2, n - 1, n]:
        if k == -1:
            expect = np.zeros(4)
        else:
            ka = k - (1 if k >= fm.primary else 0)
            expect = np.asarray([(bwt[:ka + 1] == c).sum() for c in range(4)])
        np.testing.assert_array_equal(occ4_np(fm, k), expect, err_msg=f"k={k}")


def test_sa_lookup_np(fm, sa_full):
    for k in range(0, fm.seq_len + 1, 37):
        assert sa_lookup_np(fm, k) == sa_full[k], f"k={k}"


def test_rank64_np_vs_brute(fm, sa_full):
    text = fm.genome.codes_fwd_rc()
    n = fm.seq_len
    true_t3 = np.full(n + 1, -1, dtype=np.int64)
    ok = sa_full >= 3
    s = sa_full[ok]
    true_t3[ok] = text[s - 3] * 16 + text[s - 2] * 4 + text[s - 1]
    rng = np.random.default_rng(5)
    for k in [0, 1, 127, 128, 129, 300, n - 1, n, n + 1]:
        for c in rng.integers(0, 64, size=6).tolist():
            assert rank64_np(fm, int(c), k) == int((true_t3[:k] == c).sum())


def test_rank1_t3_np_vs_brute(fm, sa_full):
    text = fm.genome.codes_fwd_rc()
    n = fm.seq_len
    prev1 = np.full(n + 1, -1, dtype=np.int64)
    ok = sa_full >= 1
    prev1[ok] = text[sa_full[ok] - 1]
    for k in [0, 1, 2, 3, 127, 128, 129, 300, n, n + 1]:
        for c in range(4):
            assert rank1_t3_np(fm, c, k) == int((prev1[:k] == c).sum())


def test_extend_rc_np_matches_naive(fm):
    text = fm.genome.codes_fwd_rc()
    rng = np.random.default_rng(4)
    for _ in range(8):
        s = int(rng.integers(0, len(text) - 16))
        pat = text[s:s + 13].astype(int)
        ik1 = int(fm.l2[3 - pat[0]]) + 1
        ik2 = int(fm.l2[pat[0] + 1] - fm.l2[pat[0]])
        j = 1
        while j + 2 < len(pat):
            ik1, ik2 = extend_rc_t3_np(fm, ik1, ik2, pat[j], pat[j + 1],
                                       pat[j + 2])
            j += 3
            assert ik2 == len(naive_occurrences(text, pat[:j])), j
        while j < len(pat):
            ik1, ik2 = extend_rc_single_np(fm, ik1, ik2, pat[j])
            j += 1
            assert ik2 == len(naive_occurrences(text, pat[:j])), j


def test_host_queries_equal_the_jax_package(fm, jax_fm):
    n = fm.seq_len
    for k in range(-1, n + 1, 11):
        np.testing.assert_array_equal(occ4_np(fm, k), jfm.occ4_np(jax_fm, k))
        for c in range(4):
            assert occ1_np(fm, k, c) == jfm.occ1_np(jax_fm, k, c)
        if k >= 0:
            assert inv_psi_np(fm, k) == jfm.inv_psi_np(jax_fm, k)
            assert sa_lookup_np(fm, k) == jfm.sa_lookup_np(jax_fm, k)
            for c in (0, 5, 63):
                assert rank64_np(fm, c, k) == jfm.rank64_np(jax_fm, c, k)
            for c in range(4):
                assert rank1_t3_np(fm, c, k) == jfm.rank1_t3_np(jax_fm, c, k)


def test_device_occ_t3_matches_np(fm):
    dfm = trank.DeviceFMIndex.from_host(fm, "cpu")
    n = fm.seq_len
    rng = np.random.default_rng(8)
    ks = rng.integers(0, n + 2, size=32)
    ks[:4] = [0, 1, 128, n + 1]
    tri = np.arange(32) % 2 == 0
    cls = np.where(tri, rng.integers(0, 64, size=32),
                   rng.integers(0, 4, size=32))
    got = trank.occ_t3(dfm, torch.from_numpy(ks), torch.from_numpy(tri),
                       torch.from_numpy(cls)).numpy()
    for i in range(32):
        fn = rank64_np if tri[i] else rank1_t3_np
        assert got[i] == fn(fm, int(cls[i]), int(ks[i])), i
