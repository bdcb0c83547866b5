"""The chaining and block heuristics of both packages on the same cases:
tests/test_chain_units.py's unit tests, each run through the JAX package
(gsalign_tpu) and the port (gsalign_tpu_torch), and random seed and block
sets whose chains and dedup must come out equal in the two."""

import copy
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("gsalign_tpu", "gsalign_tpu_torch")


def modules(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{name}.{path}")
    return SimpleNamespace(
        chain=mod("pipeline.chain"), blocks=mod("pipeline.blocks"),
        kmer=mod("pipeline.kmer"), packing=mod("genome.packing"),
        coords=mod("genome.coords"), cfg=mod("config").AlignConfig())


@pytest.fixture(params=PKGS)
def pkg(request):
    return modules(request.param)


def test_trunc_div_matches_cpp(pkg):
    d = pkg.chain._trunc_div
    assert d(7, 2) == 3
    assert d(-7, 2) == -3      # C++ truncates toward zero
    assert d(7, -2) == -3
    assert d(-7, -2) == 3


def test_seed_grouping_splits_on_posdiff_gap(pkg):
    # MaxIndelSize=25 (src/GSAlign.cpp:133): split where delta > 25
    grouping = pkg.chain.seed_grouping
    pd = np.asarray([0, 10, 20, 46, 50, 100])
    assert grouping(pd, 25) == [(0, 3), (3, 5), (5, 6)]
    assert grouping(np.asarray([5]), 25) == [(0, 1)]
    assert grouping(np.zeros(0, dtype=np.int64), 25) == []


def test_unique_mask_runs(pkg):
    q = np.asarray([1, 2, 2, 2, 3, 4, 4, 5])
    np.testing.assert_array_equal(
        pkg.chain._unique_mask(q),
        [True, False, False, False, True, False, False, True])


def mk_block(pkg, rows):
    rows = np.asarray(rows, dtype=np.int64)
    n = len(rows)
    return pkg.chain.Block(
        q_pos=rows[:, 0].copy(), r_pos=rows[:, 1].copy(),
        q_len=rows[:, 2].copy(), r_len=rows[:, 2].copy(),
        b_seed=np.ones(n, dtype=bool), score=int(rows[:, 2].sum()),
        aln1=[None] * n, aln2=[None] * n)


def chr_index(pkg, lengths):
    lengths = np.asarray(lengths)
    g = pkg.packing.Genome(
        names=[f"c{i}" for i in range(len(lengths))], lengths=lengths,
        offsets=np.concatenate([[0], np.cumsum(lengths)[:-1]]), holes=[],
        codes_fwd=np.zeros(int(lengths.sum()), dtype=np.uint8))
    return pkg.coords.ChrLocIndex(g)


def test_remove_overlaps_trims_left_pair(pkg):
    # (src/ProcessCandidateAlignment.cpp:205-226): overlap shrinks pair i
    blk = mk_block(pkg, [[0, 100, 50], [40, 140, 50]])  # 10 overlap
    pkg.blocks.remove_overlaps(blk)
    assert blk.q_len[0] == 40 and blk.r_len[0] == 40
    assert blk.q_len[1] == 50


def test_remove_overlaps_drops_nonmonotone_ref(pkg):
    # rPos[j] <= rPos[i] -> drop i (src/ProcessCandidateAlignment.cpp:199)
    blk = mk_block(pkg, [[0, 200, 20], [30, 100, 20], [60, 260, 20]])
    pkg.blocks.remove_overlaps(blk)
    assert blk.n == 2
    assert blk.r_pos.tolist() == [100, 260]


def test_add_block_filters(pkg):
    # AddAlnBlock (src/GSAlign.cpp:38): score floor, region floor,
    # score < 1000 and score < region*0.05
    gen = pkg.chain.generate_alignment_blocks
    q = np.asarray([0, 5000])
    r = np.asarray([0, 5000])
    ln = np.asarray([150, 100])     # score 250 >= 200, region 5100
    assert gen(q, r, ln, pkg.cfg, genome_size=10 ** 6) == []
    ln = np.asarray([150, 110])     # score 260 > 255 -> kept
    blocks = gen(q, r, ln, pkg.cfg, genome_size=10 ** 6)
    assert len(blocks) == 1 and blocks[0].score == 260


def test_chain_split_on_gap_and_posdiff(pkg):
    # split at qGap > 5000 or |dPD| > 100 (src/GSAlign.cpp:367)
    q = np.asarray([0, 300, 6000])
    r = np.asarray([0, 300, 6000 + 150])     # PD jumps by 150
    ln = np.asarray([250, 250, 250])
    blocks = pkg.chain.generate_alignment_blocks(q, r, ln, pkg.cfg,
                                                 genome_size=10 ** 6)
    assert all(b.score >= 200 for b in blocks)


def test_redundant_blocks_containment(pkg):
    # f >= 0.9 containment kills the smaller block (src/GSAlign.cpp:451-466)
    big = mk_block(pkg, [[0, 0, 5000]])
    small = mk_block(pkg, [[100, 90000, 450]])
    big.score, small.score = 5000, 450
    out = pkg.blocks.remove_redundant_blocks(
        [big, small], np.asarray([5450]), chr_index(pkg, [200000]),
        pkg.cfg, axis=1)
    assert len(out) == 1 and out[0].score == 5000


def test_type1_exact_duplicate_marks_bdup(pkg):
    a = mk_block(pkg, [[100, 0, 500]])
    b = mk_block(pkg, [[100, 50000, 500]])
    a.score = b.score = 500
    out = pkg.blocks.remove_redundant_blocks(
        [a, b], np.asarray([1000]), chr_index(pkg, [200000]), pkg.cfg,
        axis=1)
    assert len(out) == 1 and out[0].b_dup


def test_fill_block_gaps_inserts_and_orders(pkg):
    blk = mk_block(pkg, [[0, 0, 100], [150, 160, 100]])
    pkg.blocks.fill_block_gaps(blk)
    assert blk.n == 3
    assert not blk.b_seed[1]
    assert blk.q_pos[1] == 100 and blk.q_len[1] == 50
    assert blk.r_pos[1] == 100 and blk.r_len[1] == 60


def test_kmer_vector_reference_quirks(pkg):
    # only literal 'N' interrupts k-mers; ids keep 8 bits of history
    kv = pkg.kmer.kmer_vector
    assert len(kv(np.frombuffer(b"ACGTACGTA", dtype=np.uint8))) == 5
    # 'N' resets the window count but the reference never advances `head`
    # during the initial scan (src/KmerAnalysis.cpp:39-47), so the first id
    # is still taken at position 0, the N as code 4
    assert kv(np.frombuffer(b"ACGTNACGTA", dtype=np.uint8)).tolist() == [112]
    # lowercase 'n' does NOT interrupt (flows into ids as code 4)
    assert len(kv(np.frombuffer(b"ACGTnACGTA", dtype=np.uint8))) == 6


def redundant_sweep_naive(pkg, blocks, chr_scores, ci, cfg, axis):
    """Plain O(n^2) transliteration of RemoveRedundantAlnBlocks
    (src/GSAlign.cpp:415-471), the oracle for the linked-list sweep."""
    if axis == 1:
        blocks = sorted(blocks, key=lambda b: (int(b.q_pos[0]), -b.score))
        heads = [int(b.q_pos[0]) for b in blocks]
        tails = [int(b.q_pos[-1] + b.q_len[-1] - 1) for b in blocks]
    else:
        blocks = sorted(blocks, key=lambda b: (int(b.r_pos[0]), -b.score))
        heads = [int(b.r_pos[0]) for b in blocks]
        tails = [int(b.r_pos[-1] + b.r_len[-1] - 1) for b in blocks]
    chrv = ci.chr_of(
        np.asarray([b.r_pos[0] for b in blocks], dtype=np.int64)).tolist()
    if axis == 2:
        for k in range(len(blocks)):
            if heads[k] >= ci.size:
                heads[k], tails[k] = pkg.coords.reverse_ref_coordinate(
                    ci.two_size, heads[k], tails[k])
    dup = pkg.blocks._dup_chr_score
    n = len(blocks)
    for i in range(n):
        bi = blocks[i]
        if bi.score == 0:
            continue
        head1, tail1, chr1 = heads[i], tails[i], chrv[i]
        for j in range(i + 1, n):
            bj = blocks[j]
            if bj.score == 0:
                continue
            head2, tail2 = heads[j], tails[j]
            if axis == 1 and head1 == head2 and tail1 == tail2:
                bi.b_dup = True
                bj.score = 0
                continue
            chr2 = chrv[j]
            if head2 < tail1:
                overlap = (tail1 - head2) if tail2 > tail1 else (tail2 - head2)
                f1 = overlap / (tail1 - head1)
                f2 = overlap / (tail2 - head2)
                dominated2 = cfg.one_on_one and \
                    dup(chr_scores[chr2], chr_scores[chr1])
                dominated1 = cfg.one_on_one and \
                    dup(chr_scores[chr1], chr_scores[chr2])
                if (f1 > f2 and f1 >= cfg.dup_overlap_frac) or dominated2:
                    bi.score = 0
                    break
                if (f2 > f1 and f2 >= cfg.dup_overlap_frac) or dominated1:
                    bj.score = 0
            else:
                break
    return pkg.blocks.remove_bad_blocks(blocks)


def random_blocks(pkg, rng):
    """A dense-overlap block set over both strands of two chromosomes,
    with a few exact query-axis duplicates, and two chromosome scores."""
    n = int(rng.integers(2, 60))
    blocks = []
    for _ in range(n):
        q0 = int(rng.integers(0, 50000))
        ln = int(rng.integers(200, 4000))
        r0 = int(rng.integers(0, 230000))
        blk = mk_block(pkg, [[q0, r0, ln]])
        blk.score = ln
        blocks.append(blk)
    for _ in range(min(3, n)):
        src = blocks[int(rng.integers(0, n))]
        dup = mk_block(pkg, [[int(src.q_pos[0]), int(rng.integers(0, 230000)),
                              int(src.q_len[0])]])
        dup.score = src.score
        blocks.append(dup)
    scores = np.asarray([int(rng.integers(0, 10000)),
                         int(rng.integers(0, 10000))])
    return blocks, scores


def summary(blocks):
    return [(int(b.q_pos[0]), int(b.r_pos[0]), b.score, b.b_dup)
            for b in blocks]


def test_redundant_blocks_linkedlist_matches_naive_sweep(pkg):
    """Random dense-overlap block sets: the skip-list sweep reproduces the
    plain quadratic reference sweep exactly (scores, b_dup, order), with
    and without one_on_one."""
    ci = chr_index(pkg, [60000, 60000])
    rng = np.random.default_rng(7)
    for trial in range(20):
        blocks, scores = random_blocks(pkg, rng)
        for axis in (1, 2):
            for one in (False, True):
                cfg = dataclasses.replace(pkg.cfg, one_on_one=one)
                got = pkg.blocks.remove_redundant_blocks(
                    copy.deepcopy(blocks), scores, ci, cfg, axis)
                want = redundant_sweep_naive(pkg, copy.deepcopy(blocks),
                                             scores, ci, cfg, axis)
                assert summary(got) == summary(want), (trial, axis, one)


def test_redundant_blocks_equal_in_both_packages():
    """The same random block sets through both packages' dedup: equal
    survivors, scores and b_dup marks."""
    jax_pkg, port = modules(PKGS[0]), modules(PKGS[1])
    cis = [chr_index(p, [60000, 60000]) for p in (jax_pkg, port)]
    rng = np.random.default_rng(11)
    for trial in range(20):
        blocks, scores = random_blocks(port, rng)
        for axis in (1, 2):
            out = []
            for p, ci in zip((jax_pkg, port), cis):
                mine = [mk_block(p, np.stack([b.q_pos, b.r_pos, b.q_len], 1))
                        for b in blocks]
                for m, b in zip(mine, blocks):
                    m.score = b.score
                out.append(summary(p.blocks.remove_redundant_blocks(
                    mine, scores, ci, p.cfg, axis)))
            assert out[0] == out[1], (trial, axis)


def test_chains_equal_in_both_packages():
    """Random seed sets (runs of collinear seeds with indel shifts, and
    noise) through both packages' generate_alignment_blocks: the same
    blocks, pair for pair."""
    jax_pkg, port = modules(PKGS[0]), modules(PKGS[1])
    rng = np.random.default_rng(3)
    for trial in range(10):
        q, r, ln = [], [], []
        for _ in range(int(rng.integers(1, 6))):
            q0, d = int(rng.integers(0, 200_000)), int(rng.integers(0, 10 ** 6))
            pos = q0
            for _ in range(int(rng.integers(5, 40))):
                L = int(rng.integers(15, 120))
                q.append(pos)
                r.append(pos + d)
                ln.append(L)
                pos += L + int(rng.integers(0, 400))
                d += int(rng.integers(-3, 4))
        noise = int(rng.integers(0, 50))
        q += rng.integers(0, 300_000, noise).tolist()
        r += rng.integers(0, 2 * 10 ** 6, noise).tolist()
        ln += rng.integers(15, 60, noise).tolist()
        q, r, ln = (np.asarray(x, dtype=np.int64) for x in (q, r, ln))
        order = np.lexsort((q, r - q))
        q, r, ln = q[order], r[order], ln[order]
        got = [p.chain.generate_alignment_blocks(q.copy(), r.copy(),
                                                 ln.copy(), p.cfg,
                                                 genome_size=10 ** 6)
               for p in (jax_pkg, port)]
        assert len(got[0]) == len(got[1]), trial
        for a, b in zip(*got):
            assert a.score == b.score
            for f in ("q_pos", "r_pos", "q_len", "r_len", "b_seed"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
