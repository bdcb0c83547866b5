"""Sampled-SA indexes in the PyTorch port: lf_t3 and resolve_sa over every
rank, the seed scan (no direct mode; hits resolved by LF walks) and the
CLI's golden outputs, each against the JAX package, the full suffix array,
the naive scan or the C reference. All values are integers: every
comparison is exact."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu.ops import seeding as jseeding
from gsalign_tpu_torch import cli
from gsalign_tpu_torch.genome.fasta import read_fasta
from gsalign_tpu_torch.genome.packing import Genome, pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.index.io import save_index
from gsalign_tpu_torch.ops import rank as trank
from gsalign_tpu_torch.ops.seeding import find_seeds_all
from tests.helpers import naive_lmem_seeds, random_genome
from tests.make_testdata import make_pair, write_fasta
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def genome_of(chroms):
    lens = np.asarray([len(c) for c in chroms])
    return Genome(names=[f"c{i}" for i in range(len(chroms))], lengths=lens,
                  offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
                  holes=[], codes_fwd=np.concatenate(chroms))


def sampled_pair(chroms, sa_intv):
    """(port FMIndex, port DeviceFMIndex, JAX DeviceFMIndex) of a sampled
    index, and the full suffix array."""
    g = genome_of(chroms)
    full = build_fmindex(g, sa_intv=1).sa_samples
    tfm = build_fmindex(g, sa_intv=sa_intv)
    jdfm = jrank.DeviceFMIndex.from_host(
        jbuild(g, sa_intv=sa_intv, prefer_device=False))
    dfm = trank.DeviceFMIndex.from_host(tfm, "cpu")
    assert not dfm.direct_ok and not jdfm.direct_ok
    assert dfm.host_sa is None and dfm.sa_intv == sa_intv
    return tfm, dfm, jdfm, full


def mutate(codes, rng, sub_rate=0.02):
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


@pytest.mark.parametrize("sa_intv", [8, 32])
def test_lf_and_resolve_sa_match_jax_on_every_rank(sa_intv):
    rng = np.random.default_rng(sa_intv)
    _, dfm, jdfm, full = sampled_pair([random_genome(rng, 1500),
                                       random_genome(rng, 900)], sa_intv)
    k = np.arange(dfm.seq_len + 1, dtype=np.int64)
    want_lf = np.asarray(jrank.lf_t3(jdfm, jnp.asarray(k.astype(np.int32))))
    got_lf = trank.lf_t3(dfm, torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got_lf, want_lf)
    want = np.asarray(jrank.resolve_sa(jdfm, jnp.asarray(k.astype(np.int32))))
    got = trank.resolve_sa(dfm, torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)


def check_sampled(dfm, jdfm, text, queries, **kw):
    got = find_seeds_all(dfm, queries, **kw)
    want = jseeding.find_seeds_all(jdfm, queries, **kw)
    for g, w, q in zip(got, want, queries):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        naive = naive_lmem_seeds(
            text, q, min_seed_length=kw["min_seed_length"],
            max_seed_freq=kw.get("max_seed_freq", 100), chunk=kw["chunk"],
            sensitive=kw.get("sensitive", False))
        assert sorted(zip(*[x.tolist() for x in g])) == sorted(naive)
    return got


@pytest.mark.parametrize("sa_intv,sensitive", [(8, False), (8, True),
                                               (32, False)])
def test_sampled_seeding_matches_naive_and_jax(sa_intv, sensitive):
    rng = np.random.default_rng(40 + sa_intv)
    ref = random_genome(rng, 2000)
    fm, dfm, jdfm, _ = sampled_pair([ref], sa_intv)
    qry = mutate(ref, rng)
    qry[100:103] = 4
    got = check_sampled(dfm, jdfm, fm.genome.codes_fwd_rc(), [qry],
                        min_seed_length=12, sensitive=sensitive, chunk=500)
    assert len(got[0][0]) > 0


def test_sampled_seeding_rc_strand_and_multi_chromosome():
    rng = np.random.default_rng(23)
    refs = [random_genome(rng, n) for n in (900, 1300, 700)]
    fm, dfm, jdfm, _ = sampled_pair(refs, 8)
    queries = [mutate(r, rng) for r in refs[::-1]]
    queries[0][50:70] = 4
    queries.append((3 - refs[1][100:500][::-1]).astype(np.uint8))
    queries.append(np.full(40, 4, np.uint8))      # all-N chromosome
    got = check_sampled(dfm, jdfm, fm.genome.codes_fwd_rc(), queries,
                        min_seed_length=12, chunk=450)
    assert [len(g[0]) > 0 for g in got] == [True, True, True, True, False]
    assert (got[3][1] >= fm.genome.size).any()      # RC-strand seeds


def test_sampled_seeds_equal_full_index_seeds():
    """The same query gives the same seeds on a sampled and on a full-SA
    index of one genome (direct extension and LF walks agree)."""
    rng = np.random.default_rng(31)
    refs = [random_genome(rng, 2200), random_genome(rng, 800)]
    _, dfm, _, _ = sampled_pair(refs, 8)
    full = trank.DeviceFMIndex.from_host(
        build_fmindex(genome_of(refs), sa_intv=1), "cpu")
    queries = [mutate(r, rng, 0.01) for r in refs]
    kw = dict(min_seed_length=15, chunk=700)
    for a, b in zip(find_seeds_all(dfm, queries, **kw),
                    find_seeds_all(full, queries, **kw)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_sampled_index_cli_golden(tmp_path, monkeypatch, capsys):
    """The 100 kb C reference outputs through the CLI on an sa_intv=8
    index (built through the API: the index subcommand picks the full SA
    at this size)."""
    ref, qry = make_pair(total_len=100_000)
    write_fasta(str(tmp_path / "ref.fa"), ref)
    write_fasta(str(tmp_path / "qry.fa"), qry)
    fm = build_fmindex(pack_genome(read_fasta(str(tmp_path / "ref.fa"))),
                       sa_intv=8)
    save_index(fm, str(tmp_path / "idx8"))
    monkeypatch.setenv("GSALIGN_PLATFORM", "cpu")
    assert cli.main(["gsalign-tpu-torch", "-i", str(tmp_path / "idx8"),
                     "-q", str(tmp_path / "qry.fa"), "-o",
                     str(tmp_path / "out"), "-t", "1"]) == 0
    assert "Alignment#=3 (total alignment length=90130)" in \
        capsys.readouterr().err
    with gzip.open(os.path.join(GOLDEN_DIR, "g_default.maf.gz"), "rb") as fh:
        want_maf = fh.read()
    with gzip.open(os.path.join(GOLDEN_DIR, "g_default.vcf.gz"), "rb") as fh:
        want_vcf = fh.read()
    with open(tmp_path / "out.maf", "rb") as fh:
        assert fh.read() == want_maf

    def strip(b):
        return b"\n".join(ln for ln in b.split(b"\n")
                          if not ln.startswith(b"##reference="))
    with open(tmp_path / "out.vcf", "rb") as fh:
        assert strip(fh.read()) == strip(want_vcf)
