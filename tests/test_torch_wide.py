"""Wide indexes (seq_len >= 2^31, and small genomes built with force_wide)
in the PyTorch port, against the JAX package: the device tables array for
array, the plain occ_t3, lf_t3 and resolve_sa on every rank, the seeds, the
pipeline's bytes against a narrow index's and the 100 kb goldens through
the CLI, the carry arithmetic on rows whose checkpoints pass 2^32, and the
tables of an index without its genome. All values are integers: every
comparison is exact."""

import dataclasses
import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsalign_tpu.index import fmindex as jfmindex
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu.ops import seeding as jseeding
from gsalign_tpu_torch import cli
from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.fasta import read_fasta
from gsalign_tpu_torch.genome.packing import Genome, pack_genome
from gsalign_tpu_torch.index import fmindex as tfmindex
from gsalign_tpu_torch.index.io import load_index, save_index
from gsalign_tpu_torch.ops import rank as trank
from gsalign_tpu_torch.ops.seeding import find_seeds_all
from gsalign_tpu_torch.pipeline.align import compare_genomes
from tests.helpers import naive_lmem_seeds, random_genome
from tests.make_testdata import make_pair, write_fasta
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_rows import carry_rows

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def genome_of(chroms):
    lens = np.asarray([len(c) for c in chroms])
    return Genome(names=[f"c{i}" for i in range(len(chroms))], lengths=lens,
                  offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
                  holes=[], codes_fwd=np.concatenate(chroms))


def wide_pair(chroms, sa_intv):
    """(port FMIndex, port DeviceFMIndex, JAX DeviceFMIndex) of a
    forced-wide index, and the full suffix array."""
    g = genome_of(chroms)
    full = tfmindex.build_fmindex(g, sa_intv=1).sa_samples
    tfm = tfmindex.build_fmindex(g, sa_intv=sa_intv, force_wide=True)
    assert tfm.rank_dtype == np.int64
    jdfm = jrank.DeviceFMIndex.from_host(jfmindex.build_fmindex(
        g, sa_intv=sa_intv, force_wide=True, prefer_device=False))
    dfm = trank.DeviceFMIndex.from_host(tfm, "cpu")
    assert dfm.wide and jdfm.wide
    return tfm, dfm, jdfm, full


def assert_tables_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name, a in want.items():
        b = got[name]
        if isinstance(a, np.ndarray):
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)
        else:
            assert a == b, name


def mutate(codes, rng, sub_rate=0.02):
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


@pytest.mark.parametrize("sa_intv", [8, 32])
def test_wide_device_tables_match_jax(sa_intv):
    """(a) host_tables of a forced-wide index equal the JAX package's
    tables array for array; the device index holds them in the wide
    dtypes."""
    rng = np.random.default_rng(60 + sa_intv)
    g = genome_of([random_genome(rng, 3000), random_genome(rng, 1100)])
    jd = jrank.DeviceFMIndex.from_host(jfmindex.build_fmindex(
        g, sa_intv=sa_intv, force_wide=True, prefer_device=False))
    tfm = tfmindex.build_fmindex(g, sa_intv=sa_intv, force_wide=True)
    want = trank.tables_from_jax(jd)
    assert want["wide"] and not want["direct_ok"]
    assert want["t3"].shape[1] == trank.T3_ROW_WIDE
    assert_tables_equal(trank.DeviceFMIndex.host_tables(tfm), want)
    dfm = trank.DeviceFMIndex.from_host(tfm, "cpu")
    assert dfm.wide and not dfm.direct_ok and dfm.host_sa is None
    assert tuple(dfm.t3.shape) == want["t3"].shape
    assert dfm.t3.dtype == torch.int32
    assert tuple(dfm.union.shape) == (1, 16)
    assert tuple(dfm.t3_major.shape) == (1, 64)
    assert dfm.sa_samples.dtype == torch.int64
    np.testing.assert_array_equal(dfm.sa_samples.numpy(), tfm.sa_samples)
    # the same tables through from_tables give the same index
    alt = trank.DeviceFMIndex.from_tables(want, None, jd.seq_len, jd.primary,
                                          device="cpu")
    for f in dataclasses.fields(dfm):
        a, b = getattr(alt, f.name), getattr(dfm, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


# the whole build's host memory at its peak, bytes a text row: the int64
# SA (8), the text (1), the forward codes (0.5) and what is taken from the
# SA before it is dropped (sa_samples 1, t3 1, the BWT codes 1), with 2 to
# spare (an H100 host with 96 GiB free holds 6.2 G rows at 14.5, 10 GB left)
BUILD_B_PER_ROW = 14.5
BUILD_MEMORY_SCRIPT = r"""
import json, sys
import numpy as np
from gsalign_tpu_torch import native_lib
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.utils.trace import PhasePeaks, rss_bytes
native_lib.get_lib()
n_bases = int(sys.argv[1])
base = rss_bytes()[0]
peaks = PhasePeaks()
codes = np.random.default_rng(5).integers(0, 4, n_bases, dtype=np.uint8)
g = Genome(names=["a", "b"], lengths=np.asarray([n_bases // 2,
           n_bases - n_bases // 2]), offsets=np.asarray([0, n_bases // 2]),
           holes=[], codes_fwd=codes)
fm = build_fmindex(g, force_wide=True, threads=2, prefer_device=False,
                   on_phase=peaks.mark)
assert fm.rank_dtype == np.int64 and fm.sa_samples.dtype == np.int64
rows = 2 * n_bases
print(json.dumps({"peak": (peaks.peak - base) / rows,
                  "phases": {m["phase"]: (m["peak_rss"] - base) / rows
                             for m in peaks.marks}}))
"""


def test_wide_build_memory_stays_in_budget():
    """A forced-wide build_fmindex of 8 M text rows (int64 SA, sa_intv 8)
    in a subprocess: the peak resident memory it adds to its process, from
    before the genome is made, in bytes a text row, under
    BUILD_B_PER_ROW; every phase the build marks is reported. (Its tables
    equal the JAX package's: test_wide_device_tables_match_jax.)"""
    import json
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", BUILD_MEMORY_SCRIPT, "4000000"], cwd=repo,
        capture_output=True, text=True, check=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(got["phases"]) == ["sa-in", "sa", "gather", "tables",
                                   "jump"]
    assert got["peak"] <= BUILD_B_PER_ROW, got


@pytest.mark.parametrize("sa_intv", [8, 32])
def test_wide_rank_queries_match_jax_on_every_rank(sa_intv):
    """(b) plain occ_t3 (both modes), lf_t3 and resolve_sa on a forced-wide
    index equal the JAX functions on every rank, and resolve_sa the full
    suffix array."""
    rng = np.random.default_rng(sa_intv)
    _, dfm, jdfm, full = wide_pair([random_genome(rng, 1500),
                                    random_genome(rng, 900)], sa_intv)
    k = np.arange(dfm.seq_len + 1, dtype=np.int64)
    cls = rng.integers(0, 64, k.shape[0])
    for tri in (np.zeros(k.shape[0], bool), np.ones(k.shape[0], bool)):
        c = np.where(tri, cls, cls & 3)
        want = np.asarray(jrank.occ_t3(jdfm, jnp.asarray(k), jnp.asarray(tri),
                                       jnp.asarray(c)))
        got = trank.occ_t3(dfm, torch.from_numpy(k), torch.from_numpy(tri),
                           torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(got, want)
    want_lf = np.asarray(jrank.lf_t3(jdfm, jnp.asarray(k)))
    got_lf = trank.lf_t3(dfm, torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got_lf, want_lf)
    want = np.asarray(jrank.resolve_sa(jdfm, jnp.asarray(k)))
    got = trank.resolve_sa(dfm, torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("sensitive", [False, True])
def test_wide_seeds_match_jax_and_narrow(sensitive):
    """(c) seeds of a forced-wide index equal the JAX package's, the naive
    scan's and those of the narrow sampled index of the same genome."""
    rng = np.random.default_rng(70 + sensitive)
    refs = [random_genome(rng, 1200), random_genome(rng, 500)]
    fm, dfm, jdfm, _ = wide_pair(refs, 8)
    narrow = trank.DeviceFMIndex.from_host(
        tfmindex.build_fmindex(genome_of(refs), sa_intv=8), "cpu")
    # diverged enough that the lock-step plain scans stay short
    queries = [mutate(refs[0][:900], rng, 0.08),
               mutate((3 - refs[1][50:450][::-1]), rng, 0.08)]
    queries[0][100:103] = 4
    kw = dict(min_seed_length=12, chunk=450, sensitive=sensitive)
    got = find_seeds_all(dfm, queries, **kw)
    want = jseeding.find_seeds_all(jdfm, queries, **kw)
    text = fm.genome.codes_fwd_rc()
    for g, w, nrw, q in zip(got, want, find_seeds_all(narrow, queries, **kw),
                            queries):
        assert len(g[0]) > 0
        for a, b, c in zip(g, w, nrw):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        naive = naive_lmem_seeds(text, q, min_seed_length=12, chunk=450,
                                 sensitive=sensitive)
        assert sorted(zip(*[x.tolist() for x in g])) == sorted(naive)
    assert (got[1][1] >= fm.genome.size).any()      # RC-strand seeds


def test_wide_pipeline_matches_narrow(tmp_path):
    """(d) The port's analogue of tests/test_wide_layout.py: MAF and VCF
    from a forced-wide index byte-equal to those from a narrow one, through
    a saved and reloaded index."""
    rng = np.random.default_rng(23)
    n = 60_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    qry = codes.copy()
    subs = rng.random(n) < 0.01
    qry[subs] = (qry[subs] + rng.integers(1, 4, subs.sum())) % 4
    qry_records = [("wq", np.frombuffer(b"ACGT", dtype=np.uint8)[qry])]
    cfg = dataclasses.replace(AlignConfig(), thread_num=1)
    outs = {}
    for name, force in (("narrow", False), ("wide", True)):
        g = Genome(names=["wc"], lengths=np.asarray([n]),
                   offsets=np.asarray([0]), holes=[], codes_fwd=codes.copy())
        fm = tfmindex.build_fmindex(g, sa_intv=8, force_wide=force)
        save_index(fm, str(tmp_path / f"idx_{name}"))
        fm = load_index(str(tmp_path / f"idx_{name}"))
        assert fm.rank_dtype == (np.int64 if force else np.int32)
        assert fm.sa_samples.dtype == (np.int64 if force else np.int32)
        prefix = str(tmp_path / name)
        stats, coll, _ = compare_genomes(fm, qry_records, cfg,
                                         output_prefix=prefix, verbose=False,
                                         device="cpu")
        assert stats.local_alignment_num >= 1
        with open(prefix + ".maf", "rb") as fh:
            maf = fh.read()
        with open(prefix + ".vcf", "rb") as fh:
            vcf = b"".join(ln for ln in fh.read().splitlines(keepends=True)
                           if not ln.startswith(b"##reference"))
        outs[name] = (maf, vcf, coll.n_snv)
    assert outs["wide"][0] == outs["narrow"][0]
    assert outs["wide"][1] == outs["narrow"][1]
    assert outs["wide"][2] == outs["narrow"][2] > 100


def test_wide_index_cli_golden(tmp_path, monkeypatch, capsys):
    """(d) The 100 kb C reference outputs through the CLI on a forced-wide
    index (built through the API and saved)."""
    ref, qry = make_pair(total_len=100_000)
    write_fasta(str(tmp_path / "ref.fa"), ref)
    write_fasta(str(tmp_path / "qry.fa"), qry)
    fm = tfmindex.build_fmindex(pack_genome(read_fasta(
        str(tmp_path / "ref.fa"))), force_wide=True)
    assert fm.sa_intv == 8
    save_index(fm, str(tmp_path / "idxw"))
    monkeypatch.setenv("GSALIGN_PLATFORM", "cpu")
    assert cli.main(["gsalign-tpu-torch", "-i", str(tmp_path / "idxw"),
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


def carry_case(n_rows=8, n=4096):
    """(port DeviceFMIndex, JAX DeviceFMIndex) over the synthetic rows of
    carry_rows, and queries (k, triple, cls) on every row."""
    rng = np.random.default_rng(91)
    _, dfm, jdfm, _ = wide_pair([random_genome(rng, 600)], 8)
    rows = carry_rows(rng, n_rows)
    dfm = dataclasses.replace(dfm, t3=torch.from_numpy(rows.view(np.int32)))
    jdfm = dataclasses.replace(jdfm, t3=jnp.asarray(rows))
    k = rng.integers(0, n_rows * 128, n)
    k[:4] = [0, 127, n_rows * 128 - 1, dfm.primary]
    tri = rng.random(n) < 0.5
    cls = np.where(tri, rng.integers(0, 64, n), rng.integers(0, 4, n))
    return dfm, jdfm, k, tri, cls


def test_wide_carry_ranks_match_jax():
    """(e) Rows whose checkpoints pass 2^32 (u32 lows near 2^32, carries 1
    to 3): the plain occ_t3 equals the JAX occ_t3, on ranks >= 2^32."""
    dfm, jdfm, k, tri, cls = carry_case()
    want = np.asarray(jrank.occ_t3(jdfm, jnp.asarray(k), jnp.asarray(tri),
                                   jnp.asarray(cls)))
    got = trank.occ_t3(dfm, torch.from_numpy(k), torch.from_numpy(tri),
                       torch.from_numpy(cls)).numpy()
    assert (want >= 2 ** 32).mean() > 0.99
    assert (want >= 2 ** 34).any()          # single mode sums 16 classes
    np.testing.assert_array_equal(got, want)


def test_index_without_genome_turns_direct_mode_off(monkeypatch):
    """(f) A full-SA index without its genome lays out its tables with
    direct mode off, as the JAX package's does (gsalign_tpu/ops/rank.py
    direct_ok), where no table needs the text: with the order-12 jump
    table carried, at INIT order 12. Its seeds equal those of the same
    index with its genome. Without the order-12 table the order-10 starts
    need the text, and the layout says so."""
    rng = np.random.default_rng(5)
    refs = [random_genome(rng, 1500), random_genome(rng, 600)]
    g = genome_of(refs)
    text = g.codes_fwd_rc()
    tfm = tfmindex.build_fmindex(g, sa_intv=1)
    jfm = jfmindex.build_fmindex(g, sa_intv=1, prefer_device=False)
    bare = dataclasses.replace(tfm, genome=None)
    with pytest.raises(ValueError, match="order-10 jump table needs"):
        trank.DeviceFMIndex.host_tables(bare)

    monkeypatch.setattr(trank, "INIT12_MIN_SEQLEN", 0)
    monkeypatch.setenv("GSALIGN_INIT_ORDER", "12")
    c12 = tfmindex._build_c12(text, tfm.seq_len)
    bare = dataclasses.replace(tfm, genome=None, c12=c12)
    jd = jrank.DeviceFMIndex.from_host(
        dataclasses.replace(jfm, genome=None, c12=c12))
    want = trank.tables_from_jax(jd)
    assert not want["direct_ok"] and want["init_order"] == 12
    got = trank.DeviceFMIndex.host_tables(bare)
    assert_tables_equal(got, want)
    dfm = trank.DeviceFMIndex.from_host(bare, "cpu")
    assert not dfm.direct_ok and dfm.host_sa is None and not dfm.wide
    np.testing.assert_array_equal(dfm.sa_samples.numpy(), tfm.sa_samples)
    full = trank.DeviceFMIndex.from_host(
        dataclasses.replace(tfm, c12=c12), "cpu")
    assert full.direct_ok and full.init_order == 12
    queries = [mutate(refs[0], rng)]
    kw = dict(min_seed_length=15, chunk=500)
    for a, b in zip(find_seeds_all(dfm, queries, **kw)[0],
                    find_seeds_all(full, queries, **kw)[0]):
        np.testing.assert_array_equal(a, b)
