"""Import of a BWA/GSAlign five-file index by the PyTorch port
(gsalign_tpu_torch.index.bwa_import and the CLI's `import` and `-i`),
held against the JAX package's importer. tests/test_bwa_import.py makes its
files with the C reference's binary; here tests/bwa_files.py writes
.pac/.ann/.amb and a .bwt header from make_pair in the layout both
importers read. Genomes and index arrays are compared exactly, and the
100 kb goldens byte for byte."""

import gzip
import os

import numpy as np
import pytest

from gsalign_tpu.genome.packing import pack_genome as jpack
from gsalign_tpu.index import bwa_import as jbwa
from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu_torch import cli
from gsalign_tpu_torch.genome.packing import pack_genome as tpack
from gsalign_tpu_torch.index import bwa_import as tbwa
from tests.bwa_files import write_bwa_files
from tests.make_testdata import make_pair, write_fasta
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FM_ARRAYS = ("sa_samples", "bwt_packed", "occ_cp", "t3_cp", "t3_packed",
             "c64", "l2", "c8", "t3_exc_pos", "t3_exc_chr")


def golden(name: str) -> bytes:
    with gzip.open(os.path.join(GOLDEN_DIR, name + ".gz"), "rb") as fh:
        return fh.read()


def strip_reference_line(text: bytes) -> bytes:
    return b"\n".join(ln for ln in text.split(b"\n")
                      if not ln.startswith(b"##reference="))


def holey_reference():
    """make_pair's reference with N runs and a soft-masked stretch (the
    nt4-table cases of tests/test_bwa_import.py)."""
    ref, _ = make_pair(total_len=60_000, seed=31, inversion=False)
    out = []
    for name, seq in ref:
        s = bytearray(bytes(seq))
        s[500:540] = b"N" * 40
        s[7000:7003] = b"RYK"
        s[1000:1100] = bytes(s[1000:1100]).lower()
        out.append((name, np.frombuffer(bytes(s), dtype=np.uint8)))
    return out


def write_index_files(d, records):
    """BWA files of `records` at d/bwa, the header from the JAX package's
    index of the same genome. Returns the prefix."""
    fm = jbuild(jpack(records), prefer_device=False)
    prefix = str(d / "bwa")
    write_bwa_files(prefix, jpack(records), fm.primary, fm.l2)
    return prefix


@pytest.fixture(scope="module")
def golden_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bwa")
    ref, qry = make_pair(total_len=100_000)
    write_fasta(str(d / "qry.fa"), qry)
    return d, write_index_files(d, ref)


@pytest.fixture(scope="module")
def holey(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bwa_holes")
    ref = holey_reference()
    return ref, write_index_files(d, ref)


def assert_same_genome(a, b):
    assert a.names == b.names
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.codes_fwd, b.codes_fwd)
    assert a.seed == b.seed
    assert [(h.offset, h.length, h.amb) for h in a.holes] == \
        [(h.offset, h.length, h.amb) for h in b.holes]


def test_load_bwa_genome_matches_jax_and_packer(holey):
    ref, prefix = holey
    got = tbwa.load_bwa_genome(prefix)
    assert len(got.holes) > 0
    assert_same_genome(got, jbwa.load_bwa_genome(prefix))
    assert_same_genome(got, tpack(ref))


def test_readers_match_jax(holey):
    _, prefix = holey
    assert tbwa.read_ann(prefix + ".ann") == jbwa.read_ann(prefix + ".ann")
    l_pac, holes = tbwa.read_amb(prefix + ".amb")
    jl_pac, jholes = jbwa.read_amb(prefix + ".amb")
    assert l_pac == jl_pac
    assert [(h.offset, h.length, h.amb) for h in holes] == \
        [(h.offset, h.length, h.amb) for h in jholes]
    np.testing.assert_array_equal(tbwa.read_pac(prefix + ".pac", l_pac),
                                  jbwa.read_pac(prefix + ".pac", l_pac))
    t_hdr = tbwa.read_bwt_header(prefix + ".bwt")
    j_hdr = jbwa.read_bwt_header(prefix + ".bwt")
    assert t_hdr[0] == j_hdr[0]
    np.testing.assert_array_equal(t_hdr[1], j_hdr[1])
    assert tbwa.read_bwt_header(prefix + ".missing") is None


def test_import_bwa_index_matches_jax(holey):
    _, prefix = holey
    got = tbwa.import_bwa_index(prefix)
    want = jbwa.import_bwa_index(prefix)
    assert (got.seq_len, got.primary, got.sa_intv) == \
        (want.seq_len, want.primary, want.sa_intv)
    for f in FM_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("which", ["primary", "l2"])
def test_mismatched_bwt_is_refused_by_both(holey, tmp_path, which):
    ref, _ = holey
    fm = jbuild(jpack(ref), prefer_device=False)
    l2 = np.asarray(fm.l2).copy()
    primary = fm.primary
    if which == "primary":
        primary += 1
    else:
        l2[2] += 1
    prefix = str(tmp_path / "bad")
    write_bwa_files(prefix, jpack(ref), primary, l2)
    for mod in (tbwa, jbwa):
        with pytest.raises(ValueError, match=".bwt"):
            mod.import_bwa_index(prefix)
    # without the check, both import the text
    assert tbwa.import_bwa_index(prefix, check_bwt=False).primary == \
        fm.primary


def run_align(monkeypatch, capsys, d, index, tag, *flags):
    monkeypatch.setenv("GSALIGN_PLATFORM", "cpu")
    prefix = str(d / tag)
    capsys.readouterr()
    assert cli.main(["gsalign-tpu-torch", "-i", index, "-q",
                     str(d / "qry.fa"), "-o", prefix, *flags]) == 0
    return prefix, capsys.readouterr().err


def assert_goldens(prefix, maf="g_default.maf", vcf="g_default.vcf"):
    with open(prefix + ".maf", "rb") as fh:
        assert fh.read() == golden(maf)
    with open(prefix + ".vcf", "rb") as fh:
        assert strip_reference_line(fh.read()) == \
            strip_reference_line(golden(vcf))


def test_bwa_prefix_through_i_gives_goldens(golden_pair, monkeypatch,
                                            capsys):
    d, bwa_prefix = golden_pair
    prefix, log = run_align(monkeypatch, capsys, d, bwa_prefix, "i_bwa")
    assert "Importing BWA-format index" in log
    assert_goldens(prefix)


def test_import_subcommand_gives_goldens(golden_pair, monkeypatch, capsys):
    d, bwa_prefix = golden_pair
    out = str(d / "imported")
    assert cli.main(["gsalign-tpu-torch", "import", bwa_prefix, out]) == 0
    assert os.path.exists(out + ".npz")
    prefix, _ = run_align(monkeypatch, capsys, d, out, "imp", "-sen")
    assert_goldens(prefix, "g_sen.maf", "g_sen.vcf")


def test_import_subcommand_usage(capsys):
    assert cli.main(["gsalign-tpu-torch", "import", "only_one"]) == 1
    assert "usage:" in capsys.readouterr().err
