"""End-to-end golden parity of the PyTorch port's CLI on the CPU
(GSALIGN_PLATFORM=cpu): byte-identical MAF/ALN/VCF against the C reference
fixtures in tests/golden/ (made with -t 1 on make_pair(total_len=100000)),
with the counts of tests/test_e2e.py."""

import gzip
import os
import re

import pytest

from gsalign_tpu_torch import cli
from tests.make_testdata import make_pair, write_fasta
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def golden(name: str) -> bytes:
    with gzip.open(os.path.join(GOLDEN_DIR, name + ".gz"), "rb") as fh:
        return fh.read()


def strip_reference_line(text: bytes) -> bytes:
    return b"\n".join(ln for ln in text.split(b"\n")
                      if not ln.startswith(b"##reference="))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    ref, qry = make_pair(total_len=100_000)
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "qry.fa"), qry)
    assert cli.main(["gsalign-tpu-torch", "index", str(d / "ref.fa"),
                     str(d / "idx")]) == 0
    return d


def run_cli(workdir, monkeypatch, capsys, tag, *flags):
    monkeypatch.setenv("GSALIGN_PLATFORM", "cpu")
    prefix = str(workdir / tag)
    capsys.readouterr()
    assert cli.main(["gsalign-tpu-torch", "-i", str(workdir / "idx"),
                     "-q", str(workdir / "qry.fa"), "-o", prefix,
                     *flags]) == 0
    return prefix, capsys.readouterr().err


def counts(log: str):
    """((alignments, total alignment length), (SNVs, ins, del) or None)
    from a run's log. A run through parallel/distributed (-t > 1 with
    several query chromosomes, -resume) logs an Alignment# line a
    chromosome shard and no variant line: the alignments are summed."""
    m = re.findall(r"Alignment#=(\d+) \(total alignment length=(\d+)\)",
                   log)
    v = re.search(r"identifies (\d+) SNVs, (\d+) insertions, and (\d+) "
                  r"deletions", log)
    return (sum(int(n) for n, _ in m), sum(int(ln) for _, ln in m)), \
        (tuple(int(x) for x in v.groups()) if v else None)


def read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def test_default_mode_byte_parity(workdir, monkeypatch, capsys):
    prefix, log = run_cli(workdir, monkeypatch, capsys, "d", "-t", "1")
    assert counts(log) == ((3, 90130), (443, 23, 19))
    assert read(prefix + ".maf") == golden("g_default.maf")
    assert strip_reference_line(read(prefix + ".vcf")) == \
        strip_reference_line(golden("g_default.vcf"))


def test_sensitive_mode_byte_parity(workdir, monkeypatch, capsys):
    prefix, log = run_cli(workdir, monkeypatch, capsys, "s", "-sen")
    assert counts(log)[0][1] == 90129
    assert read(prefix + ".maf") == golden("g_sen.maf")
    assert strip_reference_line(read(prefix + ".vcf")) == \
        strip_reference_line(golden("g_sen.vcf"))


def test_aln_format_byte_parity(workdir, monkeypatch, capsys):
    prefix, _ = run_cli(workdir, monkeypatch, capsys, "a", "-fmt", "2",
                        "-t", "4")
    assert read(prefix + ".aln") == golden("g_aln.aln")
    assert strip_reference_line(read(prefix + ".vcf")) == \
        strip_reference_line(golden("g_aln.vcf"))


def test_cuda_platform_without_card_raises(workdir, monkeypatch):
    import torch
    monkeypatch.setenv("GSALIGN_PLATFORM", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["gsalign-tpu-torch", "-i", str(workdir / "idx"), "-q",
                  str(workdir / "qry.fa"), "-o", str(workdir / "x")])


def test_resume_flag_gives_golden_bytes(workdir, monkeypatch, capsys):
    """-resume (once raising NotImplementedError) runs through
    parallel/distributed and writes the goldens; a second -resume run over
    the same prefix gives them again."""
    for _ in range(2):
        prefix, log = run_cli(workdir, monkeypatch, capsys, "r", "-resume")
        assert counts(log)[0] == (3, 90130)
        assert read(prefix + ".maf") == golden("g_default.maf")
        assert strip_reference_line(read(prefix + ".vcf")) == \
            strip_reference_line(golden("g_default.vcf"))
        assert not list(workdir.glob("r.part*"))
