"""The PyTorch port's CLI beside the JAX package's, mirroring
tests/test_cli.py: every case runs through both CLIs as subprocesses on
the CPU (GSALIGN_PLATFORM=cpu) and must give the same exit code, files and
messages; the aligned outputs are compared byte for byte. Covers the index
subcommand, flag parsing and refusals (-slen, -ind, -fmt), a stale index
(abort without -r, rebuild with it), -resume and the import subcommand."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tests.bwa_files import write_bwa_files
from tests.make_testdata import make_pair, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": "gsalign_tpu.cli", "torch": "gsalign_tpu_torch.cli"}


def run_cli(which, args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["GSALIGN_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", CLIS[which]] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def strip_reference_line(b: bytes) -> bytes:
    return b"\n".join(ln for ln in b.split(b"\n")
                      if not ln.startswith(b"##reference"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """ref.fa and qry.fa (one chromosome, as tests/test_cli.py) and
    qry2.fa (two), with each CLI's index of ref.fa at <cli>idx."""
    d = tmp_path_factory.mktemp("torch_cli")
    ref, qry = make_pair(total_len=60_000, n_chr=1, seed=31, inversion=False)
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "qry.fa"), qry)
    _, qry2 = make_pair(total_len=60_000, n_chr=2, seed=31, inversion=False)
    write_fasta(str(d / "qry2.fa"), [qry[0], (qry2[1][0], qry2[1][1])])
    for which in CLIS:
        r = run_cli(which, ["index", "ref.fa", f"{which}idx"], cwd=d)
        assert r.returncode == 0, r.stderr
        assert (d / f"{which}idx.npz").exists()
        assert (d / f"{which}idx.json").exists()
    return d


@pytest.mark.parametrize("flags", [["-t", "2"], ["-t", "1", "-sen"],
                                   ["-fmt", "2", "-no_vcf"]])
def test_align_with_index_same_bytes(data_dir, flags):
    tag = "a" + "".join(f.strip("-") for f in flags)
    outs = {}
    for which in CLIS:
        r = run_cli(which, ["-i", f"{which}idx", "-q", "qry.fa", "-o",
                            f"{which}_{tag}", *flags], cwd=data_dir)
        assert r.returncode == 0, r.stderr
        assert "Alignment#=" in r.stderr
        ext = ".aln" if "-fmt" in flags else ".maf"
        outs[which] = {ext: read(data_dir / f"{which}_{tag}{ext}")}
        vcf = data_dir / f"{which}_{tag}.vcf"
        assert vcf.exists() == ("-no_vcf" not in flags)
        if vcf.exists():
            outs[which][".vcf"] = strip_reference_line(read(vcf))
        if ext == ".maf":
            assert outs[which][ext].startswith(b"##maf version=1\n")
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("which", sorted(CLIS))
def test_usage_and_bad_args(data_dir, which):
    r = run_cli(which, ["-h"], cwd=data_dir)
    assert r.returncode == 0 and "Usage:" in r.stderr
    assert "-resume" in r.stderr
    for flags, msg in ((["-slen", "5"], "minimal seed length"),
                       (["-ind", "5"], "maximal indel size"),
                       (["-fmt", "3"], "Output format should be 1")):
        r = run_cli(which, [*flags, "-i", f"{which}idx", "-q", "qry.fa"],
                    cwd=data_dir)
        assert r.returncode == 1, (flags, r.stderr)
        assert msg in r.stderr
    r = run_cli(which, ["-i", "noidx", "-q", "qry.fa"], cwd=data_dir)
    assert r.returncode == 1
    assert "Please specify a valid reference genome" in r.stderr
    r = run_cli(which, ["index", "ref.fa"], cwd=data_dir)
    assert r.returncode == 1 and "usage:" in r.stderr


@pytest.mark.parametrize("which", sorted(CLIS))
def test_stale_index_aborts_and_rebuilds(data_dir, tmp_path, which):
    for f in ("ref.fa", "qry.fa"):
        shutil.copy(data_dir / f, tmp_path / f)
    for ext in (".json", ".npz"):
        shutil.copy(data_dir / f"{which}idx{ext}", tmp_path / f"old{ext}")
    with open(tmp_path / "old.json") as fh:
        manifest = json.load(fh)
    manifest["format_version"] = 6
    with open(tmp_path / "old.json", "w") as fh:
        json.dump(manifest, fh)
    r = run_cli(which, ["-i", "old", "-q", "qry.fa", "-o", "o"],
                cwd=tmp_path)
    assert r.returncode == 1
    assert "unsupported index format 6" in r.stderr and "aborting" in r.stderr
    r = run_cli(which, ["-i", "old", "-r", "ref.fa", "-q", "qry.fa", "-o",
                        "o", "-fmt", "2"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "rebuilding from -r" in r.stderr
    assert (tmp_path / "ref.npz").exists() and (tmp_path / "o.aln").exists()


def test_resume_and_threads_same_bytes(data_dir):
    """-resume and -t 2 on two query chromosomes (both through the
    shard-and-merge path) give the one-process run's bytes in each CLI."""
    outs = {}
    for which in CLIS:
        for tag, flags in (("one", ["-t", "1"]), ("res", ["-resume"]),
                           ("thr", ["-t", "2"])):
            r = run_cli(which, ["-i", f"{which}idx", "-q", "qry2.fa", "-o",
                                f"{which}_{tag}", *flags], cwd=data_dir)
            assert r.returncode == 0, r.stderr
            outs[which, tag] = (
                read(data_dir / f"{which}_{tag}.maf"),
                strip_reference_line(read(data_dir / f"{which}_{tag}.vcf")))
        assert not list(data_dir.glob(f"{which}_*.part*"))
    assert len(set(outs.values())) == 1


def test_import_subcommand(data_dir, tmp_path):
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.io import load_index
    g = pack_genome(read_fasta(str(data_dir / "ref.fa")))
    fm = load_index(str(data_dir / "torchidx"))
    write_bwa_files(str(tmp_path / "bwa"), g, fm.primary, fm.l2)
    shutil.copy(data_dir / "qry.fa", tmp_path / "qry.fa")
    outs = {}
    for which in CLIS:
        r = run_cli(which, ["import", "bwa"], cwd=tmp_path)
        assert r.returncode == 1 and "usage:" in r.stderr
        r = run_cli(which, ["import", "bwa", f"{which}imp"], cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert "[import] bwa.pac/.ann/.amb" in r.stderr
        r = run_cli(which, ["-i", f"{which}imp", "-q", "qry.fa", "-o",
                            f"{which}_imp", "-t", "1"], cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        outs[which] = read(tmp_path / f"{which}_imp.maf")
    r = run_cli("torch", ["-i", str(data_dir / "torchidx"), "-q", "qry.fa",
                          "-o", "built", "-t", "1"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert outs["torch"] == outs["jax"] == read(tmp_path / "built.maf")
