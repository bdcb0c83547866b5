"""Resumability of the PyTorch port's CLI on the CPU, mirroring
tests/test_resume.py: kill -9 mid-run, restart with -resume; the outputs
must equal an uninterrupted run's byte for byte, and the JAX package's
run on the same input (the reference's appended outputs are corrupt after
a crash, src/tools.cpp:158-163)."""

import os
import signal
import subprocess
import sys
import time

from gsalign_tpu.config import AlignConfig as JConfig
from gsalign_tpu.genome.packing import pack_genome as jpack
from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.pipeline.align import compare_genomes as jcompare
from tests.make_testdata import make_pair, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def strip_reference_line(b: bytes) -> bytes:
    return b"\n".join(ln for ln in b.split(b"\n")
                      if not ln.startswith(b"##reference"))


def env():
    e = dict(os.environ)
    e["GSALIGN_PLATFORM"] = "cpu"
    e["PYTHONPATH"] = REPO
    e["OMP_NUM_THREADS"] = "1"
    return e


def cli_cmd(*args):
    return [sys.executable, "-m", "gsalign_tpu_torch.cli", *args]


def run_cli(args, cwd):
    return subprocess.run(cli_cmd(*args), cwd=cwd, env=env(),
                          capture_output=True, timeout=300)


def test_kill9_then_resume_byte_identical(tmp_path):
    ref, qry = make_pair(total_len=160_000, n_chr=4, seed=91,
                         inversion=False)
    write_fasta(str(tmp_path / "ref.fa"), ref)
    write_fasta(str(tmp_path / "qry.fa"), qry)
    r = run_cli(["index", "ref.fa", "idx"], str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()

    # uninterrupted run (no -resume), and the JAX package's
    r = run_cli(["-i", "idx", "-q", "qry.fa", "-o", "full"], str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()
    jcompare(jbuild(jpack(ref), prefer_device=False), qry, JConfig(),
             output_prefix=str(tmp_path / "jax"), verbose=False)

    # start a -resume run and SIGKILL it once the first shard committed
    p = subprocess.Popen(cli_cmd("-i", "idx", "-q", "qry.fa", "-o", "part",
                                 "-resume", "-t", "1"),
                         cwd=str(tmp_path), env=env(),
                         stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 240
    first_marker = tmp_path / "part.part0.pkl"
    while time.time() < deadline and p.poll() is None:
        if first_marker.exists():
            break
        time.sleep(0.05)
    if p.poll() is None:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
    killed_early = first_marker.exists() and \
        not (tmp_path / "part.vcf").exists()
    assert killed_early or (tmp_path / "part.vcf").exists()

    # restart: must complete, recomputing only uncommitted chromosomes
    r = run_cli(["-i", "idx", "-q", "qry.fa", "-o", "part", "-resume"],
                str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()

    for ext in (".maf", ".vcf"):
        got = {}
        for tag in ("full", "part", "jax"):
            with open(tmp_path / (tag + ext), "rb") as fh:
                got[tag] = strip_reference_line(fh.read())
        assert got["full"] == got["part"], f"{ext} differs after kill+resume"
        assert got["full"] == got["jax"], f"{ext} differs from the JAX run"
    # shards were cleaned up by the merge
    assert not list(tmp_path.glob("part.part*"))
