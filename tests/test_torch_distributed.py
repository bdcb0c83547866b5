"""Multi-process, restartable and threaded runs of the PyTorch port
(gsalign_tpu_torch.parallel.distributed) on the CPU, mirroring
tests/test_distributed.py: real torch.distributed processes (gloo, joined
through a file in the test's directory, so no port is shared with other
tests) must merge to MAF/VCF bytes equal to a one-process run of the port
and to the JAX package's one-process run on the same input."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from gsalign_tpu.config import AlignConfig as JConfig
from gsalign_tpu.genome.packing import pack_genome as jpack
from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.pipeline.align import compare_genomes as jcompare
from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.packing import pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.index.io import save_index
from gsalign_tpu_torch.parallel import distributed
from gsalign_tpu_torch.pipeline import align as align_mod
from tests.make_testdata import DNA, make_pair, write_fasta
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")


def strip_reference_line(b: bytes) -> bytes:
    return b"\n".join(ln for ln in b.split(b"\n")
                      if not ln.startswith(b"##reference"))


def outputs(prefix) -> dict:
    out = {}
    for ext in (".maf", ".vcf"):
        with open(str(prefix) + ext, "rb") as fh:
            out[ext] = strip_reference_line(fh.read())
    return out


def single_runs(ref, qry, tmp_path):
    """The port's FMIndex and the outputs of one-process runs of the port
    and of the JAX package on (ref, qry), which must agree."""
    fm = build_fmindex(pack_genome(ref))
    align_mod.compare_genomes(fm, qry, AlignConfig(),
                              output_prefix=str(tmp_path / "single"),
                              verbose=False, device="cpu")
    jcompare(jbuild(jpack(ref), prefer_device=False), qry, JConfig(),
             output_prefix=str(tmp_path / "jax"), verbose=False)
    single = outputs(tmp_path / "single")
    assert single == outputs(tmp_path / "jax")
    return fm, single


def marker_modules(path) -> set:
    """The top-level packages of every class that a .pkl marker names."""
    seen = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add(module.split(".")[0])
            return super().find_class(module, name)
    with open(path, "rb") as fh:
        Recorder(fh).load()
    return seen


def run_workers(tmp_path, nproc):
    env = dict(os.environ)
    env["GSALIGN_PLATFORM"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp_path / "pg_init"), str(nproc),
         str(i), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(nproc)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, \
                f"worker failed:\n{out.decode()}\n{err.decode()}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("nproc", [2, 3])
def test_processes_match_single(tmp_path, nproc):
    ref, qry = make_pair(total_len=150_000, n_chr=3, seed=55,
                         inversion=False)
    fm, single = single_runs(ref, qry, tmp_path)
    save_index(fm, str(tmp_path / "idx"))
    write_fasta(str(tmp_path / "qry.fa"), qry)
    run_workers(tmp_path, nproc)
    assert outputs(tmp_path / "dist_out") == single
    assert not list(tmp_path.glob("dist_out.part*")), "shards not cleaned"


def test_four_processes_with_zero_alignment_chromosome(tmp_path):
    """Chromosome 1 (owned by process 1) is unrelated junk with ZERO
    alignments: its shard is a marker with no output file, and the merge
    skips it as a one-process run does."""
    ref, qry = make_pair(total_len=200_000, n_chr=5, seed=77,
                         inversion=False)
    junk = np.random.default_rng(999).integers(0, 4, 40_000)
    qry[1] = (qry[1][0], DNA[junk.astype(np.uint8)])
    fm, single = single_runs(ref, qry, tmp_path)
    save_index(fm, str(tmp_path / "idx"))
    write_fasta(str(tmp_path / "qry.fa"), qry)
    run_workers(tmp_path, 4)
    assert outputs(tmp_path / "dist_out") == single
    assert not list(tmp_path.glob("dist_out.part*")), "shards not cleaned"


def test_resume_after_crash_mid_merge(tmp_path, monkeypatch):
    """A crash DURING the merge (after chromosome 0's shard was merged and
    its files removed): a resume recomputes ONLY the consumed chromosome
    and writes the uninterrupted run's bytes."""
    ref, qry = make_pair(total_len=160_000, n_chr=4, seed=91,
                         inversion=False)
    fm, single = single_runs(ref, qry, tmp_path)

    real_load = pickle.load
    calls = {"n": 0}

    def crashing_load(fh):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash mid-merge")
        return real_load(fh)

    monkeypatch.setattr(distributed.pickle, "load", crashing_load)
    with pytest.raises(RuntimeError, match="mid-merge"):
        distributed.run_distributed(fm, qry, AlignConfig(),
                                    str(tmp_path / "crash"), verbose=False,
                                    resume=True, device="cpu")
    monkeypatch.setattr(distributed.pickle, "load", real_load)
    assert not (tmp_path / "crash.part0.pkl").exists()
    assert (tmp_path / "crash.part1.pkl").exists()
    # the markers hold no tensor: any process loads them without a card
    assert "torch" not in marker_modules(tmp_path / "crash.part1.pkl")

    recomputed = []
    orig_compare = align_mod.compare_genomes

    def counting_compare(fm_, records, *a, **kw):
        recomputed.append(records[0][0])
        return orig_compare(fm_, records, *a, **kw)

    monkeypatch.setattr(align_mod, "compare_genomes", counting_compare)
    distributed.run_distributed(fm, qry, AlignConfig(),
                                str(tmp_path / "crash"), verbose=False,
                                resume=True, device="cpu")
    assert recomputed == [qry[0][0]], \
        f"expected only chromosome 0 recomputed, got {recomputed}"
    assert outputs(tmp_path / "crash") == single
    assert not list(tmp_path.glob("crash.part*")), "shards not cleaned"


def test_threaded_chromosomes_byte_identical(tmp_path, monkeypatch):
    """-t 2 runs the chromosomes on two threads, byte-identical to one
    run; the threads lay the device tables out once."""
    ref, qry = make_pair(total_len=150_000, n_chr=4, seed=66,
                         inversion=False)
    _, single = single_runs(ref, qry, tmp_path)
    fm = build_fmindex(pack_genome(ref))       # no tables laid out yet
    layouts = []
    real = align_mod.DeviceFMIndex.host_tables

    def counting(fm_, **kw):
        layouts.append(fm_)
        return real(fm_, **kw)
    monkeypatch.setattr(align_mod.DeviceFMIndex, "host_tables",
                        staticmethod(counting))
    cfg = dataclasses.replace(AlignConfig(), thread_num=2)
    distributed.run_distributed(fm, qry, cfg, str(tmp_path / "thr"),
                                verbose=False, device="cpu")
    assert outputs(tmp_path / "thr") == single
    assert layouts == [fm]
