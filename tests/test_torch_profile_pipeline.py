"""The port's per-stage profile (gsalign_tpu_torch/tools/profile_pipeline.py)
on a 200 kb make_pair in a temporary directory, on the CPU with
PROF_REPS=1: every stage printed, the index built and saved where it was
missing, and prof.maf and prof.vcf equal to those of the JAX package's
tools/profile_pipeline.py run on the same directory (and index)."""

import os
import shutil
import subprocess
import sys

import pytest

from make_testdata import make_pair, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("seed", "chain", "blocks", "gen", "filter", "maf", "vars", "vcf")


def profile(cmd, d):
    env = {**os.environ, "GSALIGN_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
           "PROF_REPS": "1", "OMP_NUM_THREADS": "1"}
    r = subprocess.run(cmd + [str(d)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    ref, qry = make_pair(total_len=200_000)
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "qry.fa"), qry)
    port_out = profile([sys.executable, "-m",
                        "gsalign_tpu_torch.tools.profile_pipeline",
                        "--device", "cpu"], d)
    kept = {}
    for f in ("prof.maf", "prof.vcf"):
        kept[f] = (d / f).read_bytes()
        os.remove(d / f)
    index_made = (d / "ref_idx.json").exists()
    shutil.copy(d / "ref_idx.json", d / "port_idx.json")
    jax_out = profile([sys.executable, "tools/profile_pipeline.py"], d)
    return {"dir": d, "port": port_out, "jax": jax_out, "kept": kept,
            "index_made": index_made}


def test_profile_prints_every_stage(runs):
    lines = [ln for ln in runs["port"].splitlines() if "TOTAL=" in ln]
    assert len(lines) == 1                 # PROF_REPS=1 timed run
    times = dict(kv.split("=") for kv in lines[0].split())
    assert tuple(times) == STAGES + ("TOTAL",)
    assert all(float(v) >= 0 for v in times.values())


def test_profile_builds_and_saves_missing_index(runs):
    from gsalign_tpu_torch.index.io import index_loadable
    assert runs["index_made"]
    assert index_loadable(str(runs["dir"] / "ref_idx"))
    # the JAX tool loaded the port's index rather than building its own
    assert (runs["dir"] / "ref_idx.json").read_bytes() == \
        (runs["dir"] / "port_idx.json").read_bytes()


@pytest.mark.parametrize("f", ["prof.maf", "prof.vcf"])
def test_profile_outputs_equal_jax_tool(runs, f):
    assert runs["kept"][f] == (runs["dir"] / f).read_bytes()
    assert len(runs["kept"][f]) > 10_000
