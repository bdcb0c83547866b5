"""The PyTorch port's bench path (gsalign_tpu_torch/bench.py) at a tiny
size on the CPU: a configuration's row has bench.py's keys, the median of
its timed runs with their count and spread, and counts equal to the JAX
package's compare_genomes on the same pair (exact); the index is built
once, in a fresh process, and reused."""

import json
import os
import re

import pytest

from gsalign_tpu.config import AlignConfig as JConfig
from gsalign_tpu.genome.fasta import read_fasta as jread
from gsalign_tpu.genome.packing import pack_genome as jpack
from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.pipeline.align import compare_genomes as jcompare
from gsalign_tpu_torch import bench
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

# bench.py's row keys, less the C reference's baseline_same_host
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "aligned_bp_per_s",
                 "ani_pct", "alignments", "snv", "ins", "dele",
                 "index_build_seconds", "index_build_fresh_process",
                 "stage_seconds"}


def test_row_keys_and_counts_against_jax(tmp_path, monkeypatch, capsys):
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    layouts = []
    real = DeviceFMIndex.host_tables
    monkeypatch.setattr(DeviceFMIndex, "host_tables", staticmethod(
        lambda fm, **kw: layouts.append(fm) or real(fm, **kw)))
    row = bench.run_config("tiny_120kb", 120_000, bench_dir=str(tmp_path),
                           reps=3, device="cpu")
    assert len(layouts) == 1          # once, before the warm-up
    assert BENCH_PY_KEYS | {"runs", "spread", "walls", "backend", "device",
                            "power_limit_w", "warmup_seconds",
                            "table_layout_seconds", "seed_lanes",
                            "scan_iterations", "kernel_launches"} <= set(row)
    assert len(row["scan_iterations"]) >= 1
    # on CPU tensors the wrappers run the plain versions: no launch
    assert set(row["kernel_launches"]) == {
        "dp_small", "dp_any", "masked_gather", "seed_scan", "seed_lockstep",
        "resolve_sa"}
    assert not any(row["kernel_launches"].values())
    json.dumps(row)
    assert row["metric"] == "tiny_120kb_align_wallclock"
    assert row["runs"] == 3 == len(row["walls"])
    assert row["value"] == sorted(row["walls"])[1]
    assert row["spread"] == max(row["walls"]) - min(row["walls"])
    assert row["vs_baseline"] is None
    assert row["backend"] == "torch-cpu" and row["device"] == "cpu"
    assert row["power_limit_w"] is None
    assert row["counts_equal_jax_record"] is None      # no record at 120 kb
    assert set(row["stage_seconds"]) >= {"seed", "chain", "align"}

    d = tmp_path / "tiny_120kb"
    stats, coll, _ = jcompare(
        jbuild(jpack(jread(str(d / "ref.fa"))), prefer_device=False),
        jread(str(d / "qry.fa")), JConfig(), output_prefix=None,
        verbose=False)
    assert (row["alignments"], row["ani_pct"], row["snv"], row["ins"],
            row["dele"]) == (stats.local_alignment_num, round(stats.ani, 2),
                             coll.n_snv, coll.n_ins, coll.n_del)
    assert row["aligned_bp_per_s"] == \
        stats.total_alignment_length / row["value"]
    # the lanes the seed scan ran, as compare_genomes logs them
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    capsys.readouterr()
    tstats, _, _ = compare_genomes(
        load_index(str(d / "ref_idx")), read_fasta(str(d / "qry.fa")),
        AlignConfig(), device="cpu")
    lanes = re.search(r"\[seed\] (\d+) lanes", capsys.readouterr().err)
    assert row["seed_lanes"] == int(lanes.group(1))
    assert row["scan_iterations"] == tstats.seed_scan_iterations

    # a second run reuses the data and the index (and its build seconds)
    stamp = os.path.getmtime(d / "ref_idx.npz")
    again = bench.run_config("tiny_120kb", 120_000, bench_dir=str(tmp_path),
                             reps=1, device="cpu")
    assert os.path.getmtime(d / "ref_idx.npz") == stamp
    assert again["index_build_seconds"] == row["index_build_seconds"]
    assert again["runs"] == 1 and again["spread"] == 0


def test_record_check_and_configs(monkeypatch):
    monkeypatch.delenv("GSALIGN_BENCH_SMALL", raising=False)
    monkeypatch.delenv("GSALIGN_BENCH_ONLY", raising=False)
    assert [t for t, _ in bench.configs()] == [
        "ecoli_4.6mb", "yeast_12mb", "celegans_100mb", "human_250mb"]
    assert set(bench.JAX_RECORD) == set(bench.REPS) == \
        {t for t, _ in bench.configs()}
    monkeypatch.setenv("GSALIGN_BENCH_SMALL", "1")
    assert [n for _, n in bench.configs()] == [4_600_000, 12_000_000]
    monkeypatch.setenv("GSALIGN_BENCH_ONLY", "yeast_12mb")
    assert bench.configs() == [("yeast_12mb", 12_000_000)]


def test_bench_needs_the_card(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_config("tiny", 1000, bench_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.dp_gcells(L=64, B=2)
