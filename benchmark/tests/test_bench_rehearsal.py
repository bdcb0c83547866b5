"""Whole runs of a small cell on the CPU: the rehearsal, the control, and
the timed path broken underneath in each way a cell of this benchmark can
be, each of which `correct` must catch, in the default and in the
sensitive (-sen) mode."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, write_tiny_root

SEED = 2 ** 31 + 1234
SEN = "tiny.warm_long"      # the cell whose configuration states -sen


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    r, t = write_tiny_root(str(root))
    return r, t, str(root / "cache")


def run_cell(tiny, cell="tiny.warm", trace=False, overrides=None):
    import run
    r, t, cache = tiny
    spec = run.Spec(cell, root=r, traffic_dir=t)
    torch.set_num_threads(2)
    return run.run(spec, SEED, 0.2, trace, device="cpu", cache=cache,
                   program_overrides=overrides)


def test_a_run_in_a_fresh_process_is_correct_and_loads_no_jax(tiny):
    r, t, cache = tiny
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "import run\n"
        "run.cache_env()\n"
        f"spec = run.Spec('tiny.warm', root={r!r}, traffic_dir={t!r})\n"
        f"run.run(spec, {SEED}, 0.2, False, device='cpu', cache={cache!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
        " & set(run.FORBIDDEN))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().split("\n")
    res, mods = json.loads(lines[-2]), json.loads(lines[-1])
    assert mods == []
    assert res["correct"] is True, out.stderr[-3000:]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"align_mbp_per_s", "setup_s"}
    assert res["counts"]["seed_hits"] > 0 and res["counts"]["windows"] > 0


@pytest.mark.parametrize("cell", ["tiny.cold", SEN])
def test_the_other_mixes_are_correct(tiny, cell):
    res = run_cell(tiny, cell)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"maf_bad", "dp_subopt", "vcf_bad", "snv_missed",
            "seed_bad"} <= set(res["checks"])
    # the windows judged through their anchors, and the substitutions in
    # them, are printed and not compared; only -sen has anchors
    assert {"dp_anchored", "snv_anchored"} <= set(res["counts"])
    assert "dp_anchored" not in res["checks"]
    if cell != SEN:
        assert res["counts"]["dp_anchored"] == 0


def test_a_traced_run_reports_its_per_layer_metrics(tiny):
    res = run_cell(tiny, "tiny.warm", trace=True)
    assert res["correct"] is True
    assert {"seed_s", "pass1_s", "dp_wait_s", "pass2_s"} <= set(
        res["metrics"])
    assert "window_s" in res["device"] and "busy_s" in res["device"]
    assert "device_ops" in res["breakdown"]


@pytest.mark.parametrize("cell", ["tiny.warm", SEN])
def test_the_control_is_not_correct(tiny, cell):
    import control
    res = run_cell(tiny, cell, overrides=control.CONTROL)
    assert res["correct"] is False
    assert res["checks"]["seed_bad"]["value"] > 0


def unchanged_step(monkeypatch):
    """The seed step returns every lane's state unchanged."""
    from gsalign_tpu_torch.ops import seeding
    monkeypatch.setattr(seeding, "seed_step_plain",
                        lambda *a, **k: torch.zeros((), dtype=torch.int64))


def half_batch(monkeypatch):
    """The DP aligns the first half of each batch and hands its answers to
    the second half too."""
    from gsalign_tpu_torch.ops import dp_cuda
    orig = dp_cuda.dp_align

    def half(q, t, ql, tl, L):
        B = q.shape[0]
        h = (B + 1) // 2
        out = orig(q[:h], t[:h], ql[:h], tl[:h], L)
        return torch.cat([out, out[:B - h]])
    monkeypatch.setattr(dp_cuda, "dp_align", half)


def maf_base_altered(monkeypatch):
    """One base of the first MAF row changed where the row is made."""
    from gsalign_tpu_torch.pipeline import output
    orig = output.assemble_maf_chunks

    def alter(*a, **k):
        chunks = orig(*a, **k)
        for i, c in enumerate(chunks):
            if isinstance(c, memoryview):
                row = bytearray(c)
                j = next(j for j in range(len(row) // 2, len(row))
                         if row[j] != ord("-"))
                row[j] = ord("A") if row[j] != ord("A") else ord("C")
                chunks[i] = bytes(row)
                break
        return chunks
    monkeypatch.setattr(output, "assemble_maf_chunks", alter)


def vcf_answer_altered(monkeypatch):
    """One substitution's alternative base changed in the collector."""
    from gsalign_tpu_torch.pipeline import align
    orig = align.write_vcf

    def alter(path, collector, *a, **k):
        alt = collector.snv_alt[0]
        alt[0] = ord("A") if alt[0] != ord("A") else ord("C")
        return orig(path, collector, *a, **k)
    monkeypatch.setattr(align, "write_vcf", alter)


def seed_record_altered(monkeypatch):
    """The first seed record of every scan round one base longer."""
    from gsalign_tpu_torch.ops import seeding
    orig = seeding._records

    def alter(lanes, prm):
        recs = orig(lanes, prm).copy()
        if len(recs):
            recs[0, 0] += 1 << 16
        return recs
    monkeypatch.setattr(seeding, "_records", alter)


@pytest.mark.parametrize("cell", ["tiny.warm", SEN])
@pytest.mark.parametrize("fault", [unchanged_step, half_batch,
                                   maf_base_altered, vcf_answer_altered,
                                   seed_record_altered])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault, cell):
    fault(monkeypatch)
    res = run_cell(tiny, cell)
    assert res["correct"] is False
