"""The port's 3 Gb tool (gsalign_tpu_torch/tools/run_3gb.py) against the
JAX package's (tools/run_3gb.py) at 2 Mb, on the CPU: the facts that
tests/test_run3gb_driver.py checks of the JAX tool, equal counts, and
byte-identical out.maf and out.vcf, both on the row-sharded 8-entry CPU
mesh (the JAX tool's mode) and with whole tables from the saved index
(--entries 1 --index: the card's default, and the restore round trip).
All three runs write into one directory in turn, so that the VCF's
##reference line (the output prefix) is the same."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--len", "2000000", "--slice-len", "100000"]
# result.json keys that mean the same in both tools
SHARED = ("total_len", "wide", "sa_intv", "mesh_devices", "query_bp",
          "ani_pct", "alignments", "aligned_bp", "snv", "ins", "dele",
          "max_text_rpos", "int64_coords_seen")


def run_tool(cmd, out, keep):
    """Run a tool into `out`, then move its result and outputs to `keep`."""
    env = {**os.environ, "GSALIGN_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run(cmd + ARGS + ["--out", str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    keep.mkdir()
    for f in ("result.json", "out.maf", "out.vcf"):
        shutil.move(str(out / f), str(keep / f))
    with open(keep / "result.json") as fh:
        return json.load(fh), r.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("run3gb")
    out = base / "out"
    port = [sys.executable, "-m", "gsalign_tpu_torch.tools.run_3gb",
            "--device", "cpu"]
    return {
        "jax": run_tool([sys.executable, "tools/run_3gb.py"], out,
                        base / "jax"),
        "port8": run_tool(port, out, base / "port8"),
        "port1": run_tool(port + ["--entries", "1", "--index",
                                  str(out / "idx")], out, base / "port1"),
        "base": base,
    }


def test_run3gb_driver_smoke(runs):
    """The JAX test's facts, of the port's tool on the 8-entry mesh."""
    res, _ = runs["port8"]
    base = runs["base"] / "port8"
    assert res["mesh_devices"] == 8
    assert res["alignments"] == 3          # one per query slice
    assert res["aligned_bp"] == res["query_bp"] == 300000
    assert res["ani_pct"] > 99.0
    assert res["snv"] > 1000               # 0.5% mutated slices
    assert (base / "out.maf").stat().st_size > 100_000
    assert (base / "out.vcf").stat().st_size > 10_000
    assert res["wide"] is False
    assert res["device"] == "cpu"
    for k in ("table_layout_s", "device_table_gib", "seed_s", "chain_s",
              "align_s", "output_s", "variants_s", "sa_wall_s",
              "build_wall_s", "save_wall_s"):
        assert res[k] >= 0


@pytest.mark.parametrize("run", ["port8", "port1"])
def test_run3gb_matches_jax_tool(runs, run):
    """Equal counts and byte-identical outputs: row-sharded over 8 CPU
    entries as the JAX tool runs, and whole tables from the saved index."""
    want, _ = runs["jax"]
    got, _ = runs[run]
    for k in SHARED:
        if k != "mesh_devices":
            assert got[k] == want[k], k
    assert got["mesh_devices"] == (8 if run == "port8" else 1)
    for f in ("out.maf", "out.vcf"):
        assert (runs["base"] / run / f).read_bytes() == \
            (runs["base"] / "jax" / f).read_bytes(), f


def test_run3gb_index_round_trip(runs):
    """--index loads the saved index instead of building one."""
    res, stdout = runs["port1"]
    assert res["index"].endswith("idx") and "load_wall_s" in res
    assert "build_wall_s" not in res and "index built" not in stdout


SPANS = ("setup", "chars_fwd_rc", "from_host", "query_codes", "seed",
         "pass1", "dp_finish", "pass2", "emit", "vcf_close")


@pytest.mark.parametrize("run", ["port8", "port1"])
def test_run3gb_reports_memory_and_spans(runs, run):
    """result.json's memory phases (the build's, SA-IS's levels among them,
    or the load's, then the layout's and the align's) and the align's
    spans, which cut compare_genomes' wall into named pieces."""
    res, stdout = runs[run]
    names = [p["phase"] for p in res["memory"]]
    if run == "port8":
        levels = [n for n in names if n.startswith("sais-depth")]
        assert levels and levels[0].startswith("sais-depth0 (n=4000001)")
        assert [n for n in names if n not in levels] == [
            "sa-in", "sa", "gather", "tables", "jump", "save", "layout",
            "align"]
    else:
        assert names == ["load", "layout", "align"]
    rows = 2 * res["total_len"]
    so_far = 0
    for p in res["memory"]:
        assert p["peak_bytes"] >= p["rss_bytes"] > 0, p
        assert p["peak_so_far_bytes"] >= p["peak_bytes"], p
        assert p["peak_b_per_row"] == round(p["peak_bytes"] / rows, 3)
        assert f"[3gb] memory {p['phase']}: peak" in stdout
        if not p["phase"].startswith("sais-depth"):
            assert p["peak_so_far_bytes"] >= so_far, p
            so_far = p["peak_so_far_bytes"]
    assert res["peak_rss_gb"] >= max(p["peak_bytes"]
                                     for p in res["memory"]) / 1e9 - 0.05
    assert set(res["span_s"]) <= set(SPANS) and "seed" in res["span_s"]
    assert abs(sum(res["span_s"].values()) - res["align_wall_s"]) <= \
        0.2 + 0.05 * res["align_wall_s"]


def test_run3gb_cuda_without_card_raises(tmp_path):
    """--device cuda (the default) on a host without a card raises; the
    tool does not fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    r = subprocess.run(
        [sys.executable, "-m", "gsalign_tpu_torch.tools.run_3gb", *ARGS,
         "--out", str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "result.json").exists()
