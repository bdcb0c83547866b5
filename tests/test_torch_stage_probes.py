"""The port's five stage probes (gsalign_tpu_torch/tools/exp_align.py,
exp_dphist.py, exp_seedprof.py, seed_stats.py and exp_seedab.py) against
the JAX package's tools of the same names, on one 200 kb make_pair and its
index, on the CPU.

The JAX tools run as subprocesses (JAX_PLATFORMS=cpu); they read
/tmp/gsalign_bench/<tag>, so a uniquely named tag there links to the test's
pair directory while they run. The port's tools run with --device cpu in one
subprocess in which importing jax, jaxlib or gsalign_tpu raises, each on a
pair directory of its own (the same files, linked), so that the two
exp_dphist runs write their outputs apart. Every deterministic number must
be equal: the DP problems and their buckets, the [dp_stats] line, the seed
hits per lane, each round's lanes and steps and the per-lane steps'
percentiles and integral, the steps with INIT-12 on and off.
"""

import ast
import json
import os
import re
import subprocess
import sys
import uuid

import pytest
import torch

from make_testdata import make_pair, write_fasta
from torch_cpu import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = "/tmp/gsalign_bench"         # the JAX tools' hard-coded root
TOOLS = ("exp_align", "exp_dphist", "exp_seedprof", "seed_stats",
         "exp_seedab")
STAGES = ("chain", "plan", "dp_submit", "dp_rest", "dp_device", "dp_fetch",
          "finish")

# the port's tools, run in a process that cannot import the JAX side
PORT_RUN = """
import importlib.abc
import sys


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gsalign_tpu"):
            raise ImportError(f"{name} must not be imported by the port")
        return None


sys.meta_path.insert(0, Blocked())
import importlib
import torch
torch.set_num_threads(1)
root, pair = sys.argv[1], sys.argv[2]
runs = {"exp_align": [pair, "1"], "exp_dphist": [pair],
        "exp_seedprof": [pair, "1"], "seed_stats": [root + "/" + pair],
        "exp_seedab": [pair]}
for name, argv in runs.items():
    print(f"@@ {name}", flush=True)
    mod = importlib.import_module(f"gsalign_tpu_torch.tools.{name}")
    assert mod.main(argv + ["--dir", root, "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gsalign_tpu"))
print(f"@@ imported {bad}", flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """{"jax": {tool: (stdout, stderr)}, "port": {tool: stdout lines}}."""
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.index.io import save_index
    root = tmp_path_factory.mktemp("probes")
    jax_dir, port_dir = root / "jax", root / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    ref, qry = make_pair(total_len=200_000)
    write_fasta(str(jax_dir / "ref.fa"), ref)
    write_fasta(str(jax_dir / "qry.fa"), qry)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        save_index(build_fmindex(pack_genome(
            read_fasta(str(jax_dir / "ref.fa")))), str(jax_dir / "ref_idx"))
    finally:
        torch.set_num_threads(n)
    for f in os.listdir(jax_dir):
        os.symlink(jax_dir / f, port_dir / f)
    tag = f"torch_probes_{uuid.uuid4().hex}"
    link = os.path.join(JAX_BENCH, tag)
    os.makedirs(JAX_BENCH, exist_ok=True)
    os.symlink(jax_dir, link)
    request.addfinalizer(lambda: os.unlink(link))
    jax_env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    jax_env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_argv = {"exp_align": [tag, "1"], "exp_dphist": [tag],
                "exp_seedprof": [tag, "1"], "seed_stats": [link],
                "exp_seedab": [tag]}
    procs = {name: subprocess.Popen(
        [sys.executable, f"tools/{name}.py", *argv], cwd=REPO, env=jax_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in jax_argv.items()}
    port = subprocess.Popen(
        [sys.executable, "-c", PORT_RUN, str(root), "port"], cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    jax = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"JAX {name}: {err[-3000:]}"
        jax[name] = (out, err)
    out, err = port.communicate(timeout=600)
    assert port.returncode == 0, err[-3000:]
    sections = {}
    for part in out.split("@@ ")[1:]:
        head, _, body = part.partition("\n")
        sections[head] = body.splitlines()
    return {"jax": jax, "port": sections}


def port_json(runs, tool) -> dict:
    return json.loads(runs["port"][tool][-1])


def test_port_tools_import_nothing_of_the_jax_side(runs):
    assert "imported []" in runs["port"]
    assert all(tool in runs["port"] for tool in TOOLS)


def test_exp_align_problems_and_buckets_equal_jax_tool(runs):
    m = re.search(r"rep0: (\{.*?\}) n_dp: (\d+) buckets: (\{.*\})",
                  runs["jax"]["exp_align"][0])
    times, n_dp, buckets = (ast.literal_eval(m.group(1)), int(m.group(2)),
                            ast.literal_eval(m.group(3)))
    rep = port_json(runs, "exp_align")["reps"][0]
    assert rep["n_dp"] == n_dp > 0
    assert {int(k): v for k, v in rep["buckets"].items()} == buckets
    assert tuple(rep["times"]) == tuple(times) == STAGES
    assert rep["launches"] == []          # recorded on a card only
    assert any(ln.startswith(f"rep0: {{'chain': ") and
               f"n_dp: {n_dp} buckets: {buckets}" in ln
               for ln in runs["port"]["exp_align"])


def test_exp_dphist_histogram_equals_jax_tool(runs):
    out, err = runs["jax"]["exp_dphist"]
    dp_line = [ln for ln in err.splitlines() if ln.startswith("[dp_stats]")]
    hits = [ln for ln in out.splitlines() if ln.startswith("lanes=")]
    stages = ast.literal_eval(out.split("stage_times:", 1)[1].strip())
    port = port_json(runs, "exp_dphist")
    assert port["dp_stats"] == dp_line[0]
    assert hits[0] in runs["port"]["exp_dphist"]
    assert f"lanes={port['lanes']} emit-per-lane" in hits[0]
    assert tuple(port["stage_times"]) == tuple(stages)
    assert port["alignments"] > 0 and port["card"] == "cpu"


def jax_seedprof_rounds(out: str) -> list:
    rounds = [m.groups() for m in re.finditer(
        r"round \d+: lanes=\s*(\d+) iters=\s*(\d+)", out)]
    iters = [m.groups() for m in re.finditer(
        r"finish_iters: max=(\d+) mean=(\d+) p50/75/90/99=\[(.*?)\] "
        r"integral=(\d+) \(([\d.]+)% of B\*max\)", out)]
    assert rounds and len(rounds) == len(iters)
    # numpy 2 prints the percentiles as np.int64(...)
    return [(int(lanes), int(it), int(mx), int(mean),
             ast.literal_eval(re.sub(r"np\.\w+\((\d+)\)", r"\1",
                                     f"[{ps}]")),
             int(integral), pct)
            for (lanes, it), (mx, mean, ps, integral, pct) in
            zip(rounds, iters)]


def test_exp_seedprof_rounds_equal_jax_tool(runs):
    out = runs["jax"]["exp_seedprof"][0]
    seeds = int(re.search(r"rep 0: total=[\d.]+s seeds=(\d+)", out).group(1))
    prof = port_json(runs, "exp_seedprof")
    rep = prof["reps"][0]
    assert rep["seeds"] == seeds > 0
    assert [(r["lanes"], r["steps"], r["steps"], round(r["mean"]),
             r["p50_75_90_99"], r["integral"], f"{r['integral_pct']:.1f}")
            for r in rep["rounds"]] == jax_seedprof_rounds(out)
    for name in ("t3", "comb_pairs", "sa_rows", "text_rows"):
        assert prof["tables"][name][0] > 0
    assert prof["trace"] is None          # GSALIGN_TRACE unset
    assert all(r["wall_s"] > 0 for r in rep["rounds"])
    assert 0 <= rep["host_s"] < rep["total_s"]


def test_seed_stats_rounds_equal_jax_tool(runs):
    out = runs["jax"]["seed_stats"][0]
    jax_rows = [tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"slab B=\s*(\d+) fetchwait=[\d.]+s max_iter=\s*(\d+) p50=(\d+) "
        r"p90=(\d+) p99=(\d+) lanes=(\d+)", out)]
    total = int(re.search(r"total_max_iters=(\d+)", out).group(1))
    port = port_json(runs, "seed_stats")["dirs"][0]
    assert [(r["B"], r["max_iter"], *r["p50_90_99"], r["lanes"])
            for r in port["rounds"]] == jax_rows
    assert len(jax_rows) == 2             # a round a query chromosome
    assert all(r["fetchwait_s"] > 0 for r in port["rounds"])
    assert port["total_max_iters"] == total > 0


def test_exp_seedab_steps_equal_jax_tool(runs):
    out = runs["jax"]["exp_seedab"][0]
    jax_rows = [(bool(int(on)), int(it), same == "True") for on, it, same in
                re.findall(r"init12=(\d) slab=\d+ wall=[\d.]+s iters=(\d+) "
                           r"same=(\w+)", out)]
    rows = port_json(runs, "exp_seedab")["tags"][0]["rows"]
    assert [(r["init12"], r["iters"], r["same"]) for r in rows] == jax_rows
    assert jax_rows[1][1] > jax_rows[0][1] and jax_rows[1][2]


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_default_to_the_card_and_raise_without_one(monkeypatch,
                                                         tmp_path, tool):
    import importlib
    mod = importlib.import_module(f"gsalign_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []     # nothing made before the check


def test_device_ops_counts_the_union_of_device_intervals():
    """utils/trace.device_ops (exp_seedprof's and chip_smoke's device busy
    share): overlapping device operations count once, host events not at
    all."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    from gsalign_tpu_torch.utils.trace import device_ops

    def event(name, start, end, kind=DeviceType.CUDA):
        return SimpleNamespace(
            name=name, device_type=kind, time_range=SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))
    prof = SimpleNamespace(events=lambda: [
        event("k", 0, 10), event("k", 5, 15), event("m", 20, 30),
        event("m", 22, 24), event("host", 0, 100, DeviceType.CPU)])
    assert device_ops(prof) == {"n": 4, "busy_s": 25e-6,
                                "ops": {"k": [2, 20.0], "m": [2, 12.0]}}


def test_device_trace_yields_its_profiler(monkeypatch, tmp_path):
    """device_trace yields the profiler under a trace directory (None
    without one); on the CPU it holds no device operation."""
    from gsalign_tpu_torch.utils.trace import device_ops, device_trace
    monkeypatch.delenv("GSALIGN_TRACE", raising=False)
    with device_trace() as prof:
        assert prof is None
    with device_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert device_ops(prof) == {"n": 0, "busy_s": 0.0, "ops": {}}
    assert len(os.listdir(tmp_path)) == 1
