"""The benchmark's own tests: on the CPU at a small size; those marked
`cuda` need a CUDA card and skip without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one "
        "(run on the card: python -m pytest -m cuda benchmark/tests)")


@pytest.fixture(autouse=True)
def _cuda_only(request):
    if request.node.get_closest_marker("cuda"):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")


def write_tiny_root(root, judge_from: int = 1, lengths=(50_000, 20_000)):
    """A checkout-like directory holding a BENCHMARK.json whose cells are
    the real ones at a small size: each configuration's genome cut to
    chromosomes of `lengths` (its aligner's settings kept), each cell named
    tiny.<its traffic mix> under the real mixes, each judging one of its
    first judge_from pairs; and its traffic directory. Returns (root,
    traffic dir)."""
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    os.makedirs(os.path.join(root, "cfg"), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        name = "tiny_" + c["name"]
        cfg.update(name=name, genome_seed=5, chromosomes=[
            [f"c{i}", n] for i, n in enumerate(lengths)])
        with open(os.path.join(root, "cfg", name + ".json"), "w") as fh:
            json.dump(cfg, fh)
        c.update(name=name, file=f"cfg/{name}.json", reduced=[])
    renamed = {w["name"]: "tiny." + w["traffic"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        w["config"] = "tiny_" + w["config"]
        w["name"] = renamed[w["name"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted(renamed[x] for x in m["workloads"])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    tdir = os.path.join(root, "traffic")
    os.makedirs(tdir, exist_ok=True)
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as fh:
            t = json.load(fh)
        t.update(judge_from=judge_from, judged=1, pool=2)
        with open(os.path.join(tdir, name), "w") as fh:
            json.dump(t, fh)
    return str(root), tdir
