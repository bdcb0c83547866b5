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
    """A checkout-like directory holding a BENCHMARK.json whose cells run
    one small configuration (chromosomes of `lengths`) under the real
    traffic mixes, each judging one of its first judge_from pairs; and its
    traffic directory. Returns (root, traffic dir)."""
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(os.path.join(BENCH, "configs", "synth_celegans.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny"
    cfg["chromosomes"] = [[f"c{i}", n] for i, n in enumerate(lengths)]
    cfg["genome_seed"] = 5
    os.makedirs(os.path.join(root, "cfg"), exist_ok=True)
    with open(os.path.join(root, "cfg", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    bench["configs"] = [{"name": "tiny", "source": "https://example.org",
                         "file": "cfg/tiny.json", "reduced": [],
                         "why": "small"}]
    for w in bench["workloads"]:
        w["config"] = "tiny"
        w["name"] = "tiny." + w["traffic"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({"tiny." + x.split(".", 1)[1]
                                     for x in m["workloads"]})
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
