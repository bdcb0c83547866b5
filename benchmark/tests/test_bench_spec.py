"""BENCHMARK.json against the benchmark's contract, and a new cell found
from data files alone."""

import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_keys_names_and_units():
    b = spec()
    assert set(b) == TOP
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_cell_has_its_files_and_metrics():
    import run
    b = spec()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for w in b["workloads"]:
        s = run.Spec(w["name"])
        e2e = [m["name"] for m in s.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert s.per_layer, w["name"]
        for m in s.end_to_end + s.per_layer:
            assert callable(run.metric_reader(m["name"]))
        assert s.per_layer == [m for m in b["per_layer"]
                               if w["name"] in m["workloads"]]


def test_a_new_cell_is_found_from_data_files_alone(tmp_path):
    """A configuration, a traffic mix and a metric added as new files and
    entries are found by name."""
    import run
    root = tmp_path
    b = spec()
    cfg = json.load(open(os.path.join(BENCH, "configs", "synth_ecoli.json")))
    cfg["name"] = "newcfg"
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "configs" / "newcfg.json").write_text(
        json.dumps(cfg))
    tdir = root / "traffic"
    tdir.mkdir()
    (tdir / "newmix.json").write_text(json.dumps(
        {"index": "resident", "pool": 3, "judged": 1, "judge_from": 2,
         "seed_lanes": 1}))
    b["configs"].append({"name": "newcfg", "source": "https://example.org",
                         "file": "benchmark/configs/newcfg.json",
                         "reduced": [], "why": "new"})
    b["workloads"].append({"name": "newcfg.newmix", "config": "newcfg",
                           "traffic": "newmix", "chips": 1, "why": "new"})
    b["end_to_end"][0]["workloads"].append("newcfg.newmix")
    b["per_layer"].append({"name": "new_metric_s", "unit": "s",
                           "better": "lower", "source": "program_span",
                           "layer": "seed stage (ops/seeding.find_seeds_all)",
                           "moves": b["end_to_end"][0]["name"],
                           "workloads": ["newcfg.newmix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    s = run.Spec("newcfg.newmix", root=str(root), traffic_dir=str(tdir))
    assert s.config["name"] == "newcfg" and s.traffic["pool"] == 3
    assert [m["name"] for m in s.per_layer] == ["new_metric_s"]
    assert {m["name"] for m in s.end_to_end} == {
        b["end_to_end"][0]["name"], "setup_s"}
    # a reader in a file of the metric's name is found by that name
    mdir = root / "metrics"
    mdir.mkdir()
    (mdir / "new_metric_s.py").write_text(
        "def read(ctx):\n    return 2.5 * ctx['window_s']\n")
    read = run.metric_reader("new_metric_s", str(mdir))
    assert read({"window_s": 2}) == 5.0


def test_the_sensitive_cell_is_synth_celegans_in_sen_mode():
    """synth_celegans_sen: synth_celegans's genome and mutants with -sen
    stated, its first pair judged, on the same index."""
    import run

    def config(name):
        with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
            return json.load(fh)
    base, sen = config("synth_celegans"), config("synth_celegans_sen")
    for k in ("chromosomes", "genome_seed", "bases", "mutation", "reduced"):
        assert sen[k] == base[k], k
    assert sen["align"] == dict(base["align"], sensitive=True)
    s = run.Spec("synth_celegans_sen.warm_long")
    assert s.traffic["judge_from"] == 1 and s.traffic["index"] == "resident"
    assert [m["name"] for m in s.end_to_end] == ["align_mbp_per_s",
                                                 "setup_s"]
    # every per-layer metric of the default mode's warm cell
    assert [m["name"] for m in s.per_layer] == [
        m["name"] for m in run.Spec("synth_celegans.warm").per_layer]
    assert run.index_dir("c", sen) == run.index_dir("c", base) \
        != run.index_dir("c", config("synth_ecoli"))
