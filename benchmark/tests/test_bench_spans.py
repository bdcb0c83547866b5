"""The readers of the program's own spans and counters (span_lib and the
metrics that use it): traced runs of the small cells report each of them,
a pair whose run is missing from the program's ring, or doubled there,
reads None, and the judged pair is left out of the averages."""

import pytest
import torch

from conftest import write_tiny_root

SEED = 2 ** 31 + 4321
WARM = ("seed_host_s", "chain_s", "plan_s", "finish_s", "maf_s",
        "variants_s", "h2d_mb", "dp_useful_pct")
COLD = ("host_tables_s.cli",)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    r, t = write_tiny_root(str(root))
    return r, t, str(root / "cache")


@pytest.mark.parametrize("cell, names", [("tiny.warm", WARM),
                                         ("tiny.cold", COLD)])
def test_a_traced_run_reports_every_span_metric(tiny, cell, names):
    import run
    r, t, cache = tiny
    torch.set_num_threads(2)
    res = run.run(run.Spec(cell, root=r, traffic_dir=t), SEED, 5.0, True,
                  device="cpu", cache=cache)
    assert res["correct"] is True and res["failed"] == 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(names) <= set(got), sorted(got)
    for n in names:
        assert isinstance(got[n], float) and got[n] >= 0, (n, got[n])
    if cell == "tiny.warm":
        assert got["h2d_mb"] == 0.0            # no CUDA copy on the CPU
        assert 0 < got["dp_useful_pct"] <= 100
        assert got["seed_host_s"] <= got["seed_s"]
        assert got["chain_s"] + got["plan_s"] <= got["pass1_s"]
    else:
        assert 0 < got["host_tables_s.cli"] <= got["layout_s.cli"]


def test_a_pair_without_exactly_one_run_reads_none():
    import run
    from gsalign_tpu_torch.utils import trace
    for _ in range(2):
        with trace.record_run() as rec:
            rec.top("seed")
            with trace.span("seed.lanes"):
                trace.count("h2d.seed", 10)
    a, b = trace.recent_runs()[-2:]
    pair = {"spans": {}, "start": a["start_ns"] / 1e9 - 1e-3}
    for end, want in ((a["start_ns"] / 1e9 - 5e-4, None),
                      (b["start_ns"] / 1e9 + 1e-3, None)):
        ctx = {"pairs": [dict(pair, end=end)], "window_s": 1.0}
        for name in WARM + COLD:
            assert run.metric_reader(name)(ctx) is want, name
    one = {"pairs": [dict(pair, end=(a["start_ns"] + b["start_ns"]) / 2e9)],
           "window_s": 1.0}
    assert run.metric_reader("h2d_mb")(one) == 10 / 1e6
    assert run.metric_reader("seed_host_s")(one) > 0


def test_the_judged_pair_is_left_out_of_the_averages():
    """The judged pair's run must be in the ring like any other, but its
    writers run into the benchmark's pipes, so its spans and counters do
    not join the averages; a window of judged pairs alone reads None."""
    import run
    from gsalign_tpu_torch.utils import trace
    for k in range(2):
        with trace.record_run() as rec:
            rec.top("seed")
            trace.count("h2d.seed", 10 * (k + 1))
    a, b = trace.recent_runs()[-2:]
    mid = (a["start_ns"] + b["start_ns"]) / 2e9
    judged = {"spans": {}, "start": a["start_ns"] / 1e9 - 1e-3, "end": mid,
              "judged": True}
    other = {"spans": {}, "start": mid, "end": b["start_ns"] / 1e9 + 1e-3,
             "judged": False}
    h2d = run.metric_reader("h2d_mb")
    assert h2d({"pairs": [judged, other], "window_s": 1.0}) == 20 / 1e6
    assert h2d({"pairs": [judged], "window_s": 1.0}) is None
    # the judged pair's run is still required
    lost = dict(judged, end=a["start_ns"] / 1e9 - 5e-4)
    assert h2d({"pairs": [lost, other], "window_s": 1.0}) is None
