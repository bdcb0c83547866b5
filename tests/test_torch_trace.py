"""The tracing helpers of both packages: tests/test_trace.py's cases
(device_trace without a directory, the bufpool round trip through the
output sink) run through the JAX package (gsalign_tpu) and the port
(gsalign_tpu_torch), StageTimer through the JAX package alone (the port
derives its stage times from its spans); the port's own torch.profiler
path: with GSALIGN_TRACE set, device_trace writes one Chrome trace that
loads; and the port's span recorder (utils/trace.Recorder): the top-level
partition, nesting and self time, worker threads, counters, profiler
ranges on the shared clock and none without a profiler, the ring of recent
runs, and compare_genomes' spans, stage times and Chrome trace."""

import glob
import importlib
import io
import json
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gsalign_tpu_torch.utils import trace

PKGS = ("gsalign_tpu", "gsalign_tpu_torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def trace_mod(pkg):
    return importlib.import_module(f"{pkg}.utils.trace")


def test_stage_timer_accumulates():
    t = trace_mod("gsalign_tpu").StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    assert t.totals["a"] >= 0.01
    assert "a=" in t.report() and "total=" in t.report()


def test_device_trace_noop_without_dir(pkg, monkeypatch, tmp_path):
    monkeypatch.delenv("GSALIGN_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace_mod(pkg).device_trace():
        pass
    assert list(tmp_path.iterdir()) == []


def test_bufpool_roundtrip(pkg, tmp_path):
    """Pooled row buffers are reused after the sink's writes complete, and
    the pool rejects views and foreign dtypes."""
    bufpool = importlib.import_module(f"{pkg}.utils.bufpool")
    AsyncSink = importlib.import_module(f"{pkg}.pipeline.output").AsyncSink
    bufpool._POOL.clear()       # other tests share the process-global pool
    b = bufpool.get(1024)
    assert b.dtype == np.uint8 and b.shape[0] >= 1024
    b[:4] = (65, 66, 67, 68)
    sink = AsyncSink()
    p = tmp_path / "out.bin"
    sink.submit(str(p), "wb", [memoryview(b[:4])], recycle=[b])
    sink.close()
    assert p.read_bytes() == b"ABCD"
    b2 = bufpool.get(1024)          # the recycled buffer comes back
    assert b2 is b
    bufpool.put(b2[:10])            # views are rejected
    assert bufpool.get(4) is not None
    bufpool.put(np.zeros(4, dtype=np.int32))   # wrong dtype rejected


def test_device_trace_writes_chrome_trace(monkeypatch, tmp_path):
    """GSALIGN_TRACE=<dir>: a torch op under the port's device_trace lands
    in one Chrome trace file in that directory, which loads as JSON and
    names the op."""
    import torch
    from gsalign_tpu_torch.utils.trace import device_trace
    monkeypatch.setenv("GSALIGN_TRACE", str(tmp_path / "tr"))
    a = torch.arange(64, dtype=torch.int64)
    with device_trace():
        (a * 3).sum()
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    with open(files[0]) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mul" in n for n in names)


def test_phase_peaks_read_each_phase():
    """The port's PhasePeaks: a phase that touches 200 MB for 0.1 s shows
    them in its own peak, the next phase does not (whether the kernel's
    peak is reset or the RSS sampled), and the peak so far keeps them."""
    from gsalign_tpu_torch.utils.trace import PhasePeaks
    pp = PhasePeaks()
    big = np.ones(200_000_000, dtype=np.uint8)
    time.sleep(0.1)                  # seen by the sampler where it runs
    del big
    first = pp.mark("big")
    second = pp.mark("small")
    assert first["peak_rss"] >= first["rss"] > 0
    assert first["peak_rss"] - first["rss"] >= 150_000_000
    assert second["peak_rss"] < first["peak_rss"] - 150_000_000
    assert second["peak_so_far"] >= first["peak_rss"]
    assert pp.peak >= first["peak_rss"]
    pp.stop()


def test_phase_peaks_sample_where_the_reset_is_refused(monkeypatch):
    """Without the kernel's reset, PhasePeaks samples the RSS on a thread:
    the phases read apart all the same."""
    from gsalign_tpu_torch.utils import trace
    monkeypatch.setattr(trace.PhasePeaks, "_reset",
                        staticmethod(lambda: False))
    test_phase_peaks_read_each_phase()


def test_phase_peaks_stop_ends_the_sampler(monkeypatch):
    """stop() ends the sampling thread; a mark after it still reads the
    RSS at the mark and the peak so far."""
    from gsalign_tpu_torch.utils import trace
    monkeypatch.setattr(trace.PhasePeaks, "_reset",
                        staticmethod(lambda: False))
    pp = trace.PhasePeaks(interval=0.01)
    assert pp._sampler.is_alive()
    first = pp.mark("before")
    pp.stop()
    assert not pp._sampler.is_alive()
    after = pp.mark("after")
    assert after["peak_rss"] >= after["rss"] > 0
    assert after["peak_so_far"] >= first["peak_rss"]


# ---------------------------------------------------------------- recorder
def test_top_level_spans_partition_the_run_wall():
    """Each top-level span closes the one before it: span_times sums, by
    name in order of first use, to the run's wall within 1 ms."""
    t0 = time.time_ns()
    with trace.record_run() as rec:
        rec.top("a")
        time.sleep(0.02)
        rec.top("b")
        rec.top("a")
        time.sleep(0.01)
    wall = time.time_ns() - t0
    times = rec.span_times()
    assert list(times) == ["a", "b"] and times["a"] >= 0.03
    run = (rec.end_ns - rec.start_ns) / 1e9
    assert abs(sum(times.values()) - run) < 1e-3
    assert 0 <= wall / 1e9 - run < 5e-3
    tops = [rec.spans[i] for i in rec.tops]
    assert all(x.end_ns == y.start_ns for x, y in zip(tops, tops[1:]))


def test_spans_nest_under_their_parents_and_keep_self_time():
    """A span's parent is the open span of its thread, else the open
    top-level span; its self time is its wall less its children's."""
    with trace.record_run() as rec:
        rec.top("top")
        with trace.span("p"):
            with trace.span("c"):
                time.sleep(0.02)
            time.sleep(0.01)
        with trace.span("q"):
            pass
    names = [sp.name for sp in rec.spans]
    assert names == ["top", "p", "c", "q"]
    top, p, c, q = rec.spans
    assert (top.parent, p.parent, c.parent, q.parent) == (-1, 0, 1, 0)
    own = rec.self_ns()
    assert own[2] == c.wall_ns and c.wall_ns >= 20e6
    assert own[1] == p.wall_ns - c.wall_ns and own[1] >= 10e6
    assert own[0] == top.wall_ns - p.wall_ns - q.wall_ns
    summ = rec.summary()["spans"]
    assert summ["p"][0] == 1 and abs(summ["p"][2] - own[1] / 1e9) < 1e-9


def test_worker_thread_spans_carry_their_thread_and_cpu_time():
    """Spans of threads bound to the run nest under the open top-level
    span, with their own thread; a sleeping span spends little CPU."""
    with trace.record_run() as rec:
        rec.top("pass2")

        def work():
            with trace.bind(rec), trace.span("finish"):
                time.sleep(0.03)
        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    fin = [sp for sp in rec.spans if sp.name == "finish"]
    assert len(fin) == 3 and len({sp.thread for sp in fin}) == 3
    assert all(sp.thread != rec.thread and sp.parent == rec.tops[0]
               for sp in fin)
    assert all(sp.wall_ns >= 30e6 and sp.cpu_ns < sp.wall_ns / 2
               for sp in fin)
    # the workers overlap: the parent's self time never goes negative
    assert rec.self_ns()[0] >= 0


def test_counters_and_copies_go_to_the_bound_recorder():
    """count adds to the bound recorder's counters (nothing without one);
    copied counts CUDA copies only; a recorder survives pickling (the
    multi-process runs pickle RunStats)."""
    trace.count("lost", 5)
    with trace.record_run() as rec:
        rec.top("a")
        trace.count("dp.problems", 3)
        trace.count("dp.problems", 4)
        trace.count("seed.rounds")
        trace.copied("h2d.dp", 100, torch.device("cpu"))
        trace.copied("h2d.dp", 64, torch.device("cuda", 0))
        trace.copied("d2h.dp", 8, torch.device("cuda"))
    assert rec.counters == {"dp.problems": 7, "seed.rounds": 1,
                            "h2d.dp": 64, "d2h.dp": 8}
    assert getattr(trace._BOUND, "rec", None) is None
    back = pickle.loads(pickle.dumps(rec))
    assert back.counters == rec.counters and \
        back.span_times() == rec.span_times()
    assert trace.recent_runs()[-1]["counters"] == rec.counters


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """With no profiler running no span enters a profiler range; under
    one, the run's thread's spans do and other threads' do not."""
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(trace, "_Range", Range)

    def run():
        with trace.record_run() as rec:
            rec.top("a")
            with trace.span("b"):
                pass
            t = threading.Thread(target=work, args=(rec,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    def work(rec):
        with trace.bind(rec), trace.span("w"):
            pass
    monkeypatch.setattr(trace._autograd_profiler, "_is_profiler_enabled",
                        False)
    run()
    assert entered == []
    monkeypatch.setattr(trace._autograd_profiler, "_is_profiler_enabled",
                        True)
    run()
    assert entered == ["a", "b"]


def test_main_thread_spans_are_profiler_ranges_on_the_shared_clock():
    """Under a CPU torch.profiler the run's spans are ranges of their
    names, nested as recorded, starting within 1 ms of their records on
    the profiler's clock (its start plus the event's offset); host
    operations, not user annotations, so the profiler adds no device event
    over the kernels inside them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.record_run() as rec:
            rec.top("outer")
            with trace.span("inner"):
                torch.ones(64).sum()
                time.sleep(0.005)
            rec.top("after")
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()
              if e.name in ("outer", "inner", "after")}
    assert set(events) == {"outer", "inner", "after"}
    assert not any(e.is_user_annotation for e in events.values())
    for sp in rec.spans:
        e = events[sp.name]
        assert abs(base + e.time_range.start * 1000 - sp.start_ns) < 1e6
        assert abs(base + e.time_range.end * 1000 - sp.end_ns) < 1e6
    assert events["inner"].time_range.start >= \
        events["outer"].time_range.start
    assert events["inner"].time_range.end <= events["outer"].time_range.end


def test_the_ring_of_recent_runs_is_bounded_and_thread_safe():
    """Threads that finish runs at once lose none: the ring holds the last
    RING_RUNS of them, each once."""
    n_threads, per = 12, trace.RING_RUNS // 12 + 8
    ids = [[] for _ in range(n_threads)]

    def runs(k):
        for _ in range(per):
            with trace.record_run() as rec:
                rec.top("a")
                trace.count("n")
            ids[k].append(rec.run_id)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=runs, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    ring = trace.recent_runs()
    mine = {i for k in ids for i in k}
    assert len(mine) == n_threads * per > trace.RING_RUNS
    assert len(ring) == trace.RING_RUNS
    got = [r["run"] for r in ring]
    assert len(set(got)) == len(got) and set(got) <= mine
    assert all(r["counters"] == {"n": 1} for r in ring)


@pytest.fixture(scope="module")
def small_pair():
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from tests.make_testdata import make_pair
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ref, qry = make_pair(total_len=60_000, seed=12, inversion=False)
    yield build_fmindex(pack_genome(ref)), qry
    torch.set_num_threads(n)


SPAN_KEYS = ("setup", "chars_fwd_rc", "from_host", "query_codes", "seed",
             "pass1", "dp_finish", "pass2", "emit", "vcf_close")
STAGE_KEYS = ("seed", "chain", "align", "output", "variants")


def test_compare_genomes_keeps_its_span_and_stage_keys(small_pair,
                                                       tmp_path,
                                                       monkeypatch):
    """span_times keeps its ten top-level spans in order, summing to the
    run's wall within 1 ms; stage_times its five stages in order, each the
    sum of its spans; the pass-2 spans run on the workers; the run's
    summary is the ring's newest."""
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    monkeypatch.delenv("GSALIGN_TRACE", raising=False)
    fm, qry = small_pair
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    stats, _, _ = compare_genomes(fm, qry, AlignConfig(), verbose=True,
                                  output_prefix=str(tmp_path / "o"),
                                  device="cpu")
    rec = stats.trace
    assert tuple(stats.span_times) == SPAN_KEYS
    assert abs(sum(stats.span_times.values())
               - (rec.end_ns - rec.start_ns) / 1e9) < 1e-3
    assert tuple(stats.stage_times) == STAGE_KEYS
    walls = {}
    for sp in rec.spans:
        walls[sp.name] = walls.get(sp.name, 0) + sp.wall_ns / 1e9
    assert stats.stage_times["chain"] == pytest.approx(
        walls["chain.group"] + walls["chain.repair"] + walls["chain.fill"])
    assert stats.stage_times["seed"] == pytest.approx(walls["seed"])
    workers = {sp.name for sp in rec.spans if sp.thread != rec.thread}
    assert workers == {"finish", "maf.assemble", "variants.identify"}
    names = {sp.name for sp in rec.spans}
    assert {"layout.host_tables", "layout.upload", "seed.scan",
            "seed.hits", "dp.launch", "dp.readback", "maf.write",
            "vcf.write", "sink.close"} <= names
    assert rec.counters["dp.padded_cells"] >= rec.counters["dp.cells"] > 0
    assert rec.counters["seed.rounds"] >= 1
    assert trace.recent_runs()[-1]["run"] == rec.run_id
    line = [ln for ln in err.getvalue().splitlines() if "[stages]" in ln]
    assert line and line[0].strip().startswith("[stages] seed=")
    line = [ln for ln in err.getvalue().splitlines() if "[counters]" in ln]
    assert line and line[0].split()[1:] == [
        f"{k}={v}" for k, v in sorted(rec.counters.items())]


def test_gsalign_trace_writes_one_chrome_trace_a_run(small_pair, tmp_path,
                                                     monkeypatch):
    """GSALIGN_TRACE=<dir>: one Chrome trace for the whole run, loading as
    JSON, with the run's thread's spans as ranges and the pass-2 workers'
    spans on rows of their own, placed on the trace's clock."""
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    monkeypatch.setenv("GSALIGN_TRACE", str(tmp_path / "tr"))
    fm, qry = small_pair
    stats, _, _ = compare_genomes(fm, qry, AlignConfig(), verbose=False,
                                  output_prefix=str(tmp_path / "o"),
                                  device="cpu")
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        doc = json.load(fh)
    rec = stats.trace
    by = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            by.setdefault(e["name"], []).append(e)
    assert {"seed.scan", "chain.group", "finish", "pass1"} <= set(by)
    assert all(e["tid"] != rec.thread for e in by["finish"])
    assert by["chain.group"][0]["tid"] == rec.thread
    base = int(doc.get("baseTimeNanoseconds", 0))
    fin = [sp for sp in rec.spans if sp.name == "finish"]
    assert sorted(e["ts"] for e in by["finish"]) == pytest.approx(
        sorted((sp.start_ns - base) / 1e3 for sp in fin))
    scan = [sp for sp in rec.spans if sp.name == "seed.scan"][0]
    assert abs(by["seed.scan"][0]["ts"] * 1e3 + base - scan.start_ns) < 1e6
    counters = [e for e in doc["traceEvents"]
                if e.get("name") == "gsalign.counters"]
    assert len(counters) == 1
    assert counters[0]["args"] == dict(rec.counters, run=rec.run_id)
    assert counters[0]["ts"] == pytest.approx((rec.end_ns - base) / 1e3)


def test_dp_stats_line_from_the_bucket_counters(monkeypatch):
    """GSALIGN_DP_STATS=1: the [dp_stats] line from FragmentAligner's
    bucket counters reads as the recount of its fragments did."""
    from gsalign_tpu_torch.ops import dp
    rng = np.random.default_rng(3)
    frags = [(rng.integers(0, 4, n).astype(np.uint8),
              rng.integers(0, 4, m).astype(np.uint8))
             for n, m in rng.integers(1, 300, (40, 2))]
    hist = {}
    for rf, qf in frags:
        Lb = dp.bucket_of(max(len(rf), len(qf)), (64, 128, 256, 512))
        hist[Lb] = hist.get(Lb, 0) + 1
    want = "[dp_stats] " + " ".join(
        f"L{Lb}:n={hist[Lb]},Mcells={hist[Lb] * Lb * Lb / 1e6:.0f}"
        for Lb in sorted(hist))
    monkeypatch.setenv("GSALIGN_DP_STATS", "1")
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    def no_dp(q, t, ql, tl, L):             # the counts need no DP
        return torch.full((q.shape[0], 2 * L), dp.OP_PAD, dtype=torch.uint8)
    fa = dp.FragmentAligner(bucket_sizes=(64, 128, 256, 512),
                            batch_cells=1 << 16, dp_fn=no_dp, device="cpu")
    with trace.record_run() as rec:
        rec.top("dp")
        fa.submit([f[0] for f in frags[:25]], [f[1] for f in frags[:25]])
        fa.submit([f[0] for f in frags[25:]], [f[1] for f in frags[25:]])
        fa.finish()
    assert err.getvalue().strip() == want
    assert rec.counters["dp.problems"] == len(frags)
    assert rec.counters["dp.padded_cells"] == sum(
        n * Lb * Lb for Lb, n in hist.items())
    assert rec.counters["dp.problems"] == len(frags)
    assert rec.counters["dp.cells"] == sum(len(a) * len(b) for a, b in frags)
    assert rec.counters["dp.padded_cells"] == sum(
        n * Lb * Lb for Lb, n in hist.items())
    assert rec.counters["dp.launches"] >= len(hist)
