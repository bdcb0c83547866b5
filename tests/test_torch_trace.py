"""The tracing helpers of both packages: tests/test_trace.py's cases
(StageTimer, device_trace without a directory, the bufpool round trip
through the output sink), each run through the JAX package (gsalign_tpu)
and the port (gsalign_tpu_torch); and the port's own torch.profiler path:
with GSALIGN_TRACE set, device_trace writes one Chrome trace that loads."""

import importlib
import json
import time

import numpy as np
import pytest

PKGS = ("gsalign_tpu", "gsalign_tpu_torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def trace_mod(pkg):
    return importlib.import_module(f"{pkg}.utils.trace")


def test_stage_timer_accumulates(pkg):
    t = trace_mod(pkg).StageTimer()
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


def test_laps_cut_a_timeline_into_spans():
    """The port's Laps: each lap adds the time since the one before to its
    name's span; the laps of a timeline sum to its wall."""
    from gsalign_tpu_torch.utils import trace
    t0 = time.time()
    laps = trace.Laps()
    time.sleep(0.02)
    a = laps.lap("a")
    b = laps.lap("b")
    time.sleep(0.01)
    a2 = laps.lap("a")
    wall = time.time() - t0
    assert a >= 0.02 and a2 >= 0.01 and b < 0.01
    assert list(laps.spans) == ["a", "b"]
    assert abs(laps.spans["a"] - (a + a2)) < 1e-9
    assert abs(sum(laps.spans.values()) - wall) < 0.005


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
