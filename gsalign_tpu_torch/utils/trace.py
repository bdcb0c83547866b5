"""Tracing / profiling subsystem.

The reference's only observability is stderr progress lines and wall-clock
seconds (src/GSAlign.cpp:482-550, src/main.cpp:301). Here:

- ``StageTimer`` collects per-stage wall times for every pipeline run;
  compare_genomes copies it into RunStats so callers can read a stage breakdown
  without re-instrumenting. Stage names match the JAX package's.
- ``device_trace`` wraps ``torch.profiler`` so a run can be captured as a
  Chrome trace with GSALIGN_TRACE=<dir> or the context manager.
- ``Laps`` cuts a run's timeline into named spans (wall seconds), the time
  outside the stages included; compare_genomes copies them into RunStats.
- ``PhasePeaks`` reads the process's peak resident memory phase by phase.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional, Tuple


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        """Accumulate wall time for a stage. Thread-safe: the parallel
        per-chromosome pass times its stages from worker threads, so
        overlapping stages may sum to more than the wall clock."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def report(self) -> str:
        total = sum(self.totals.values())
        parts = " ".join(f"{k}={v:.2f}s" for k, v in self.totals.items())
        return f"{parts} total={total:.2f}s"


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Capture a torch.profiler trace (CPU, plus CUDA when a card is
    present) into trace_dir (or GSALIGN_TRACE) as a Chrome trace file, and
    yield the profiler (device_ops reads it after the block). No-op,
    yielding None, otherwise."""
    trace_dir = trace_dir or os.environ.get("GSALIGN_TRACE")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_ops(prof) -> dict:
    """The device operations (kernels, copies, sets) of a finished
    torch.profiler profile: their count ("n"), the seconds in which at
    least one ran ("busy_s", the union of their intervals), and per name
    [count, microseconds] ("ops")."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops: Dict[str, list] = {}
    for e in dev:
        op = ops.setdefault(e.name, [0, 0.0])
        op[0] += 1
        op[1] += e.time_range.elapsed_us()
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in dev):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return {"n": len(dev), "busy_s": busy_us / 1e6, "ops": ops}


class Laps:
    """One thread's timeline cut into consecutive named spans: lap(name)
    adds the wall seconds since the previous lap (or since the object was
    made) to spans[name], so the spans of one run sum to its wall. Under
    GSALIGN_TRACE each lap also writes a labelled instant into the
    torch.profiler trace of an enclosing device_trace."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.t = time.time()
        self.traced = bool(os.environ.get("GSALIGN_TRACE"))

    def lap(self, name: str) -> float:
        now = time.time()
        dt = now - self.t
        self.t = now
        self.spans[name] = self.spans.get(name, 0.0) + dt
        if self.traced:
            from torch.profiler import record_function
            with record_function(f"lap:{name}"):
                pass
        return dt


def rss_bytes() -> Tuple[int, int]:
    """(peak, current) resident set of this process in bytes, from
    /proc/self/status (the peak from getrusage where /proc is absent; the
    current then 0)."""
    peak = cur = 0
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
                elif line.startswith("VmRSS:"):
                    cur = int(line.split()[1]) * 1024
    except OSError:
        pass
    if not peak:
        import resource
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return peak, cur


class PhasePeaks:
    """Peak resident memory phase by phase. mark(name) records the peak of
    the phase that ends there (since the previous mark, or since the object
    was made), the RSS at its end and the process's peak so far.

    The phase's peak comes from the kernel: after each mark the peak is
    reset (writing 5 to /proc/self/clear_refs), so the next mark reads its
    own phase alone. Where the reset is refused (`resets` False), a daemon
    thread samples the RSS every `interval` seconds instead, and the
    phase's peak is the largest sample (a spike shorter than the interval
    can pass unseen; the peak so far cannot). stop() ends that thread
    before a stage whose time is measured: a phase marked after it reads
    its RSS at the mark only. The reset also moves getrusage's ru_maxrss,
    which a process that uses this class therefore cannot read as its
    whole-run peak: `peak` is that."""

    def __init__(self, interval: float = 0.02):
        self.marks = []
        self._hwm = 0                    # the largest peak marked so far
        self.resets = self._reset()
        self._lock = threading.Lock()
        self._sampled = rss_bytes()[1]
        self._stop = threading.Event()
        self._sampler = None
        if not self.resets:
            self._sampler = threading.Thread(
                target=self._sample, args=(interval,), daemon=True)
            self._sampler.start()

    @staticmethod
    def _reset() -> bool:
        try:
            with open("/proc/self/clear_refs", "w") as fh:
                fh.write("5")
            return True
        except OSError:
            return False

    def _sample(self, interval: float) -> None:
        while not self._stop.is_set():
            cur = rss_bytes()[1]
            with self._lock:
                self._sampled = max(self._sampled, cur)
            self._stop.wait(interval)

    def stop(self) -> None:
        """End the sampling thread, if one runs, and wait for it."""
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join()

    def mark(self, name: str) -> dict:
        hwm, cur = rss_bytes()
        if self.resets:
            peak = hwm
            self._reset()
        else:
            with self._lock:
                peak = max(self._sampled, cur)
                self._sampled = cur
        self._hwm = max(self._hwm, hwm, peak)
        m = {"phase": name, "peak_rss": peak, "rss": cur,
             "peak_so_far": self._hwm}
        self.marks.append(m)
        return m

    @property
    def peak(self) -> int:
        """The largest peak of any phase so far (now included)."""
        return max([rss_bytes()[0], self._hwm]
                   + [m["peak_rss"] for m in self.marks])
