"""Tracing / profiling subsystem.

The reference's only observability is stderr progress lines and wall-clock
seconds (src/GSAlign.cpp:482-550, src/main.cpp:301). Here:

- ``Recorder`` holds one compare_genomes run's spans and counters in
  memory. A span has a name, the span that caused it, its thread, its start
  and end on time.time_ns() and its thread's CPU nanoseconds. The run's
  thread cuts its timeline into top-level spans (``Recorder.top``: each
  closes the one before it, so they partition the run's wall); every other
  span nests under the open span of its own thread, else under the open
  top-level span, on any thread. RunStats.span_times and stage_times are
  derived from the spans.
- The layers under compare_genomes record through ``span``, ``count`` and
  ``copied`` into the recorder bound to their thread (``bind``); with none
  bound they record nothing. No span or counter synchronises a device.
- Under a running torch.profiler each span of the run's thread is also a
  range of its name (a host operation), on the profiler's clock; without
  one no range is entered. Spans of other threads cannot enter the
  profiler (it captures the ranges of the thread that started it), but
  their time.time_ns() is the profiler's clock as well.
- ``record_run`` makes a run's recorder and binds it, puts the run's
  summary into a ring of the process's last RING_RUNS runs
  (``recent_runs``), and under GSALIGN_TRACE=<dir> writes one Chrome trace
  of the whole run, the other threads' spans on rows of their own and the
  run's counters at its end.
- ``device_trace`` wraps ``torch.profiler`` so a block can be captured as a
  Chrome trace with GSALIGN_TRACE=<dir> or a directory; ``device_ops`` sums
  a profile's device operations.
- ``PhasePeaks`` reads the process's peak resident memory phase by phase.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

RING_RUNS = 1024            # runs recent_runs keeps
_RING: collections.deque = collections.deque(maxlen=RING_RUNS)
_RING_LOCK = threading.Lock()
_RUN_IDS = itertools.count(1)
_BOUND = threading.local()  # .rec: the recorder this thread records into
_NULL = contextlib.nullcontext()

def profiler_running() -> bool:
    """Is a torch.profiler recording in this process?"""
    return _autograd_profiler._is_profiler_enabled


# A span's profiler range: a function-scope range. record_function's
# user-scope range would make the profiler add a device event
# (gpu_user_annotation) over the kernels launched inside it, which readers
# of the device events, such as the benchmark's busy time, count as device
# work.
_Range = torch._C._profiler._RecordFunctionFast


class Span:
    """One span of a run: its name, its parent (an index into
    Recorder.spans, -1 for none), its thread (native id), its start and
    end (time.time_ns(); end 0 while open) and the CPU nanoseconds its
    thread spent in it."""
    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "cpu_ns",
                 "_cpu0", "_range")

    def __init__(self, name: str, parent: int, thread: int, ranged: bool):
        """Open now; ranged: also a profiler range, if one records."""
        self.name, self.parent, self.thread = name, parent, thread
        self.end_ns = self.cpu_ns = 0
        self._range = None
        self._cpu0 = time.thread_time_ns()
        self.start_ns = time.time_ns()
        if ranged and profiler_running():
            self._range = _Range(name)
            self._range.__enter__()

    def close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.cpu_ns = time.thread_time_ns() - self._cpu0
        self.end_ns = time.time_ns()

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Open:
    """A span open on the current thread: its context manager."""
    __slots__ = ("rec", "name", "sp", "stack")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> Span:
        rec = self.rec
        stack = getattr(rec._stacks, "open", None)
        if stack is None:
            stack = rec._stacks.open = []
        thread = threading.get_native_id()
        sp = Span(self.name, stack[-1] if stack else rec._top, thread,
                  ranged=thread == rec.thread)
        with rec._lock:
            stack.append(len(rec.spans))
            rec.spans.append(sp)
        self.sp, self.stack = sp, stack
        return sp

    def __exit__(self, *exc) -> bool:
        self.sp.close()
        self.stack.pop()
        return False


class Recorder:
    """One run's spans (in the order they opened) and counters (module
    docstring). Made on the run's thread, which alone calls top() and
    end(); spans (module-level span) and count() are thread-safe."""

    def __init__(self):
        self.run_id = next(_RUN_IDS)
        self.thread = threading.get_native_id()
        self.spans: List[Span] = []
        self.tops: List[int] = []         # the top-level spans' indices
        self.counters: Dict[str, int] = {}
        self._top = -1                    # the open top-level span
        self._lock = threading.Lock()
        self._stacks = threading.local()  # .open: a thread's open spans

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lock"], state["_stacks"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._stacks = threading.local()

    def top(self, name: str) -> None:
        """Close the open top-level span and open `name` where it ends."""
        now = self.end()
        sp = Span(name, -1, self.thread, ranged=True)
        if now is not None:
            sp.start_ns = now
        with self._lock:
            self._top = len(self.spans)
            self.tops.append(self._top)
            self.spans.append(sp)

    def end(self) -> Optional[int]:
        """Close the open top-level span (the run's end, when it is the
        last); returns where it ended, None if none was open."""
        if self._top < 0:
            return None
        sp = self.spans[self._top]
        sp.close()
        self._top = -1
        return sp.end_ns

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    @property
    def start_ns(self) -> int:
        return self.spans[self.tops[0]].start_ns if self.tops else 0

    @property
    def end_ns(self) -> int:
        return self.spans[self.tops[-1]].end_ns if self.tops else 0

    def span_times(self) -> Dict[str, float]:
        """Seconds by top-level span name, in order of first use: the run's
        wall in parts."""
        out: Dict[str, float] = {}
        for i in self.tops:
            sp = self.spans[i]
            out[sp.name] = out.get(sp.name, 0.0) + sp.wall_ns / 1e9
        return out

    def stage_times(self, stages) -> Dict[str, float]:
        """Wall seconds by stage, in order of first use. stages: (stage,
        span names) pairs; a name ending in "." takes every span under it,
        and a span adds to the first stage that names it. Worker threads'
        spans overlap, so the stages may sum to more than the run's
        wall."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            if not sp.end_ns:
                continue
            for stage, names in stages:
                if any(sp.name == n or (n.endswith(".")
                                        and sp.name.startswith(n))
                       for n in names):
                    out[stage] = out.get(stage, 0.0) + sp.wall_ns / 1e9
                    break
        return out

    def seconds(self, name: str) -> List[float]:
        """The wall seconds of each closed span named name, in the order
        they opened."""
        return [sp.wall_ns / 1e9 for sp in self.spans
                if sp.name == name and sp.end_ns]

    def self_ns(self) -> List[int]:
        """Each closed span's wall less the union of its closed children's
        intervals within it (0 for an open span)."""
        kids: Dict[int, list] = {}
        for sp in self.spans:
            if sp.parent >= 0 and sp.end_ns:
                kids.setdefault(sp.parent, []).append((sp.start_ns,
                                                       sp.end_ns))
        out = []
        for i, sp in enumerate(self.spans):
            if not sp.end_ns:
                out.append(0)
                continue
            covered, end = 0, sp.start_ns
            for lo, hi in sorted(kids.get(i, ())):
                lo, hi = max(lo, end), min(hi, sp.end_ns)
                if hi > lo:
                    covered += hi - lo
                    end = hi
            out.append(sp.wall_ns - covered)
        return out

    def summary(self) -> dict:
        """The run in brief: its id, start and end (ns), per span name
        [count, wall s, self s, CPU s], and its counters."""
        by: Dict[str, list] = {}
        for sp, own in zip(self.spans, self.self_ns()):
            if sp.end_ns:
                e = by.setdefault(sp.name, [0, 0.0, 0.0, 0.0])
                e[0] += 1
                e[1] += sp.wall_ns / 1e9
                e[2] += own / 1e9
                e[3] += sp.cpu_ns / 1e9
        with self._lock:
            counters = dict(self.counters)
        return {"run": self.run_id, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "spans": by, "counters": counters}

    def chrome_events(self, base_ns: int) -> list:
        """The spans of threads other than the run's as Chrome trace
        complete events (times in microseconds from base_ns), a row a
        thread, and the run's counters as one instant event
        (gsalign.counters) at its end."""
        pid = os.getpid()
        out, threads = [], set()
        for sp in self.spans:
            if sp.thread == self.thread or not sp.end_ns:
                continue
            threads.add(sp.thread)
            out.append({"ph": "X", "cat": "gsalign_span", "name": sp.name,
                        "pid": pid, "tid": sp.thread,
                        "ts": (sp.start_ns - base_ns) / 1e3,
                        "dur": sp.wall_ns / 1e3,
                        "args": {"run": self.run_id,
                                 "cpu_us": sp.cpu_ns / 1e3}})
        out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                 "args": {"name": f"gsalign worker {t}"}}
                for t in sorted(threads)]
        with self._lock:
            counters = dict(self.counters)
        out.append({"ph": "i", "s": "p", "cat": "gsalign_counters",
                    "name": "gsalign.counters", "pid": pid,
                    "tid": self.thread,
                    "ts": (self.end_ns - base_ns) / 1e3,
                    "args": dict(counters, run=self.run_id)})
        return out


@contextlib.contextmanager
def bind(rec: Optional[Recorder]):
    """Record this thread's spans and counters into rec inside the block."""
    prev = getattr(_BOUND, "rec", None)
    _BOUND.rec = rec
    try:
        yield rec
    finally:
        _BOUND.rec = prev


def span(name: str):
    """A span in the recorder bound to this thread (a context manager that
    records nothing where none is bound)."""
    rec = getattr(_BOUND, "rec", None)
    return _NULL if rec is None else _Open(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add n to a counter of the recorder bound to this thread, if any."""
    rec = getattr(_BOUND, "rec", None)
    if rec is not None:
        rec.count(name, n)


def copied(site: str, nbytes: int, device) -> None:
    """Count nbytes copied between the host and `device` at site (h2d.* or
    d2h.*): copies to or from a CUDA device only."""
    if getattr(device, "type", None) == "cuda":
        count(site, int(nbytes))


@contextlib.contextmanager
def record_run():
    """A run's Recorder, bound to this thread inside the block. At its end
    the open top-level span closes and the run's summary joins the ring
    (recent_runs). Under GSALIGN_TRACE the whole block is one Chrome trace
    (device_trace), with the other threads' spans and the counters."""
    rec = Recorder()
    with device_trace(extra_events=rec.chrome_events), bind(rec):
        try:
            yield rec
        finally:
            rec.end()
            summary = rec.summary()
            with _RING_LOCK:
                _RING.append(summary)


def recent_runs() -> list:
    """The summaries (Recorder.summary) of the process's last RING_RUNS
    runs, oldest first."""
    with _RING_LOCK:
        return list(_RING)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None, extra_events=None):
    """Capture a torch.profiler trace (CPU, plus CUDA when a card is
    present) into trace_dir (or GSALIGN_TRACE) as a Chrome trace file, and
    yield the profiler (device_ops reads it after the block). No-op,
    yielding None, without a directory or while a profiler already records
    (a process runs one). extra_events(base_ns), when given, returns
    Chrome trace events, timed in microseconds from base_ns, that join the
    file."""
    trace_dir = trace_dir or os.environ.get("GSALIGN_TRACE")
    if not trace_dir or profiler_running():
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
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if extra_events is not None:
        with open(path) as fh:
            doc = json.load(fh)
        # event times count from baseTimeNanoseconds where the file names
        # one, else from the epoch
        extra = extra_events(int(doc.get("baseTimeNanoseconds", 0)))
        if extra:
            doc["traceEvents"].extend(extra)
            with open(path, "w") as fh:
                json.dump(doc, fh)


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
