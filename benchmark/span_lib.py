"""What the readers of the program's own spans and counters share.

The program (gsalign_tpu_torch.utils.trace) keeps a summary of each of its
last runs in a ring (recent_runs): per span name [count, wall seconds,
self seconds, thread CPU seconds], and the run's counters. A pair of the
window is one compare_genomes run: the run whose start lies in the pair's
[start, end]. A program without the ring, or a window in which a completed
pair has no run or more than one, gives None. The judged pair's writers
run into the benchmark's pipes, which stall its sink.close and vcf.write
for the harness's reading: its run is found, like every pair's, and left
out of the averages.
"""

from __future__ import annotations

import metric_lib

WALL, CPU = 1, 3      # fields of a span name's entry in a run's summary


def pair_runs(ctx):
    """The run summary of each completed pair of the window that was not
    judged; None if a completed pair has no run or more than one, or if
    every pair was judged."""
    try:
        from gsalign_tpu_torch.utils.trace import recent_runs
    except ImportError:
        return None
    pairs = metric_lib.done(ctx)
    if not pairs:
        return None
    runs = recent_runs()
    out = []
    for p in pairs:
        lo, hi = p["start"] * 1e9, p["end"] * 1e9
        mine = [r for r in runs if lo <= r["start_ns"] <= hi]
        if len(mine) != 1:
            return None
        if not p.get("judged"):
            out.append(mine[0])
    return out or None


def seconds_per_pair(ctx, wall=(), cpu=()):
    """Seconds a pair: the wall seconds of the spans named in `wall` plus
    the thread CPU seconds of those named in `cpu`."""
    runs = pair_runs(ctx)
    if runs is None:
        return None
    total = 0.0
    for r in runs:
        for names, field in ((wall, WALL), (cpu, CPU)):
            for n in names:
                if n in r["spans"]:
                    total += r["spans"][n][field]
    return total / len(runs)


def counter_totals(ctx):
    """{counter: its sum over the window's runs} and the number of pairs,
    or None."""
    runs = pair_runs(ctx)
    if runs is None:
        return None
    totals = {}
    for r in runs:
        for k, v in r["counters"].items():
            totals[k] = totals.get(k, 0) + v
    return totals, len(runs)
