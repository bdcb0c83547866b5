"""What the metric readers (metrics/<name>.py) share.

A reader is `read(ctx) -> float | None`. ctx holds the window's pairs
(each with its host-clock start, end, wall, query bases and spans, and in
a traced run the DP cells of its kernel launches), the window's seconds,
the set-up seconds and, in a traced run, the trace's summary (`trace`:
busy_s, window_s, ops {name: [count, seconds]}, idle {span: seconds}). A
reader that finds nothing to read returns None.
"""

from __future__ import annotations

import yardstick


def done(ctx) -> list:
    """The pairs of the window that completed."""
    return [p for p in ctx["pairs"] if "spans" in p]


def span_per_pair(ctx, *names):
    """Seconds a pair of the named spans, over the window's pairs."""
    pairs = done(ctx)
    if not pairs or not any(n in pairs[0]["spans"] for n in names):
        return None
    return sum(p["spans"].get(n, 0.0) for p in pairs for n in names) \
        / len(pairs)


def mbp_per_s(ctx):
    pairs = done(ctx)
    if not pairs:
        return None
    return sum(p["bases"] for p in pairs) / 1e6 / ctx["window_s"]


def kernel_seconds(ctx, *names):
    """Device seconds of the trace's operations whose name holds one of
    names (None without a trace or without such an operation)."""
    tr = ctx.get("trace")
    if not tr:
        return None
    hits = [v[1] for k, v in tr["ops"].items() if any(n in k for n in names)]
    return sum(hits) if hits else None


def idle_pct(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def dp_roofline_pct(ctx):
    """The least time of the window's DP cells (yardstick.bound of their
    integer operations and bytes) over the DP kernels' device time."""
    t = kernel_seconds(ctx, "dp_small_kernel", "dp_any_kernel")
    cells = sum(p.get("dp_cells", 0) for p in done(ctx))
    if not t or not cells:
        return None
    return 100.0 * yardstick.dp_bound_s(cells) / t
