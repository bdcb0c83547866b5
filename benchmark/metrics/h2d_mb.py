"""h2d_mb: megabytes a pair copied from the host to the card, the program's
counters h2d.* (layout, seed, resolve, dp) summed; copies to a CUDA device
only, so a CPU run reads 0."""

import span_lib


def read(ctx):
    got = span_lib.counter_totals(ctx)
    if got is None:
        return None
    totals, n = got
    return sum(v for k, v in totals.items() if k.startswith("h2d.")) \
        / 1e6 / n
