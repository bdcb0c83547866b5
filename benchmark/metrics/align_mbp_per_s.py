"""align_mbp_per_s: query megabases aligned a second over the window,
the index resident (host clock)."""

import metric_lib


def read(ctx):
    return metric_lib.mbp_per_s(ctx)
