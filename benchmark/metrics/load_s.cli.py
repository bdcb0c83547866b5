"""load_s.cli: seconds a pair in index/io.load_index (the benchmark's own
span around the call)."""

import metric_lib


def read(ctx):
    return metric_lib.span_per_pair(ctx, "load_index")
