"""dp_wait_s: seconds a pair waiting on the DP (ops/dp.FragmentAligner.finish:
its last launches and the read-back): span dp_finish."""

import metric_lib


def read(ctx):
    return metric_lib.span_per_pair(ctx, "dp_finish")
