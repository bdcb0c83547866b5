"""dp_roofline_pct: the least time of the traced window's DP cells (the
cells of every dp_small and dp_any launch, from the inputs the wrappers
keep, times yardstick.DP_OPS_PER_CELL over the integer peak) over the two
kernels' device time in the trace."""

import metric_lib


def read(ctx):
    return metric_lib.dp_roofline_pct(ctx)
