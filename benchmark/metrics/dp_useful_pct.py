"""dp_useful_pct: the share of the DP's launched cells that its problems
need: counters dp.cells (query length x target length, summed) over
dp.padded_cells (each problem's bucket width squared), from the host's
length arrays in ops/dp.FragmentAligner._dispatch."""

import span_lib


def read(ctx):
    got = span_lib.counter_totals(ctx)
    if got is None or not got[0].get("dp.padded_cells"):
        return None
    totals = got[0]
    return 100.0 * totals.get("dp.cells", 0) / totals["dp.padded_cells"]
