"""plan_s: seconds a pair planning the DP problems and submitting them in
pass 1: the walls of spans plan (generate.plan_alignments) and dp.submit
(ops/dp.FragmentAligner.submit, with its packing, uploads and the launches
of full buckets)."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(ctx, wall=("plan", "dp.submit"))
