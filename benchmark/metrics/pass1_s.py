"""pass1_s: seconds a pair in pass 1: chaining, block repair, DP planning
and submission (pipeline/chain, blocks, kmer, generate.plan_alignments):
span pass1."""

import metric_lib


def read(ctx):
    return metric_lib.span_per_pair(ctx, "pass1")
