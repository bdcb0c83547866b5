"""chain_s: seconds a pair in pass 1's chain stages (pipeline/align
chain_blocks): the walls of spans chain.group (grouping and chaining),
chain.repair (overlaps, gap and chromosome splits, dedup) and chain.fill
(gap fill)."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(
        ctx, wall=("chain.group", "chain.repair", "chain.fill"))
