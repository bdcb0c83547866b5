"""seed_host_s: seconds a pair of the seed stage's host work
(ops/seeding.find_seeds_all): the walls of the seed span's children other
than the scan rounds (seed.scan): seed.lanes (chunk bounds, the query's
concatenation and q_rows upload), seed.hits (record positions, the keep
mask, the segments' reconciliation), seed.expand (occurrence positions)
and seed.split (per-chromosome sort)."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(
        ctx, wall=("seed.lanes", "seed.hits", "seed.expand", "seed.split"))
