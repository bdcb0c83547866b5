"""seed_s: seconds a pair in the seed stage (ops/seeding.find_seeds_all
with ops/seed_cuda): span seed."""

import metric_lib


def read(ctx):
    return metric_lib.span_per_pair(ctx, "seed")
