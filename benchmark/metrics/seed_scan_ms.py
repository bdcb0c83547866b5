"""seed_scan_ms: device milliseconds a pair of the seed_scan kernel
(ops/seed_cuda) in the trace."""

import metric_lib


def read(ctx):
    t = metric_lib.kernel_seconds(ctx, "seed_scan_kernel")
    pairs = metric_lib.done(ctx)
    if t is None or not pairs:
        return None
    return 1e3 * t / len(pairs)
