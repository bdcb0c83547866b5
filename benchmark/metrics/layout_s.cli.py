"""layout_s.cli: seconds a pair laying out the device tables
(DeviceFMIndex.from_host: host_tables and from_tables) and the forward +
reverse-complement text (genome.chars_fwd_rc): spans from_host and
chars_fwd_rc."""

import metric_lib


def read(ctx):
    return metric_lib.span_per_pair(ctx, "from_host", "chars_fwd_rc")
