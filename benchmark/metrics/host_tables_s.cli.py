"""host_tables_s.cli: seconds a pair building the device tables on the host
(span layout.host_tables: ops/rank.DeviceFMIndex.host_tables, on the
layout cache's miss in from_host), the upload apart."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(ctx, wall=("layout.host_tables",))
