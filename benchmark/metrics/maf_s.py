"""maf_s: seconds a pair making the MAF: thread CPU seconds of span
maf.assemble (the pass-2 workers' row assembly), plus the walls of
maf.write (the chunks to the ordered sink) and sink.close (the residual
disk writes)."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(ctx, wall=("maf.write", "sink.close"),
                                     cpu=("maf.assemble",))
