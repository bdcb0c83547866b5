"""cli_mbp_per_s: query megabases a second when each pair is one whole
CLI request in process: load_index, layout, read_fasta, compare_genomes
(host clock)."""

import metric_lib


def read(ctx):
    return metric_lib.mbp_per_s(ctx)
