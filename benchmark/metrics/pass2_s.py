"""pass2_s: seconds a pair in pass 2 and the writers
(generate.finish_alignments, output, variants): spans pass2, emit and
vcf_close."""

import metric_lib


def read(ctx):
    return metric_lib.span_per_pair(ctx, "pass2", "emit", "vcf_close")
