"""variants_s: seconds a pair finding and writing the variants: thread CPU
seconds of span variants.identify (the pass-2 workers'), plus the walls
of variants.merge (the private collectors merged in chromosome order) and
vcf.write."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(
        ctx, wall=("variants.merge", "vcf.write"), cpu=("variants.identify",))
