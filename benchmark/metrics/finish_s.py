"""finish_s: thread CPU seconds a pair expanding the DP's ops into
alignments in the pass-2 workers (span finish: generate.finish_alignments).
CPU, not wall: the workers share the interpreter lock, so each worker's
wall holds the others' time."""

import span_lib


def read(ctx):
    return span_lib.seconds_per_pair(ctx, cpu=("finish",))
