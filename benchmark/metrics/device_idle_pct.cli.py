"""device_idle_pct.cli: share of the traced window in which no operation ran
on the card (torch.profiler)."""

import metric_lib


def read(ctx):
    return metric_lib.idle_pct(ctx)
