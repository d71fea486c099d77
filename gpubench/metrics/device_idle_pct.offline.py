"""Device: the share of the profiled batches' sub-window in which no
kernel, copy or set ran on the card."""

from harness import idle_pct


def read(trace):
    return idle_pct(trace.profile)
