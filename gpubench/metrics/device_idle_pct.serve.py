"""Device: the share of the profiled sub-window of serving in which no
kernel, copy or set ran on the card."""

from harness import idle_pct


def read(trace):
    return idle_pct(trace.profile)
