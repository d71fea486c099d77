"""Load generator: the 99th percentile of how late a request was sent
after it was due (host clock), over the requests due in the window.
Above a millisecond or so, the host held the generator back and the
latencies carry that wait."""

from harness import percentile


def read(trace):
    if not trace.late_s:
        return None
    return percentile(trace.late_s, 99) * 1e3
