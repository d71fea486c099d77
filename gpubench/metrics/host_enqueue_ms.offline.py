"""Engine: host milliseconds per ``Engine.run`` call (the benchmark's own
span around each dispatch, before the fetch), averaged over the window."""


def read(trace):
    spans = trace.spans.get("enqueue")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
