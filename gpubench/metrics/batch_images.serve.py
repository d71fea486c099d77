"""Server: requests per batch the serve loop ran in the window, from
``InferenceServer.metrics`` (``images`` / ``batches``)."""


def read(trace):
    batches = trace.counters.get("batches")
    if not batches:
        return None
    return trace.counters["images"] / batches
