"""Server: the share of the batch slots' images that were padding,
``pad_images / (images + pad_images)`` from ``InferenceServer.metrics``
over the window."""


def read(trace):
    c = trace.counters
    total = c.get("images", 0) + c.get("pad_images", 0)
    if not total:
        return None
    return 100.0 * c["pad_images"] / total
