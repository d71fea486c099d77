"""Lowering: device microseconds per image in PyTorch's own kernels
(``at::native`` in the name), over the profiled batches."""

from harness import device_spans, is_torch_op


def read(trace):
    p = trace.profile
    if p is None or not p.images or not p.device:
        return None
    us = sum(t for k, t in device_spans(p) if is_torch_op(k))
    return us / p.images
