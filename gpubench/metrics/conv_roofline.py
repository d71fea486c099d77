"""Kernels: the frozen least time of every conv and FC per image
(``flops.py``: the larger of its operations at the int8 peak and its bytes
at the memory's bandwidth), over the device time per image outside
PyTorch's own kernels and outside copies and sets, in percent.  It could
pass 100 only if conv work moved into PyTorch's own kernels, which the
breakdown would show."""

from harness import device_spans, is_copy, is_torch_op


def read(trace):
    p = trace.profile
    if p is None or not p.images or not trace.least_s_per_image:
        return None
    us = sum(t for k, t in device_spans(p)
             if not is_torch_op(k) and not is_copy(k))
    if us <= 0:
        return None
    return 100.0 * trace.least_s_per_image * 1e6 / (us / p.images)
