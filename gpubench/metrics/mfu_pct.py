"""The whole model step: images whose answers reached the host in the
window times the frozen operations per image (``flops.py``), over the
window and the H100's dense int8 peak, in percent."""

from flops import PEAK_INT8_OPS


def read(trace):
    if not trace.images or not trace.ops_per_image:
        return None
    return (100.0 * trace.images * trace.ops_per_image
            / (trace.window_s * PEAK_INT8_OPS))
