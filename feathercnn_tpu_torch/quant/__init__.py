from .calibrate import calibrate
from .qscheme import quantize_tensor_scale, quantize_weight_per_channel
from .rewrite import quantize_graph

__all__ = ["calibrate", "quantize_graph", "quantize_weight_per_channel",
           "quantize_tensor_scale"]
