"""feathercnn_tpu_torch — the PyTorch/CUDA port of feathercnn_tpu.

The same Caffe-shaped IR, graph passes and int8 quantization as the JAX
package, lowered eagerly to PyTorch; the int8 1x1 convs, 3x3 convs,
depthwise convs and fully connected layers run through hand-written CUDA
kernels for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.  The engine runs on
the GPU unless the caller passes ``device="cpu"``, where each kernel's
plain PyTorch version stands in for it.
"""

from .config import EngineConfig
from .engine import Engine
from .ir import Graph, Node, TensorSpec, infer_shapes
from .passes import optimize

__all__ = [
    "Engine",
    "EngineConfig",
    "Graph",
    "Node",
    "TensorSpec",
    "infer_shapes",
    "optimize",
]
