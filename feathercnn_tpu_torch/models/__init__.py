from .builder import GraphBuilder
from .zoo import (MODEL_BUILDERS, build_model, mobilenet_v1, mobilenet_v2,
                  resnet50, resnet101, resnet152)

__all__ = ["GraphBuilder", "MODEL_BUILDERS", "build_model", "mobilenet_v1",
           "mobilenet_v2", "resnet50", "resnet101", "resnet152"]
