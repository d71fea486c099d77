from .builder import GraphBuilder
from .zoo import (MODEL_BUILDERS, build_model, resnet50, resnet101,
                  resnet152)

__all__ = ["GraphBuilder", "MODEL_BUILDERS", "build_model", "resnet50",
           "resnet101", "resnet152"]
