from .builder import GraphBuilder
from .zoo import (MODEL_BUILDERS, alexnet, build_model, googlenet,
                  mobilenet_v1, mobilenet_v2, resnet50, resnet101, resnet152,
                  squeezenet_v10, squeezenet_v11, vgg16, vgg19)

__all__ = ["GraphBuilder", "MODEL_BUILDERS", "alexnet", "build_model",
           "googlenet", "mobilenet_v1", "mobilenet_v2", "resnet50",
           "resnet101", "resnet152", "squeezenet_v10", "squeezenet_v11",
           "vgg16", "vgg19"]
