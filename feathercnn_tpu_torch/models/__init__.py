from .builder import GraphBuilder
from .zoo import (MODEL_BUILDERS, alexnet, build_model, densenet121,
                  densenet169, densenet201, googlenet, inception_v3,
                  mobilenet_v1, mobilenet_v2, resnet50, resnet101, resnet152,
                  resnext50, se_resnet50, shufflenet_v1, shufflenet_v2,
                  squeezenet_v10, squeezenet_v11, vgg16, vgg19,
                  fcn32s, fcn16s, fcn8s, deeplab_largefov, pspnet50,
                  mobilenet_ssd, vgg16_ssd300, faster_rcnn_vgg16,
                  rfcn_resnet101)

__all__ = ["GraphBuilder", "MODEL_BUILDERS", "alexnet", "build_model",
           "densenet121", "densenet169", "densenet201", "googlenet",
           "inception_v3", "mobilenet_v1", "mobilenet_v2", "resnet50",
           "resnet101", "resnet152", "resnext50", "se_resnet50",
           "shufflenet_v1", "shufflenet_v2", "squeezenet_v10",
           "squeezenet_v11", "vgg16", "vgg19", "fcn32s", "fcn16s", "fcn8s",
           "deeplab_largefov", "pspnet50", "mobilenet_ssd", "vgg16_ssd300",
           "faster_rcnn_vgg16", "rfcn_resnet101"]
