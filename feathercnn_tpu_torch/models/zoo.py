"""Model zoo — the ResNet family of ``feathercnn_tpu/models/zoo.py``
(ResNet-50/101/152, Caffe deploy structure and naming).

Layer sequences and seeded weights are the reference's, so
``resnet50(seed=s)`` here and there build the same graph with the same
weights.  The other families come with their lowerings.
"""

from __future__ import annotations

from ..ir import Graph
from .builder import GraphBuilder

__all__ = ["resnet50", "resnet101", "resnet152", "MODEL_BUILDERS",
           "build_model"]


def _resnet(depth: int, batch: int, seed: int,
            with_softmax: bool) -> Graph:
    """ResNet-50/101/152, Caffe deploy structure and naming: conv+BN+Scale
    triples, bottleneck blocks with Eltwise-SUM shortcuts and fused ReLU.
    The deep nets number their middle-stage blocks (res3b1..res3bN,
    res4b1..res4bN) exactly as the public deploy prototxts do; ResNet-50
    letters every block (res2a..res5c)."""
    stage_blocks = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                    152: [3, 8, 36, 3]}[depth]
    b = GraphBuilder(f"resnet{depth}", seed)

    def conv_bn(name, x, ch, kernel, stride=1, pad=0, relu=True):
        x = b.conv(name, x, ch, kernel, stride, pad, bias=False)
        x = b.bn_scale("bn" + name[3:] if name.startswith("res")
                       else name + "_bn", x)
        if relu:
            x = b.relu(name + "_relu", x)
        return x

    def bottleneck(name, x, ch, stride=1, project=False):
        shortcut = x
        if project:
            shortcut = conv_bn(f"res{name}_branch1", x, ch * 4, 1,
                               stride=stride, relu=False)
        y = conv_bn(f"res{name}_branch2a", x, ch, 1, stride=stride)
        y = conv_bn(f"res{name}_branch2b", y, ch, 3, pad=1)
        y = conv_bn(f"res{name}_branch2c", y, ch * 4, 1, relu=False)
        out = b.eltwise(f"res{name}", [shortcut, y])
        return b.relu(f"res{name}_relu", out)

    x = b.input("data", (batch, 224, 224, 3))
    x = conv_bn("conv1", x, 64, 7, stride=2, pad=3)
    x = b.pool("pool1", x, 3, 2)
    for stage, (ch, blocks) in enumerate(
            zip([64, 128, 256, 512], stage_blocks), start=2):
        numbered = depth > 50 and stage in (3, 4)
        for i in range(blocks):
            blk = ("a" if i == 0 else f"b{i}") if numbered \
                else chr(ord("a") + i)
            stride = 2 if (i == 0 and stage > 2) else 1
            x = bottleneck(f"{stage}{blk}", x, ch, stride=stride,
                           project=(i == 0))
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc1000", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def resnet50(batch: int = 1, seed: int = 0,
             with_softmax: bool = True) -> Graph:
    """ResNet-50 (224x224) — the full-INT8 config (BASELINE.json:10)."""
    return _resnet(50, batch, seed, with_softmax)


def resnet101(batch: int = 1, seed: int = 0,
              with_softmax: bool = True) -> Graph:
    """ResNet-101 (Caffe deploy structure)."""
    return _resnet(101, batch, seed, with_softmax)


def resnet152(batch: int = 1, seed: int = 0,
              with_softmax: bool = True) -> Graph:
    """ResNet-152 (Caffe deploy structure)."""
    return _resnet(152, batch, seed, with_softmax)


MODEL_BUILDERS = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def build_model(name: str, batch: int = 1, **kw) -> Graph:
    try:
        builder = MODEL_BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; the port has "
                       f"{sorted(MODEL_BUILDERS)}") from None
    return builder(batch=batch, **kw)
