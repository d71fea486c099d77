"""Model zoo — the ResNet family (ResNet-50/101/152) and MobileNet-v1/v2
of ``feathercnn_tpu/models/zoo.py``, Caffe deploy structure and naming.

Layer sequences and seeded weights are the reference's, so
``resnet50(seed=s)`` here and there build the same graph with the same
weights.  The other families come with their lowerings.
"""

from __future__ import annotations

from ..ir import Graph
from .builder import GraphBuilder

__all__ = ["resnet50", "resnet101", "resnet152", "mobilenet_v1",
           "mobilenet_v2", "MODEL_BUILDERS", "build_model"]


def mobilenet_v1(batch: int = 1, seed: int = 0, width_mult: float = 1.0,
                 with_softmax: bool = True) -> Graph:
    """MobileNet-v1 (224x224): 13 depthwise-separable blocks, Caffe-style
    BatchNorm+Scale after every conv (the depthwise config of
    BASELINE.json:8)."""
    b = GraphBuilder("mobilenet_v1", seed)

    def c(ch):
        return max(8, int(ch * width_mult))

    def conv_block(name, x, ch, kernel=1, stride=1, pad=0, group=1):
        x = b.conv(name, x, ch, kernel, stride, pad, group=group, bias=False)
        x = b.bn_scale(name + "_bnsc", x)
        return b.relu(name + "/relu", x)

    def dw_sep(idx, x, ch, stride):
        cin = b._channels[x]
        x = b.conv(f"conv{idx}/dw", x, cin, 3, stride, 1, group=cin,
                   bias=False)
        x = b.bn_scale(f"conv{idx}/dw_bnsc", x)
        x = b.relu(f"conv{idx}/dw/relu", x)
        x = b.conv(f"conv{idx}/sep", x, ch, 1, 1, 0, bias=False)
        x = b.bn_scale(f"conv{idx}/sep_bnsc", x)
        return b.relu(f"conv{idx}/sep/relu", x)

    x = b.input("data", (batch, 224, 224, 3))
    x = conv_block("conv1", x, c(32), 3, 2, 1)
    x = dw_sep(2, x, c(64), 1)
    x = dw_sep(3, x, c(128), 2)
    x = dw_sep(4, x, c(128), 1)
    x = dw_sep(5, x, c(256), 2)
    x = dw_sep(6, x, c(256), 1)
    x = dw_sep(7, x, c(512), 2)
    for i in range(8, 13):
        x = dw_sep(i, x, c(512), 1)
    x = dw_sep(13, x, c(1024), 2)
    x = dw_sep(14, x, c(1024), 1)
    x = b.pool("pool6", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc7", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def mobilenet_v2(batch: int = 1, seed: int = 0, width_mult: float = 1.0,
                 with_softmax: bool = True) -> Graph:
    """MobileNet-v2 (224x224), the public caffe deploy structure
    (shicai/MobileNet-Caffe mobilenet_v2_deploy.prototxt): inverted
    residual blocks — 1x1 expand + ReLU6, 3x3 depthwise + ReLU6, 1x1
    linear project — with Eltwise-SUM shortcuts on the stride-1
    equal-channel blocks and BatchNorm+Scale after every conv."""
    b = GraphBuilder("mobilenet_v2", seed)

    def c(ch):
        return max(8, int(ch * width_mult))

    def conv_bn(name, x, ch, kernel=1, stride=1, pad=0, group=1,
                relu6=True):
        x = b.conv(name, x, ch, kernel, stride, pad, group=group,
                   bias=False)
        x = b.bn_scale(name + "_bnsc", x)
        if relu6:
            x = b.relu6(name + "/relu6", x)
        return x

    def inverted_residual(name, x, ch, stride, expand):
        cin = b._channels[x]
        y = x
        if expand != 1:
            y = conv_bn(name + "/expand", y, cin * expand, 1)
        y = conv_bn(name + "/dwise", y, b._channels[y], 3, stride, 1,
                    group=b._channels[y])
        y = conv_bn(name + "/linear", y, ch, 1, relu6=False)
        if stride == 1 and cin == ch:
            return b.eltwise(name + "/add", [x, y])
        return y

    x = b.input("data", (batch, 224, 224, 3))
    x = conv_bn("conv1", x, c(32), 3, 2, 1)
    # (expand_ratio, out_ch, repeats, first_stride): the 16/24/32/64/96/
    # 160/320 stages of the v2 paper and deploy prototxt
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    blk = 0
    for t, ch, n, s in cfg:
        for i in range(n):
            blk += 1
            x = inverted_residual(f"block{blk}", x, c(ch),
                                  s if i == 0 else 1, t)
    x = conv_bn("conv9", x, max(c(1280), 1280), 1)
    x = b.pool("pool10", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc11", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # The reference's measured per-model default: its depthwise convs take
    # float inputs (no int8 edge into a grouped conv).
    g.meta["config_overrides"] = {"int8_grouped": False}
    return g


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
    "mobilenet_v1": mobilenet_v1,
    "mobilenet_v2": mobilenet_v2,
}


def build_model(name: str, batch: int = 1, **kw) -> Graph:
    try:
        builder = MODEL_BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; the port has "
                       f"{sorted(MODEL_BUILDERS)}") from None
    return builder(batch=batch, **kw)
