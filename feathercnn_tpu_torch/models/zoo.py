"""Model zoo — the classification models of ``feathercnn_tpu/models/
zoo.py``: the ResNet family (ResNet-50/101/152), MobileNet-v1/v2,
SqueezeNet v1.0/v1.1, VGG-16/19, GoogLeNet, AlexNet, ShuffleNet v1/v2,
SE-ResNet-50, Inception-v3, DenseNet-121/169/201 and ResNeXt-50, the
segmentation models FCN-32s/16s/8s, DeepLab-LargeFOV and PSPNet-50, and
the detection models MobileNet-SSD, VGG16-SSD300, Faster R-CNN VGG16 and
R-FCN ResNet-101, Caffe deploy structure and naming.

Layer sequences, seeded weights and baked config overrides
(``meta["config_overrides"]``) are the reference's, so ``resnet50(seed=s)``
here and there build the same graph with the same weights.
"""

from __future__ import annotations

from ..ir import Graph, Node
from .builder import GraphBuilder

__all__ = ["squeezenet_v11", "squeezenet_v10", "vgg16", "vgg19",
           "googlenet", "alexnet", "resnet50", "resnet101", "resnet152",
           "mobilenet_v1", "mobilenet_v2", "shufflenet_v1", "shufflenet_v2",
           "se_resnet50", "inception_v3", "densenet121", "densenet169",
           "densenet201", "resnext50", "fcn32s", "fcn16s", "fcn8s",
           "deeplab_largefov", "pspnet50", "mobilenet_ssd", "vgg16_ssd300",
           "faster_rcnn_vgg16", "rfcn_resnet101", "MODEL_BUILDERS",
           "build_model"]


def _fire(b, name, x, s1, e1, e3):
    """SqueezeNet's fire module: a 1x1 squeeze, then 1x1 and 3x3 expands
    concatenated on channels."""
    s = b.conv(name + "/squeeze1x1", x, s1, 1, relu=True)
    ex1 = b.conv(name + "/expand1x1", s, e1, 1, relu=True)
    ex3 = b.conv(name + "/expand3x3", s, e3, 3, pad=1, relu=True)
    return b.concat(name + "/concat", [ex1, ex3])


def squeezenet_v11(batch: int = 1, seed: int = 0,
                   with_softmax: bool = True) -> Graph:
    """SqueezeNet v1.1 (227x227 input, fire modules with squeeze/expand)."""
    b = GraphBuilder("squeezenet_v11", seed)
    x = b.input("data", (batch, 227, 227, 3))
    x = b.conv("conv1", x, 64, 3, stride=2, relu=True)
    x = b.pool("pool1", x, 3, 2)
    x = _fire(b, "fire2", x, 16, 64, 64)
    x = _fire(b, "fire3", x, 16, 64, 64)
    x = b.pool("pool3", x, 3, 2)
    x = _fire(b, "fire4", x, 32, 128, 128)
    x = _fire(b, "fire5", x, 32, 128, 128)
    x = b.pool("pool5", x, 3, 2)
    x = _fire(b, "fire6", x, 48, 192, 192)
    x = _fire(b, "fire7", x, 48, 192, 192)
    x = _fire(b, "fire8", x, 64, 256, 256)
    x = _fire(b, "fire9", x, 64, 256, 256)
    x = b.dropout("drop9", x)
    x = b.conv("conv10", x, 1000, 1, relu=True)
    x = b.pool("pool10", x, 0, mode="AVE", global_pooling=True)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # the reference's measured bake: single-scale passthrough Concats only
    g.meta["config_overrides"] = {"int8_requant_ops": False}
    return g


def squeezenet_v10(batch: int = 1, seed: int = 0,
                   with_softmax: bool = True) -> Graph:
    """SqueezeNet v1.0 (224x224): 7x7/2 stem, pools after conv1 /
    fire4 / fire8 (the original deploy; v1.1 moved to a 3x3 stem)."""
    b = GraphBuilder("squeezenet_v10", seed)
    x = b.input("data", (batch, 224, 224, 3))
    x = b.conv("conv1", x, 96, 7, stride=2, relu=True)
    x = b.pool("pool1", x, 3, 2)
    x = _fire(b, "fire2", x, 16, 64, 64)
    x = _fire(b, "fire3", x, 16, 64, 64)
    x = _fire(b, "fire4", x, 32, 128, 128)
    x = b.pool("pool4", x, 3, 2)
    x = _fire(b, "fire5", x, 32, 128, 128)
    x = _fire(b, "fire6", x, 48, 192, 192)
    x = _fire(b, "fire7", x, 48, 192, 192)
    x = _fire(b, "fire8", x, 64, 256, 256)
    x = b.pool("pool8", x, 3, 2)
    x = _fire(b, "fire9", x, 64, 256, 256)
    x = b.dropout("drop9", x)
    x = b.conv("conv10", x, 1000, 1, relu=True)
    x = b.pool("pool10", x, 0, mode="AVE", global_pooling=True)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    g.meta["config_overrides"] = {"int8_requant_ops": False}
    return g


def _vgg(depth: int, batch: int, seed: int, with_softmax: bool) -> Graph:
    """VGG-16/19 (224x224) — the Winograd-path config (BASELINE.json:9):
    all-3x3 stride-1 convs."""
    b = GraphBuilder(f"vgg{depth}", seed)
    x = b.input("data", (batch, 224, 224, 3))
    n3 = 3 if depth == 16 else 4
    cfg = [(1, 2, 64), (2, 2, 128), (3, n3, 256), (4, n3, 512),
           (5, n3, 512)]
    for stage, n, ch in cfg:
        for i in range(1, n + 1):
            x = b.conv(f"conv{stage}_{i}", x, ch, 3, pad=1, relu=True)
        x = b.pool(f"pool{stage}", x, 2, 2)
    x = b.fc("fc6", x, 4096, relu=True)
    x = b.dropout("drop6", x)
    x = b.fc("fc7", x, 4096, relu=True)
    x = b.dropout("drop7", x)
    x = b.fc("fc8", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def vgg16(batch: int = 1, seed: int = 0, with_softmax: bool = True) -> Graph:
    """VGG-16 (BASELINE.json:9 config)."""
    return _vgg(16, batch, seed, with_softmax)


def vgg19(batch: int = 1, seed: int = 0, with_softmax: bool = True) -> Graph:
    """VGG-19 (four-conv stages 3-5)."""
    return _vgg(19, batch, seed, with_softmax)


def googlenet(batch: int = 1, seed: int = 0,
              with_softmax: bool = True) -> Graph:
    """GoogLeNet / Inception-v1 (224x224): multi-branch inception modules
    with channel Concat + LRN (BASELINE.json:10's serving config)."""
    b = GraphBuilder("googlenet", seed)

    def inception(name, x, c1, c3r, c3, c5r, c5, pp):
        b1 = b.conv(f"inception_{name}/1x1", x, c1, 1, relu=True)
        b3 = b.conv(f"inception_{name}/3x3_reduce", x, c3r, 1, relu=True)
        b3 = b.conv(f"inception_{name}/3x3", b3, c3, 3, pad=1, relu=True)
        b5 = b.conv(f"inception_{name}/5x5_reduce", x, c5r, 1, relu=True)
        b5 = b.conv(f"inception_{name}/5x5", b5, c5, 5, pad=2, relu=True)
        bp = b.pool(f"inception_{name}/pool", x, 3, 1, pad=1)
        bp = b.conv(f"inception_{name}/pool_proj", bp, pp, 1, relu=True)
        return b.concat(f"inception_{name}/output", [b1, b3, b5, bp])

    x = b.input("data", (batch, 224, 224, 3))
    x = b.conv("conv1/7x7_s2", x, 64, 7, stride=2, pad=3, relu=True)
    x = b.pool("pool1/3x3_s2", x, 3, 2)
    x = b.lrn("pool1/norm1", x)
    x = b.conv("conv2/3x3_reduce", x, 64, 1, relu=True)
    x = b.conv("conv2/3x3", x, 192, 3, pad=1, relu=True)
    x = b.lrn("conv2/norm2", x)
    x = b.pool("pool2/3x3_s2", x, 3, 2)
    x = inception("3a", x, 64, 96, 128, 16, 32, 32)
    x = inception("3b", x, 128, 128, 192, 32, 96, 64)
    x = b.pool("pool3/3x3_s2", x, 3, 2)
    x = inception("4a", x, 192, 96, 208, 16, 48, 64)
    x = inception("4b", x, 160, 112, 224, 24, 64, 64)
    x = inception("4c", x, 128, 128, 256, 24, 64, 64)
    x = inception("4d", x, 112, 144, 288, 32, 64, 64)
    x = inception("4e", x, 256, 160, 320, 32, 128, 128)
    x = b.pool("pool4/3x3_s2", x, 3, 2)
    x = inception("5a", x, 256, 160, 320, 32, 128, 128)
    x = inception("5b", x, 384, 192, 384, 48, 128, 128)
    x = b.pool("pool5/7x7_s1", x, 0, mode="AVE", global_pooling=True)
    x = b.dropout("pool5/drop_7x7_s1", x)
    x = b.fc("loss3/classifier", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # the reference's measured bake: sibling merge off
    g.meta["config_overrides"] = {"merge_siblings": False}
    return g


def alexnet(batch: int = 1, seed: int = 0,
            with_softmax: bool = True) -> Graph:
    """AlexNet (227x227), BVLC Caffe deploy structure: LRN (int8 requant
    edges) and 2-group convs together."""
    b = GraphBuilder("alexnet", seed)
    x = b.input("data", (batch, 227, 227, 3))
    x = b.conv("conv1", x, 96, 11, stride=4, relu=True)
    x = b.lrn("norm1", x)
    x = b.pool("pool1", x, 3, 2)
    x = b.conv("conv2", x, 256, 5, pad=2, group=2, relu=True)
    x = b.lrn("norm2", x)
    x = b.pool("pool2", x, 3, 2)
    x = b.conv("conv3", x, 384, 3, pad=1, relu=True)
    x = b.conv("conv4", x, 384, 3, pad=1, group=2, relu=True)
    x = b.conv("conv5", x, 256, 3, pad=1, group=2, relu=True)
    x = b.pool("pool5", x, 3, 2)
    x = b.fc("fc6", x, 4096, relu=True)
    x = b.dropout("drop6", x)
    x = b.fc("fc7", x, 4096, relu=True)
    x = b.dropout("drop7", x)
    x = b.fc("fc8", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # the reference's measured bakes: norm2 on float edges, and the 2-group
    # convs on float inputs (no int8 edge into a grouped conv)
    g.meta["config_overrides"] = {
        "quant_overrides": {"norm2": "fp"},
        "int8_grouped": False,
    }
    return g


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


def shufflenet_v1(batch: int = 1, seed: int = 0, groups: int = 3,
                  with_softmax: bool = True) -> Graph:
    """ShuffleNet v1 (224x224), the public caffe-ShuffleNet deploy
    structure (farmingyard/caffe-ShuffleNet, 1x g=3 by default): grouped
    1x1 convs + ShuffleChannel + depthwise 3x3, stride-2 units concat an
    AVE-pooled shortcut, stride-1 units use Eltwise-SUM residuals.
    Exercises the ShuffleChannel permutation between grouped convs (the
    int8 edge must ride through it)."""
    stage_out = {1: [144, 288, 576], 2: [200, 400, 800],
                 3: [240, 480, 960], 4: [272, 544, 1088],
                 8: [384, 768, 1536]}[groups]
    b = GraphBuilder("shufflenet_v1", seed)

    def gconv_bn(name, x, ch, group, relu=False):
        x = b.conv(name, x, ch, 1, group=group, bias=False)
        x = b.bn_scale(name + "_bnsc", x)
        if relu:
            x = b.relu(name + "_relu", x)
        return x

    def unit(name, x, out_ch, stride, first=False):
        cin = b._channels[x]
        mid = out_ch // 4
        y = gconv_bn(name + "_conv1", x, mid, 1 if first else groups,
                     relu=True)
        if groups > 1:
            y = b.shuffle_channel(name + "_shuffle", y, groups)
        y = b.conv(name + "_conv2", y, mid, 3, stride, 1, group=mid,
                   bias=False)
        y = b.bn_scale(name + "_conv2_bnsc", y)
        y = gconv_bn(name + "_conv3", y,
                     out_ch - cin if stride == 2 else out_ch, groups)
        if stride == 2:
            # caffe deploy: 3x3 s2 AVE pool, no pad (ceil -> floor match)
            sc = b.pool(name + "_avepool", x, 3, 2, mode="AVE")
            out = b.concat(name + "_concat", [sc, y])
        else:
            out = b.eltwise(name + "_add", [x, y])
        return b.relu(name + "_relu", out)

    x = b.input("data", (batch, 224, 224, 3))
    x = b.conv("conv1", x, 24, 3, stride=2, pad=1, bias=False)
    x = b.bn_scale("conv1_bnsc", x)
    x = b.relu("conv1_relu", x)
    x = b.pool("pool1", x, 3, 2)
    n = 0
    for stage, (out_ch, repeats) in enumerate(
            zip(stage_out, (4, 8, 4)), start=2):
        for i in range(repeats):
            n += 1
            x = unit(f"resx{n}", x, out_ch, stride=2 if i == 0 else 1,
                     first=(stage == 2 and i == 0))
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc1000", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # the reference's measured bake: the grouped 1x1 and depthwise convs
    # on float inputs (no int8 edge into a grouped conv)
    g.meta["config_overrides"] = {"int8_grouped": False}
    return g


def shufflenet_v2(batch: int = 1, seed: int = 0, width: str = "1.0x",
                  with_softmax: bool = True) -> Graph:
    """ShuffleNet v2 (224x224), the public Caffe deploy structure
    (miaow1988/ShuffleNet_V2_pytorch_caffe exports): stride-1 units
    Slice channels in half, run 1x1 -> dw3x3 -> 1x1 on one half, Concat
    and ShuffleChannel(2); stride-2 units run both branches on the full
    input.  Exercises Slice + ShuffleChannel + Concat composition."""
    stage_out = {"0.5x": [48, 96, 192, 1024],
                 "1.0x": [116, 232, 464, 1024],
                 "1.5x": [176, 352, 704, 1024],
                 "2.0x": [244, 488, 976, 2048]}[width]
    b = GraphBuilder("shufflenet_v2", seed)

    def conv_bn(name, x, ch, kernel=1, stride=1, pad=0, group=1,
                relu=True):
        x = b.conv(name, x, ch, kernel, stride, pad, group=group,
                   bias=False)
        x = b.bn_scale(name + "_bnsc", x)
        if relu:
            x = b.relu(name + "_relu", x)
        return x

    def unit(name, x, out_ch, stride):
        cin = b._channels[x]
        half = out_ch // 2
        if stride == 1:
            l, r = b._add(Node(name + "_slice", "Slice", [x],
                               [name + "_l", name + "_r"],
                               {"axis": -1}))
            b._channels[name + "_l"] = cin // 2
            b._channels[name + "_r"] = cin // 2
            y = conv_bn(name + "_c1", r, half, 1)
            y = conv_bn(name + "_dw", y, half, 3, 1, 1, group=half,
                        relu=False)
            y = conv_bn(name + "_c2", y, half, 1)
            out = b.concat(name + "_concat", [l, y])
        else:
            sc = conv_bn(name + "_sdw", x, cin, 3, 2, 1, group=cin,
                         relu=False)
            sc = conv_bn(name + "_sc", sc, half, 1)
            y = conv_bn(name + "_c1", x, half, 1)
            y = conv_bn(name + "_dw", y, half, 3, 2, 1, group=half,
                        relu=False)
            y = conv_bn(name + "_c2", y, half, 1)
            out = b.concat(name + "_concat", [sc, y])
        return b.shuffle_channel(name + "_shuffle", out, 2)

    x = b.input("data", (batch, 224, 224, 3))
    x = conv_bn("conv1", x, 24, 3, 2, 1)
    x = b.pool("pool1", x, 3, 2)
    n = 0
    for stage, (out_ch, repeats) in enumerate(
            zip(stage_out[:3], (4, 8, 4)), start=2):
        for i in range(repeats):
            n += 1
            x = unit(f"unit{n}", x, out_ch, stride=2 if i == 0 else 1)
    x = conv_bn("conv5", x, stage_out[3], 1)
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # the reference's measured bakes: the depthwise convs on float inputs,
    # and its TPU form of the channel shuffle (a one-hot permutation
    # matmul; the port computes the same permutation for either value)
    g.meta["config_overrides"] = {"int8_grouped": False,
                                  "shuffle_matmul": True}
    return g


def se_resnet50(batch: int = 1, seed: int = 0, reduction: int = 16,
                with_softmax: bool = True) -> Graph:
    """SE-ResNet-50 (224x224), the public SENet-Caffe deploy structure
    (hujie-frank/SENet SE-ResNet-50.prototxt): ResNet-50 bottlenecks with
    a squeeze-excite path per block — global AVE pool, 1x1 down (C/16) +
    ReLU, 1x1 up (C) + Sigmoid — applied through the Axpy layer
    (gate*residual + shortcut) with fused ReLU."""
    b = GraphBuilder("se_resnet50", seed)

    def conv_bn(name, x, ch, kernel, stride=1, pad=0, relu=True):
        x = b.conv(name, x, ch, kernel, stride, pad, bias=False)
        x = b.bn_scale(name + "/bn", x)
        if relu:
            x = b.relu(name + "/relu", x)
        return x

    def bottleneck(name, x, ch, stride=1, project=False):
        shortcut = x
        if project:
            shortcut = conv_bn(name + "_1x1_proj", x, ch * 4, 1,
                               stride=stride, relu=False)
        y = conv_bn(name + "_1x1_reduce", x, ch, 1, stride=stride)
        y = conv_bn(name + "_3x3", y, ch, 3, pad=1)
        y = conv_bn(name + "_1x1_increase", y, ch * 4, 1, relu=False)
        s = b.pool(name + "_global_pool", y, 0, mode="AVE",
                   global_pooling=True)
        s = b.conv(name + "_1x1_down", s, ch * 4 // reduction, 1,
                   relu=True)
        s = b.conv(name + "_1x1_up", s, ch * 4, 1)
        s = b.sigmoid(name + "_prob", s)
        out = b.axpy(name + "_axpy", s, y, shortcut)
        return b.relu(name + "_relu", out)

    x = b.input("data", (batch, 224, 224, 3))
    x = conv_bn("conv1", x, 64, 7, stride=2, pad=3)
    x = b.pool("pool1", x, 3, 2)
    for stage, (ch, blocks) in enumerate(
            zip([64, 128, 256, 512], [3, 4, 6, 3]), start=2):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 2) else 1
            x = bottleneck(f"conv{stage}_{i + 1}", x, ch, stride=stride,
                           project=(i == 0))
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("classifier", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def inception_v3(batch: int = 1, seed: int = 0,
                 with_softmax: bool = True) -> Graph:
    """Inception-v3 (299x299), the public Caffe deploy structure
    (soeaver/caffe-model inception_v3 deploy): factorized 7x7 (1x7/7x1)
    and 3x3 (1x3/3x1) branches with conv+BN+Scale+ReLU throughout —
    exercises asymmetric kernels and pads on the implicit-GEMM conv."""
    b = GraphBuilder("inception_v3", seed)

    def cbr(name, x, ch, kh=1, kw=None, stride=1, ph=0, pw=None):
        kw = kh if kw is None else kw
        pw = ph if pw is None else pw
        x = b.conv(name, x, ch, stride=stride, bias=False,
                   kernel_h=kh, kernel_w=kw, pad_h=ph, pad_w=pw)
        x = b.bn_scale(name + "_bnsc", x)
        return b.relu(name + "/relu", x)

    def module_a(name, x, pool_proj):
        b1 = cbr(f"{name}_1x1", x, 64)
        b2 = cbr(f"{name}_5x5_reduce", x, 48)
        b2 = cbr(f"{name}_5x5", b2, 64, 5, ph=2)
        b3 = cbr(f"{name}_3x3_reduce", x, 64)
        b3 = cbr(f"{name}_3x3_1", b3, 96, 3, ph=1)
        b3 = cbr(f"{name}_3x3_2", b3, 96, 3, ph=1)
        bp = b.pool(f"{name}_pool", x, 3, 1, pad=1, mode="AVE")
        bp = cbr(f"{name}_pool_proj", bp, pool_proj)
        return b.concat(f"{name}_concat", [b1, b2, b3, bp])

    def module_b(name, x, c7):
        b1 = cbr(f"{name}_1x1", x, 192)
        b2 = cbr(f"{name}_1x7_reduce", x, c7)
        b2 = cbr(f"{name}_1x7", b2, c7, 1, 7, ph=0, pw=3)
        b2 = cbr(f"{name}_7x1", b2, 192, 7, 1, ph=3, pw=0)
        b3 = cbr(f"{name}_7x1_reduce", x, c7)
        b3 = cbr(f"{name}_7x1_2", b3, c7, 7, 1, ph=3, pw=0)
        b3 = cbr(f"{name}_1x7_2", b3, c7, 1, 7, ph=0, pw=3)
        b3 = cbr(f"{name}_7x1_3", b3, c7, 7, 1, ph=3, pw=0)
        b3 = cbr(f"{name}_1x7_3", b3, 192, 1, 7, ph=0, pw=3)
        bp = b.pool(f"{name}_pool", x, 3, 1, pad=1, mode="AVE")
        bp = cbr(f"{name}_pool_proj", bp, 192)
        return b.concat(f"{name}_concat", [b1, b2, b3, bp])

    def module_c(name, x):
        b1 = cbr(f"{name}_1x1", x, 320)
        b2 = cbr(f"{name}_3x3_reduce", x, 384)
        b2a = cbr(f"{name}_1x3", b2, 384, 1, 3, ph=0, pw=1)
        b2b = cbr(f"{name}_3x1", b2, 384, 3, 1, ph=1, pw=0)
        b3 = cbr(f"{name}_dbl_3x3_reduce", x, 448)
        b3 = cbr(f"{name}_dbl_3x3", b3, 384, 3, ph=1)
        b3a = cbr(f"{name}_dbl_1x3", b3, 384, 1, 3, ph=0, pw=1)
        b3b = cbr(f"{name}_dbl_3x1", b3, 384, 3, 1, ph=1, pw=0)
        bp = b.pool(f"{name}_pool", x, 3, 1, pad=1, mode="AVE")
        bp = cbr(f"{name}_pool_proj", bp, 192)
        return b.concat(f"{name}_concat", [b1, b2a, b2b, b3a, b3b, bp])

    x = b.input("data", (batch, 299, 299, 3))
    x = cbr("conv1_3x3_s2", x, 32, 3, stride=2)        # 149
    x = cbr("conv2_3x3", x, 32, 3)                     # 147
    x = cbr("conv3_3x3", x, 64, 3, ph=1)               # 147
    x = b.pool("pool1_3x3_s2", x, 3, 2)                # 73
    x = cbr("conv4_1x1", x, 80)
    x = cbr("conv5_3x3", x, 192, 3)                    # 71
    x = b.pool("pool2_3x3_s2", x, 3, 2)                # 35
    x = module_a("mixed", x, 32)                       # 256
    x = module_a("mixed_1", x, 64)                     # 288
    x = module_a("mixed_2", x, 64)                     # 288
    # reduction A -> 17x17x768
    r1 = cbr("mixed_3_3x3_s2", x, 384, 3, stride=2)
    r2 = cbr("mixed_3_3x3_reduce", x, 64)
    r2 = cbr("mixed_3_3x3_1", r2, 96, 3, ph=1)
    r2 = cbr("mixed_3_3x3_2", r2, 96, 3, stride=2)
    rp = b.pool("mixed_3_pool", x, 3, 2)
    x = b.concat("mixed_3_concat", [r1, r2, rp])
    for i, c7 in zip(range(4, 8), (128, 160, 160, 192)):
        x = module_b(f"mixed_{i}", x, c7)
    # reduction B -> 8x8x1280
    r1 = cbr("mixed_8_1x1", x, 192)
    r1 = cbr("mixed_8_3x3_s2", r1, 320, 3, stride=2)
    r2 = cbr("mixed_8_1x7_reduce", x, 192)
    r2 = cbr("mixed_8_1x7", r2, 192, 1, 7, ph=0, pw=3)
    r2 = cbr("mixed_8_7x1", r2, 192, 7, 1, ph=3, pw=0)
    r2 = cbr("mixed_8_3x3", r2, 192, 3, stride=2)
    rp = b.pool("mixed_8_pool", x, 3, 2)
    x = b.concat("mixed_8_concat", [r1, r2, rp])
    x = module_c("mixed_9", x)                         # 2048
    x = module_c("mixed_10", x)
    x = b.pool("pool3_8x8_s1", x, 0, mode="AVE", global_pooling=True)
    x = b.dropout("drop", x)
    x = b.fc("classifier", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    return g


def densenet121(batch: int = 1, seed: int = 0,
                with_softmax: bool = True) -> Graph:
    """DenseNet-121 (224x224), Caffe deploy structure (the public
    DenseNet-Caffe release): pre-activation BN+Scale+ReLU before every
    conv, dense blocks of concatenated growth-32 features, 0.5-compression
    transitions.  Exercises long Concat chains (int8-edge propagation) and
    standalone Scale nodes (pre-activation BN cannot fold into a preceding
    conv across a Concat)."""
    return _densenet(121, batch, seed, with_softmax)


def densenet169(batch: int = 1, seed: int = 0,
                with_softmax: bool = True) -> Graph:
    """DenseNet-169 (6/12/32/32 blocks)."""
    return _densenet(169, batch, seed, with_softmax)


def densenet201(batch: int = 1, seed: int = 0,
                with_softmax: bool = True) -> Graph:
    """DenseNet-201 (6/12/48/32 blocks)."""
    return _densenet(201, batch, seed, with_softmax)


def _densenet(depth: int, batch: int, seed: int,
              with_softmax: bool) -> Graph:
    blocks = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32),
              201: (6, 12, 48, 32)}[depth]
    b = GraphBuilder(f"densenet{depth}", seed)

    def bn_relu(name, x):
        x = b.bn_scale(name, x)
        return b.relu(name + "/relu", x)

    def dense_layer(name, x, growth=32):
        y = bn_relu(name + "/x1", x)
        y = b.conv(name + "/x1", y, 4 * growth, 1, bias=False)
        y = bn_relu(name + "/x2", y)
        return b.conv(name + "/x2", y, growth, 3, pad=1, bias=False)

    x = b.input("data", (batch, 224, 224, 3))
    x = b.conv("conv1", x, 64, 7, stride=2, pad=3, bias=False)
    x = bn_relu("conv1", x)
    x = b.pool("pool1", x, 3, 2)
    ch = 64
    for stage, layers in zip((2, 3, 4, 5), blocks):
        for j in range(1, layers + 1):
            y = dense_layer(f"conv{stage}_{j}", x)
            x = b.concat(f"concat_{stage}_{j}", [x, y])
            ch += 32
        if stage < 5:
            x = bn_relu(f"conv{stage}_blk", x)
            ch //= 2
            x = b.conv(f"conv{stage}_blk", x, ch, 1, bias=False)
            x = b.pool(f"pool{stage}", x, 2, 2, mode="AVE")
    x = bn_relu("conv5_blk", x)
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc6", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def resnext50(batch: int = 1, seed: int = 0,
              with_softmax: bool = True) -> Graph:
    """ResNeXt-50 (32x4d), Caffe deploy structure: bottlenecks whose 3x3
    conv is grouped (cardinality 32) — exercises the grouped int8 conv
    (``int8_grouped``, on by default: the grouped 3x3 convs take int8
    edges; kernels/dispatch.py runs them on the implicit-GEMM kernel as
    super-groups of 32 / (C/32) groups, each column tile of 32 outputs
    gathering its own 32 input channels)."""
    b = GraphBuilder("resnext50", seed)

    def conv_bn(name, x, ch, kernel, stride=1, pad=0, group=1, relu=True):
        x = b.conv(name, x, ch, kernel, stride, pad, group=group,
                   bias=False)
        x = b.bn_scale(name + "_bnsc", x)
        if relu:
            x = b.relu(name + "_relu", x)
        return x

    def block(name, x, ch, stride=1, project=False):
        shortcut = x
        if project:
            shortcut = conv_bn(name + "_branch1", x, ch * 2, 1,
                               stride=stride, relu=False)
        y = conv_bn(name + "_branch2a", x, ch, 1)
        y = conv_bn(name + "_branch2b", y, ch, 3, stride=stride, pad=1,
                    group=32)
        y = conv_bn(name + "_branch2c", y, ch * 2, 1, relu=False)
        out = b.eltwise(name, [shortcut, y])
        return b.relu(name + "_relu", out)

    x = b.input("data", (batch, 224, 224, 3))
    x = conv_bn("conv1", x, 64, 7, stride=2, pad=3)
    x = b.pool("pool1", x, 3, 2)
    for stage, (ch, blocks) in enumerate(
            zip([128, 256, 512, 1024], [3, 4, 6, 3]), start=2):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 2) else 1
            x = block(f"res{stage}{chr(ord('a') + i)}", x, ch,
                      stride=stride, project=(i == 0))
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc1000", x, 1000)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def _fcn(variant: int, batch: int, seed: int, num_classes: int,
         size: int, with_softmax: bool) -> Graph:
    """FCN-32s/16s/8s semantic segmentation (the public voc-fcn* deploys):
    VGG-16 backbone with Caffe's pad-100 trick, fully-convolutional
    fc6/fc7, stride-2 Deconvolution upsamples fused with pool4/pool3 skip
    scores (16s/8s), and a final Crop back to the input's spatial size
    (offsets 19/27/31 — fixed by the network geometry).  Exercises
    Deconvolution/Crop/Eltwise composition in real models."""
    b = GraphBuilder(f"fcn{variant}s", seed)
    data = b.input("data", (batch, size, size, 3))
    x = b.conv("conv1_1", data, 64, 3, pad=100, relu=True)
    x = b.conv("conv1_2", x, 64, 3, pad=1, relu=True)
    x = b.pool("pool1", x, 2, 2)
    pools = {}
    for stage, n, ch in [(2, 2, 128), (3, 3, 256), (4, 3, 512),
                         (5, 3, 512)]:
        for i in range(1, n + 1):
            x = b.conv(f"conv{stage}_{i}", x, ch, 3, pad=1, relu=True)
        x = b.pool(f"pool{stage}", x, 2, 2)
        pools[stage] = x
    x = b.conv("fc6", x, 4096, 7, relu=True)
    x = b.dropout("drop6", x)
    x = b.conv("fc7", x, 4096, 1, relu=True)
    x = b.dropout("drop7", x)
    x = b.conv("score_fr", x, num_classes, 1)
    if variant == 32:
        x = b.deconv("upscore", x, num_classes, 64, stride=32, bias=False)
        x = b.crop("score", x, data, axes=(1, 2), offsets=(19, 19))
    else:
        x = b.deconv("upscore2", x, num_classes, 4, stride=2, bias=False)
        s4 = b.conv("score_pool4", pools[4], num_classes, 1)
        s4 = b.crop("score_pool4c", s4, x, axes=(1, 2), offsets=(5, 5))
        x = b.eltwise("fuse_pool4", [x, s4])
        if variant == 16:
            x = b.deconv("upscore16", x, num_classes, 32, stride=16,
                         bias=False)
            x = b.crop("score", x, data, axes=(1, 2), offsets=(27, 27))
        else:
            x = b.deconv("upscore_pool4", x, num_classes, 4, stride=2,
                         bias=False)
            s3 = b.conv("score_pool3", pools[3], num_classes, 1)
            s3 = b.crop("score_pool3c", s3, x, axes=(1, 2),
                        offsets=(9, 9))
            x = b.eltwise("fuse_pool3", [x, s3])
            x = b.deconv("upscore8", x, num_classes, 16, stride=8,
                         bias=False)
            x = b.crop("score", x, data, axes=(1, 2), offsets=(31, 31))
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def fcn32s(batch: int = 1, seed: int = 0, num_classes: int = 21,
           size: int = 224, with_softmax: bool = True) -> Graph:
    """FCN-32s (voc-fcn32s deploy structure)."""
    return _fcn(32, batch, seed, num_classes, size, with_softmax)


def fcn16s(batch: int = 1, seed: int = 0, num_classes: int = 21,
           size: int = 224, with_softmax: bool = True) -> Graph:
    """FCN-16s: + pool4 skip score fused before the x16 upsample."""
    return _fcn(16, batch, seed, num_classes, size, with_softmax)


def fcn8s(batch: int = 1, seed: int = 0, num_classes: int = 21,
          size: int = 224, with_softmax: bool = True) -> Graph:
    """FCN-8s: + pool4 and pool3 skip scores (the full skip ladder)."""
    return _fcn(8, batch, seed, num_classes, size, with_softmax)


def pspnet50(batch: int = 1, seed: int = 0, num_classes: int = 150,
             size: int = 473, with_softmax: bool = True) -> Graph:
    """PSPNet-50 (the public pspnet50_ADE20K deploy structure): dilated
    ResNet-50 backbone (three-3x3 stem, stride-1 dilation-2/4 stages 4-5,
    output stride 8) + Pyramid Pooling Module (AVE-pool bins {1,2,3,6},
    1x1 conv+BN+ReLU per bin, align-corners Interp back to feature size,
    Concat), 3x3 fusion conv, and Interp zoom x8 to input resolution.
    ``size`` must satisfy (size-1) % 8 == 0 with the stride-8 feature
    divisible by 6 (473 -> 60, 233 -> 30, 89 -> 12)."""
    b = GraphBuilder("pspnet50", seed)

    def conv_bn(name, x, ch, kernel, stride=1, pad=0, dilation=1,
                relu=True):
        x = b.conv(name, x, ch, kernel, stride, pad, dilation=dilation,
                   bias=False)
        x = b.bn_scale(name + "/bn", x)
        if relu:
            x = b.relu(name + "/relu", x)
        return x

    def bottleneck(name, x, ch, stride=1, dilation=1, project=False):
        shortcut = x
        if project:
            shortcut = conv_bn(name + "_branch1", x, ch * 4, 1,
                               stride=stride, relu=False)
        y = conv_bn(name + "_branch2a", x, ch, 1, stride=stride)
        y = conv_bn(name + "_branch2b", y, ch, 3, pad=dilation,
                    dilation=dilation)
        y = conv_bn(name + "_branch2c", y, ch * 4, 1, relu=False)
        out = b.eltwise(name, [shortcut, y])
        return b.relu(name + "_relu", out)

    data = b.input("data", (batch, size, size, 3))
    x = conv_bn("conv1_1_3x3_s2", data, 64, 3, stride=2, pad=1)
    x = conv_bn("conv1_2_3x3", x, 64, 3, pad=1)
    x = conv_bn("conv1_3_3x3", x, 128, 3, pad=1)
    x = b.pool("pool1", x, 3, 2, pad=1)
    for stage, ch, blocks, stride, dil in [(2, 64, 3, 1, 1),
                                           (3, 128, 4, 2, 1),
                                           (4, 256, 6, 1, 2),
                                           (5, 512, 3, 1, 4)]:
        for i in range(blocks):
            x = bottleneck(f"conv{stage}_{i + 1}", x, ch,
                           stride=stride if i == 0 else 1,
                           dilation=dil, project=(i == 0))
    feat = (size - 1) // 8 + 1
    if feat % 6:
        raise ValueError(f"size {size}: stride-8 feature {feat} "
                         "not divisible by the {1,2,3,6} pyramid bins")
    branches = [x]
    for bin_ in (1, 2, 3, 6):
        k = feat // bin_
        p = b.pool(f"pool{bin_}x{bin_}", x, k, stride=k, mode="AVE")
        p = conv_bn(f"pool{bin_}x{bin_}_conv", p, 512, 1)
        p = b.interp(f"pool{bin_}x{bin_}_interp", p,
                     height=feat, width=feat)
        branches.append(p)
    x = b.concat("ppm_concat", branches)
    x = conv_bn("conv5_4", x, 512, 3, pad=1)
    x = b.dropout("conv5_4_dropout", x)
    x = b.conv("conv6", x, num_classes, 1)
    x = b.interp("conv6_interp", x, zoom_factor=8)
    if with_softmax:
        x = b.softmax("prob", x)
    g = b.finish([x])
    # the reference's measured per-model bakes
    g.meta["config_overrides"] = {"avepool_matmul": True,
                                  "nested_pools": True}
    return g


def deeplab_largefov(batch: int = 1, seed: int = 0, num_classes: int = 21,
                     size: int = 321, with_softmax: bool = True) -> Graph:
    """DeepLab-LargeFOV (v1/v2 VGG-16 variant; the public
    test_val.prototxt): VGG-16 with DeepLab's 3x3/pad-1 pools, stride-1
    pool4/pool5 (output stride 8), dilation-2 conv5 block, atrous
    fc6 (3x3, dilation 12, 1024ch), and an align-corners Interp
    zoom x8 back to input resolution.  Exercises dilated convs +
    Interp in a real deploy shape."""
    b = GraphBuilder("deeplab_largefov", seed)
    data = b.input("data", (batch, size, size, 3))
    x = data
    for stage, n, ch, pstride in [(1, 2, 64, 2), (2, 2, 128, 2),
                                  (3, 3, 256, 2), (4, 3, 512, 1),
                                  (5, 3, 512, 1)]:
        dil = 2 if stage == 5 else 1
        for i in range(1, n + 1):
            x = b.conv(f"conv{stage}_{i}", x, ch, 3, pad=dil,
                       dilation=dil, relu=True)
        x = b.pool(f"pool{stage}", x, 3, pstride, pad=1)
    x = b.pool("pool5a", x, 3, 1, pad=1, mode="AVE")
    x = b.conv("fc6", x, 1024, 3, pad=12, dilation=12, relu=True)
    x = b.dropout("drop6", x)
    x = b.conv("fc7", x, 1024, 1, relu=True)
    x = b.dropout("drop7", x)
    x = b.conv("fc8_voc12", x, num_classes, 1)
    x = b.interp("fc8_interp", x, zoom_factor=8)
    if with_softmax:
        x = b.softmax("prob", x)
    return b.finish([x])


def _rpn_softmax(b: GraphBuilder, cls_score: str, prefix: str) -> str:
    """The RPN per-anchor softmax: split Caffe's [bg*A, fg*A] channel
    halves into a (2, A) axis pair, softmax over the 2, restore the
    channel layout (the NHWC equivalent of the deploys' NCHW
    Reshape(0,2,-1,0) + Softmax(axis=1) + Reshape)."""
    from ..ir import infer_shapes
    infer_shapes(b.graph)
    n, fh, fw, c2a = b.graph.specs[cls_score].shape
    a = c2a // 2
    r = b.reshape(prefix + "_reshape", cls_score, (n, fh, fw, 2, a))
    r = b.softmax(prefix + "_prob", r, axis=-2)
    return b.reshape(prefix + "_prob_reshape", r, (n, fh, fw, 2 * a))


def faster_rcnn_vgg16(batch: int = 1, seed: int = 0,
                      num_classes: int = 21, size=(600, 800),
                      pre_nms_top_n: int = 6000,
                      post_nms_top_n: int = 300) -> Graph:
    """Faster R-CNN VGG16 (the public py-faster-rcnn test.prototxt
    structure, run end-to-end on-device): VGG-16 conv body (no pool5),
    RPN (3x3 + cls/bbox 1x1 heads, per-anchor softmax via a 5-D reshape
    that pairs Caffe's [bg*A, fg*A] channel halves), Proposal (anchor
    decode + NMS -> 300 ROIs), ROIPooling 7x7, fc6/fc7 heads, and
    per-ROI cls_prob/bbox_pred outputs.  Inputs: `data` (1,H,W,3) and
    `im_info` (1,3)=[im_h, im_w, scale].  Outputs: cls_prob (300,21),
    bbox_pred (300,84), rois (300,5) — final per-class decode is the
    caller's (the reference's test.py does the same host-side)."""
    # The reference deploy is batch 1; batch > 1 vmaps the RPN/Proposal
    # per image and routes image-major (N*post_n, 5) rois through the
    # batched ROI head (flattened-row-axis gather in ops/lowering.py).
    h, w = size
    b = GraphBuilder("faster_rcnn_vgg16", seed)
    data = b.input("data", (batch, h, w, 3))
    im_info = b.input("im_info", (batch, 3))
    x = data
    for stage, n, ch in [(1, 2, 64), (2, 2, 128), (3, 3, 256),
                         (4, 3, 512), (5, 3, 512)]:
        for i in range(1, n + 1):
            x = b.conv(f"conv{stage}_{i}", x, ch, 3, pad=1, relu=True)
        if stage < 5:
            x = b.pool(f"pool{stage}", x, 2, 2)
    conv5 = x                                         # (1, h/16, w/16, 512)

    rpn = b.conv("rpn_conv/3x3", conv5, 512, 3, pad=1, relu=True)
    cls_score = b.conv("rpn_cls_score", rpn, 18, 1)   # [bg*9, fg*9]
    bbox_pred = b.conv("rpn_bbox_pred", rpn, 36, 1)
    prob = _rpn_softmax(b, cls_score, "rpn_cls")
    rois = b.proposal("proposal", prob, bbox_pred, im_info,
                      feat_stride=16, pre_nms_top_n=pre_nms_top_n,
                      post_nms_top_n=post_nms_top_n)
    pooled = b.roi_pooling("roi_pool5", conv5, rois, 7, 7, 1.0 / 16)
    y = b.fc("fc6", pooled, 4096, relu=True)
    y = b.dropout("drop6", y)
    y = b.fc("fc7", y, 4096, relu=True)
    y = b.dropout("drop7", y)
    cls = b.fc("cls_score", y, num_classes)
    cls = b.softmax("cls_prob", cls)
    box = b.fc("bbox_pred", y, num_classes * 4)
    return b.finish([cls, box, rois])


def rfcn_resnet101(batch: int = 1, seed: int = 0, num_classes: int = 21,
                   size=(600, 800), post_nms_top_n: int = 300) -> Graph:
    """R-FCN ResNet-101 (the public py-R-FCN test_agnostic prototxt
    structure, class-aware head): ResNet-101 with an a-trous stage 5
    (stride 1, dilation 2 — output stride 16), RPN on the stage-4
    output, Proposal, 1x1 conv_new_1 (1024), position-sensitive score
    maps rfcn_cls (k^2*C) / rfcn_bbox (k^2*8), PSROIPooling (k=7), and
    per-ROI global AVE vote -> cls_prob / bbox_pred.  Fully on-device
    like the Faster R-CNN zoo model."""
    # batch > 1: same image-major batched ROI-head path as Faster R-CNN
    h, w = size
    b = GraphBuilder("rfcn_resnet101", seed)
    data = b.input("data", (batch, h, w, 3))
    im_info = b.input("im_info", (batch, 3))

    def conv_bn(name, x, ch, kernel, stride=1, pad=0, dilation=1,
                relu=True):
        x = b.conv(name, x, ch, kernel, stride, pad, dilation=dilation,
                   bias=False)
        x = b.bn_scale("bn" + name[3:] if name.startswith("res")
                       else name + "_bn", x)
        if relu:
            x = b.relu(name + "_relu", x)
        return x

    def bottleneck(name, x, ch, stride=1, dilation=1, project=False):
        shortcut = x
        if project:
            shortcut = conv_bn(f"res{name}_branch1", x, ch * 4, 1,
                               stride=stride, relu=False)
        y = conv_bn(f"res{name}_branch2a", x, ch, 1, stride=stride)
        y = conv_bn(f"res{name}_branch2b", y, ch, 3, pad=dilation,
                    dilation=dilation)
        y = conv_bn(f"res{name}_branch2c", y, ch * 4, 1, relu=False)
        out = b.eltwise(f"res{name}", [shortcut, y])
        return b.relu(f"res{name}_relu", out)

    x = conv_bn("conv1", data, 64, 7, stride=2, pad=3)
    x = b.pool("pool1", x, 3, 2)
    for stage, (ch, blocks, stride, dil) in enumerate(
            zip([64, 128, 256, 512], [3, 4, 23, 3], [1, 2, 2, 1],
                [1, 1, 1, 2]), start=2):
        numbered = stage in (3, 4)
        for i in range(blocks):
            blk = ("a" if i == 0 else f"b{i}") if numbered \
                else chr(ord("a") + i)
            x = bottleneck(f"{stage}{blk}", x, ch,
                           stride=stride if i == 0 else 1,
                           dilation=dil, project=(i == 0))
        if stage == 4:
            res4 = x                                  # stride-16, 1024ch

    rpn = b.conv("rpn_conv/3x3", res4, 512, 3, pad=1, relu=True)
    cls_score = b.conv("rpn_cls_score", rpn, 18, 1)
    bbox = b.conv("rpn_bbox_pred", rpn, 36, 1)
    prob = _rpn_softmax(b, cls_score, "rpn_cls")
    rois = b.proposal("proposal", prob, bbox, im_info, feat_stride=16,
                      post_nms_top_n=post_nms_top_n)

    x = b.conv("conv_new_1", x, 1024, 1, relu=True)
    k = 7
    cls_map = b.conv("rfcn_cls", x, k * k * num_classes, 1)
    loc_map = b.conv("rfcn_bbox", x, k * k * 8, 1)
    cls = b.psroi_pooling("psroipooled_cls_rois", cls_map, rois,
                          num_classes, k)
    cls = b.pool("ave_cls_score_rois", cls, 0, mode="AVE",
                 global_pooling=True)
    cls = b.softmax("cls_prob", cls)
    loc = b.psroi_pooling("psroipooled_loc_rois", loc_map, rois, 8, k)
    loc = b.pool("ave_bbox_pred_rois", loc, 0, mode="AVE",
                 global_pooling=True)
    return b.finish([cls, loc, rois])


def _ssd_head(b: GraphBuilder, data: str, sources, num_classes: int,
              keep_top_k: int = 100, nms_top_k: int = 400,
              confidence_threshold: float = 0.01,
              nms_threshold: float = 0.45,
              bg_bias: float = 0.0) -> str:
    """The shared SSD multibox head ([pub] FeatherCNN runs the ssd-fork
    deploys through its converter; layer pattern from the public
    SSD/MobileNet-SSD deploy prototxts): per source a 1x1 loc conv
    (np*4 ch) and conf conv (np*classes ch), each Permute(0,2,3,1)+
    Flatten; PriorBox per source; heads Concat on axis 1, priors on
    axis 2; conf Reshape->Softmax->Flatten; DetectionOutput."""
    locs, confs, priors = [], [], []
    for src, np_, kw in sources:
        n = src.split("/")[0]
        loc = b.conv(f"{n}_mbox_loc", src, np_ * 4, 1)
        loc = b.permute(f"{n}_mbox_loc_perm", loc)
        locs.append(b.flatten(f"{n}_mbox_loc_flat", loc))
        conf = b.conv(f"{n}_mbox_conf", src, np_ * num_classes, 1)
        if bg_bias:
            # a trained-SSD-like score distribution: the background logit
            # raised so that O(100) foreground scores clear the
            # threshold (the random weights' near-uniform softmax lets
            # every prior through); 0.0 keeps the goldens' graph
            bia = b.graph.params[f"{n}_mbox_conf/b"]
            bia[0::num_classes] = bg_bias
        conf = b.permute(f"{n}_mbox_conf_perm", conf)
        confs.append(b.flatten(f"{n}_mbox_conf_flat", conf))
        priors.append(b.priorbox(f"{n}_mbox_priorbox", src, data, **kw))
    loc = b.concat("mbox_loc", locs, axis=1)
    conf = b.concat("mbox_conf", confs, axis=1)
    pb = b.concat("mbox_priorbox", priors, axis=2)
    conf = b.reshape("mbox_conf_reshape", conf, (0, -1, num_classes))
    conf = b.softmax("mbox_conf_softmax", conf)
    conf = b.flatten("mbox_conf_flatten", conf)
    return b.detection_output(
        "detection_out", loc, conf, pb, num_classes,
        nms_threshold=nms_threshold, nms_top_k=nms_top_k,
        keep_top_k=keep_top_k, confidence_threshold=confidence_threshold)


def mobilenet_ssd(batch: int = 1, seed: int = 0, num_classes: int = 21,
                  keep_top_k: int = 100,
                  confidence_threshold: float = 0.25,
                  bg_bias: float = 0.0) -> Graph:
    """MobileNet-SSD 300x300 (the public chuanqi305 VOC deploy): MobileNet
    v1 body (BN folded into the convs, as the deploy ships), 4 extra
    dw-sep-free stages, heads on conv11/conv13/conv14_2..conv17_2 with
    min_sizes 60..285.  Priors per cell: 3 on conv11 (AR {2}), 6 after."""
    b = GraphBuilder("mobilenet_ssd", seed)

    def cbr(name, x, ch, kernel=1, stride=1, pad=0, group=1):
        return b.conv(name, x, ch, kernel, stride, pad, group=group,
                      relu=True)

    def dw_sep(idx, x, ch, stride):
        cin = b._channels[x]
        x = cbr(f"conv{idx}/dw", x, cin, 3, stride, 1, group=cin)
        return cbr(f"conv{idx}", x, ch, 1)

    data = b.input("data", (batch, 300, 300, 3))
    x = cbr("conv0", data, 32, 3, 2, 1)
    x = dw_sep(1, x, 64, 1)
    x = dw_sep(2, x, 128, 2)
    x = dw_sep(3, x, 128, 1)
    x = dw_sep(4, x, 256, 2)
    x = dw_sep(5, x, 256, 1)
    x = dw_sep(6, x, 512, 2)
    for i in range(7, 12):
        x = dw_sep(i, x, 512, 1)
    conv11 = x                                    # 19x19x512
    x = dw_sep(12, x, 1024, 2)
    conv13 = dw_sep(13, x, 1024, 1)               # 10x10x1024
    x = cbr("conv14_1", conv13, 256, 1)
    conv14 = cbr("conv14_2", x, 512, 3, 2, 1)     # 5x5
    x = cbr("conv15_1", conv14, 128, 1)
    conv15 = cbr("conv15_2", x, 256, 3, 2, 1)     # 3x3
    x = cbr("conv16_1", conv15, 128, 1)
    conv16 = cbr("conv16_2", x, 256, 3, 2, 1)     # 2x2
    x = cbr("conv17_1", conv16, 64, 1)
    conv17 = cbr("conv17_2", x, 128, 3, 2, 1)     # 1x1

    def pb(mn, mx=None, ars=(2.0, 3.0)):
        kw = {"min_sizes": [mn], "aspect_ratios": list(ars)}
        if mx is not None:
            kw["max_sizes"] = [mx]
        return kw

    out = _ssd_head(b, data, [
        (conv11, 3, pb(60.0, None, (2.0,))),
        (conv13, 6, pb(105.0, 150.0)),
        (conv14, 6, pb(150.0, 195.0)),
        (conv15, 6, pb(195.0, 240.0)),
        (conv16, 6, pb(240.0, 285.0)),
        (conv17, 6, pb(285.0, 300.0)),
    ], num_classes, keep_top_k=keep_top_k, nms_top_k=100,
        confidence_threshold=confidence_threshold, bg_bias=bg_bias)
    g = b.finish([out])
    # the reference's measured per-model bake
    g.meta["config_overrides"] = {"det_thresh_first": 512}
    return g


def vgg16_ssd300(batch: int = 1, seed: int = 0, num_classes: int = 21,
                 keep_top_k: int = 200,
                 confidence_threshold: float = 0.01,
                 bg_bias: float = 0.0) -> Graph:
    """SSD300 (the original Wei Liu VGG-16 deploy): VGG through conv5_3
    (ceil-mode pool3 75->38, stride-1 3x3 pool5), atrous fc6 (dilation
    6), conv6_1..conv9_2 extras, L2 Normalize (init 20) on conv4_3, 8732
    priors over 38/19/10/5/3/1 grids with steps 8..300."""
    b = GraphBuilder("vgg16_ssd300", seed)
    data = b.input("data", (batch, 300, 300, 3))
    x = data
    for stage, n, ch in [(1, 2, 64), (2, 2, 128), (3, 3, 256),
                         (4, 3, 512), (5, 3, 512)]:
        for i in range(1, n + 1):
            x = b.conv(f"conv{stage}_{i}", x, ch, 3, pad=1, relu=True)
        if stage == 4:
            conv4_3 = x                           # 38x38x512
        if stage < 5:
            x = b.pool(f"pool{stage}", x, 2, 2)   # ceil: 75 -> 38
        else:
            x = b.pool("pool5", x, 3, 1, pad=1)
    x = b.conv("fc6", x, 1024, 3, pad=6, dilation=6, relu=True)
    fc7 = b.conv("fc7", x, 1024, 1, relu=True)    # 19x19x1024
    x = b.conv("conv6_1", fc7, 256, 1, relu=True)
    conv6 = b.conv("conv6_2", x, 512, 3, stride=2, pad=1, relu=True)
    x = b.conv("conv7_1", conv6, 128, 1, relu=True)
    conv7 = b.conv("conv7_2", x, 256, 3, stride=2, pad=1, relu=True)
    x = b.conv("conv8_1", conv7, 128, 1, relu=True)
    conv8 = b.conv("conv8_2", x, 256, 3, relu=True)     # 5 -> 3
    x = b.conv("conv9_1", conv8, 128, 1, relu=True)
    conv9 = b.conv("conv9_2", x, 256, 3, relu=True)     # 3 -> 1
    norm4_3 = b.normalize("conv4_3_norm", conv4_3, init_scale=20.0)

    def pb(mn, mx, step, ars):
        return {"min_sizes": [mn], "max_sizes": [mx], "step": step,
                "aspect_ratios": list(ars)}

    out = _ssd_head(b, data, [
        (norm4_3, 4, pb(30.0, 60.0, 8.0, (2.0,))),
        (fc7, 6, pb(60.0, 111.0, 16.0, (2.0, 3.0))),
        (conv6, 6, pb(111.0, 162.0, 32.0, (2.0, 3.0))),
        (conv7, 6, pb(162.0, 213.0, 64.0, (2.0, 3.0))),
        (conv8, 4, pb(213.0, 264.0, 100.0, (2.0,))),
        (conv9, 4, pb(264.0, 315.0, 300.0, (2.0,))),
    ], num_classes, keep_top_k=keep_top_k, nms_top_k=400,
        confidence_threshold=confidence_threshold, bg_bias=bg_bias)
    g = b.finish([out])
    # the reference's measured per-model bakes
    g.meta["config_overrides"] = {"topk_radix": False,
                                  "det_take_gather": True,
                                  "det_thresh_first": 1024}
    return g


MODEL_BUILDERS = {
    "squeezenet_v11": squeezenet_v11,
    "squeezenet_v10": squeezenet_v10,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "googlenet": googlenet,
    "alexnet": alexnet,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "mobilenet_v1": mobilenet_v1,
    "mobilenet_v2": mobilenet_v2,
    "shufflenet_v1": shufflenet_v1,
    "shufflenet_v2": shufflenet_v2,
    "se_resnet50": se_resnet50,
    "inception_v3": inception_v3,
    "densenet121": densenet121,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "resnext50": resnext50,
    "fcn32s": fcn32s,
    "fcn16s": fcn16s,
    "fcn8s": fcn8s,
    "deeplab_largefov": deeplab_largefov,
    "pspnet50": pspnet50,
    "mobilenet_ssd": mobilenet_ssd,
    "vgg16_ssd300": vgg16_ssd300,
    "faster_rcnn_vgg16": faster_rcnn_vgg16,
    "rfcn_resnet101": rfcn_resnet101,
}


def build_model(name: str, batch: int = 1, **kw) -> Graph:
    try:
        builder = MODEL_BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; the port has "
                       f"{sorted(MODEL_BUILDERS)}") from None
    return builder(batch=batch, **kw)
