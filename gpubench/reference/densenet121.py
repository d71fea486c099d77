"""DenseNet-121 (Huang et al. 2017, arXiv:1608.06993, Table 1, DenseNet-BC)
as the public DenseNet-Caffe deploy lays it out: a 7x7/2 stem of twice
the growth rate (64) with its BatchNorm + Scale pair and ReLU, and a 3x3/2
max pool; four dense blocks of [6, 12, 24, 16] layers, each layer a
standalone pair + ReLU (a pre-activation), a 1x1 conv to four times the
growth rate (128) followed by its pair + ReLU, and a 3x3 conv (pad 1) of
the growth rate (32) with no pair after it, its output concatenated after
the block's running value; a transition after each of the first three
blocks, a standalone pair + ReLU, a 1x1 conv to half the channels
(compression 0.5) with no pair, and a 2x2/2 AVE pool; after the last block
a standalone pair + ReLU (``conv5_blk``), a global average pool and a
1000-way FC.

Parameter names are the port's zoo builder's (``conv2_1/x1/w``, the pairs
as ``<prefix>/bn/*`` and ``<prefix>/scale/*``).  Each layer is named after
the value the program holds for it, so that ``witness.py`` finds it: a
pair that follows a conv is folded into that conv, so the conv's name
stands for the conv, its pair and its ReLU (``conv2_1/x1``, whose pair is
``conv2_1/x2``); a standalone pair and its ReLU are the program's Scale
node, ``<prefix>/scale`` (``conv2_1/x1/scale``), as its fusion names the
pair's value (the ReLU's own name, ``<prefix>/relu``, is fused away).  The
paper's Table 1 and the deploy are followed as they stand: the FC has a
bias, no conv has one, no dropout (inference)."""

from __future__ import annotations


def layers(cfg: dict) -> list:
    out = []
    k = cfg["growth_rate"]

    def pair(prefix, src):
        out.append({"op": "bn", "name": prefix + "/scale", "src": src,
                    "bn": prefix, "relu": True})
        return prefix + "/scale"

    def conv(name, src, cout, kernel, stride=1, pad=0, bn=None):
        out.append({"op": "conv", "name": name, "src": src, "cout": cout,
                    "k": kernel, "stride": stride, "pad": pad, "group": 1,
                    "bn": bn, "relu": bn is not None})
        return name

    x = conv("conv1", "data", cfg["stem_width"], 7, 2, 3, bn="conv1")
    out.append({"op": "maxpool", "name": "pool1", "src": x, "k": 3,
                "stride": 2, "pad": 0})
    x, ch = "pool1", cfg["stem_width"]
    for stage, blocks in enumerate(cfg["stage_blocks"], start=2):
        for j in range(1, blocks + 1):
            pre = f"conv{stage}_{j}"
            y = pair(pre + "/x1", x)
            y = conv(pre + "/x1", y, cfg["bottleneck_width"], 1,
                     bn=pre + "/x2")
            y = conv(pre + "/x2", y, k, 3, pad=1)
            out.append({"op": "concat", "name": f"concat_{stage}_{j}",
                        "srcs": [x, y]})
            x, ch = f"concat_{stage}_{j}", ch + k
        if stage < 5:
            ch = int(ch * cfg["compression"])
            y = pair(f"conv{stage}_blk", x)
            y = conv(f"conv{stage}_blk", y, ch, 1)
            out.append({"op": "avgpool", "name": f"pool{stage}", "src": y,
                        "k": 2, "stride": 2, "pad": 0})
            x = f"pool{stage}"
    x = pair("conv5_blk", x)
    out.append({"op": "avgpool", "name": "pool5", "src": x})
    out.append({"op": "fc", "name": "fc6", "src": "pool5",
                "cout": cfg["classes"]})
    return out
