"""ResNet-50 (He et al. 2015, arXiv:1512.03385) as the Caffe deploy
``ResNet-50-deploy.prototxt`` lays it out: a 7x7/2 stem, a 3x3/2 max pool,
16 bottlenecks in stages of [3, 4, 6, 3] at widths 64-512 (outputs
256-2048; the stride on the first 1x1 of a stage, as Caffe's model has
it), a projection shortcut on each stage's first block, a global average
pool and a 1000-way FC.  Names are the deploy's, but the stem's BatchNorm,
named ``conv1_bn`` here."""

from __future__ import annotations


def layers(cfg: dict) -> list:
    out = []

    def conv(name, src, cout, k, stride=1, pad=0, relu=True, bn=None):
        out.append({"op": "conv", "name": name, "src": src, "cout": cout,
                    "k": k, "stride": stride, "pad": pad, "group": 1,
                    "bn": bn or "bn" + name[3:], "relu": relu})
        return name

    x = conv("conv1", "data", 64, 7, 2, 3, bn="conv1_bn")
    out.append({"op": "maxpool", "name": "pool1", "src": x, "k": 3,
                "stride": 2, "pad": 0})
    x = "pool1"
    for stage, (ch, blocks) in enumerate(zip([64, 128, 256, 512],
                                             cfg["stage_blocks"]), start=2):
        for i in range(blocks):
            b = f"{stage}{chr(ord('a') + i)}"
            stride = 2 if (i == 0 and stage > 2) else 1
            short = x
            if i == 0:
                short = conv(f"res{b}_branch1", x, ch * 4, 1, stride,
                             relu=False)
            y = conv(f"res{b}_branch2a", x, ch, 1, stride)
            y = conv(f"res{b}_branch2b", y, ch, 3, 1, 1)
            y = conv(f"res{b}_branch2c", y, ch * 4, 1, relu=False)
            out[-1]["residual"] = True
            out.append({"op": "add", "name": f"res{b}", "srcs": [short, y],
                        "relu": True})
            x = f"res{b}"
    out.append({"op": "avgpool", "name": "pool5", "src": x})
    out.append({"op": "fc", "name": "fc1000", "src": "pool5",
                "cout": cfg["classes"]})
    return out
