"""ResNeXt-50 (32x4d) (Xie et al. 2017, arXiv:1611.05431, Table 1): a 7x7/2
stem of 64 and a 3x3/2 max pool; 16 bottlenecks in stages of [3, 4, 6, 3],
each a 1x1 conv to the stage's interior width (128-1024), a 3x3 conv
grouped at cardinality 32 (4-32 channels a group) and a 1x1 conv to twice
the interior width (256-2048), the stride on the grouped 3x3; a projection
shortcut (1x1, at the block's stride) on each stage's first block; a
global average pool and a 1000-way FC.  Every conv is followed by
BatchNorm + Scale, and by a ReLU but on the shortcut and the last conv of
a branch; the residual add takes the ReLU.

Names are the port's zoo builder's Caffe-style ones (``res2a_branch2b``),
the BatchNorm + Scale pairs as ``<conv>_bnsc``.  The paper's Table 1 is
followed as it stands.  One departure is of the quantized forward
(``_qnet.Quantized``), not of the network: it gives sibling convs (here
each first block's ``branch1`` and ``branch2a``, which read one value)
one output scale, as a merged conv has one; the program merges neither
pair (the 3x3 after ``branch2a`` is grouped, and in stages 3-5 the two
strides differ), so those eight values are held at a scale up to the
larger of the two calibrated ones (PERF.md section 7)."""

from __future__ import annotations


def layers(cfg: dict) -> list:
    out = []

    def conv(name, src, cout, k, stride=1, pad=0, group=1, relu=True):
        out.append({"op": "conv", "name": name, "src": src, "cout": cout,
                    "k": k, "stride": stride, "pad": pad, "group": group,
                    "bn": name + "_bnsc", "relu": relu})
        return name

    x = conv("conv1", "data", 64, 7, 2, 3)
    out.append({"op": "maxpool", "name": "pool1", "src": x, "k": 3,
                "stride": 2, "pad": 0})
    x = "pool1"
    for stage, (ch, blocks) in enumerate(zip(cfg["widths"],
                                             cfg["stage_blocks"]), start=2):
        for i in range(blocks):
            b = f"{stage}{chr(ord('a') + i)}"
            stride = 2 if (i == 0 and stage > 2) else 1
            short = x
            if i == 0:
                short = conv(f"res{b}_branch1", x, ch * 2, 1, stride,
                             relu=False)
            y = conv(f"res{b}_branch2a", x, ch, 1)
            y = conv(f"res{b}_branch2b", y, ch, 3, stride, 1,
                     group=cfg["cardinality"])
            y = conv(f"res{b}_branch2c", y, ch * 2, 1, relu=False)
            out[-1]["residual"] = True
            out.append({"op": "add", "name": f"res{b}", "srcs": [short, y],
                        "relu": True})
            x = f"res{b}"
    out.append({"op": "avgpool", "name": "pool5", "src": x})
    out.append({"op": "fc", "name": "fc1000", "src": "pool5",
                "cout": cfg["classes"]})
    return out
