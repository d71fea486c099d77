"""MobileNet-v1 (Howard et al. 2017, arXiv:1704.04861) at width 1.0 as the
Caffe ``mobilenet_deploy.prototxt`` lays it out: a 3x3/2 stem of 32, 13
depthwise-separable blocks (a 3x3 depthwise conv, then a 1x1 conv, each
with BatchNorm + Scale and ReLU), a global average pool and a 1000-way
FC.  Names are the deploy's, the BatchNorm + Scale pairs as
``<conv>_bnsc``."""

from __future__ import annotations


def layers(cfg: dict) -> list:
    out = []
    ch = {"data": cfg["channels"]}

    def conv(name, src, cout, k, stride, pad, group=1, bn=None):
        out.append({"op": "conv", "name": name, "src": src, "cout": cout,
                    "k": k, "stride": stride, "pad": pad, "group": group,
                    "bn": bn or name + "_bnsc", "relu": True})
        ch[name] = cout
        return name

    x = conv("conv1", "data", 32, 3, 2, 1)
    # (output channels, stride) of blocks conv2 .. conv14
    blocks = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] \
        + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
    for i, (cout, stride) in enumerate(blocks, start=2):
        cin = ch[x]
        x = conv(f"conv{i}/dw", x, cin, 3, stride, 1, group=cin,
                 bn=f"conv{i}/dw_bnsc")
        x = conv(f"conv{i}/sep", x, cout, 1, 1, 0, bn=f"conv{i}/sep_bnsc")
    out.append({"op": "avgpool", "name": "pool6", "src": x})
    out.append({"op": "fc", "name": "fc7", "src": "pool6",
                "cout": cfg["classes"]})
    return out
