"""Synthesize a wire-format ``.caffemodel`` for a deploy prototxt — the
port's own copy of ``tools/synth_caffemodel.py``, byte for byte the same
output for the same deploy and seed.

Fills every parameterized layer of a real deploy (``tools/deploys/``) with
seeded Glorot-ish random blobs and encodes a NetParameter with the port's
wire codec (``caffe_pb.py``), so that the real-weights validation
(``validate_real.py``) runs end to end before genuine weights exist:

    python -m feathercnn_tpu_torch.tools.synth_caffemodel \
        tools/deploys/resnet50_deploy.prototxt resnet50_synth.caffemodel
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List

import numpy as np

from .caffe_pb import NET_PARAMETER, encode
from .prototxt import parse_prototxt


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _first(v, default=None):
    lst = _as_list(v)
    return lst[0] if lst else default


def synth_net(deploy_text: str, seed: int = 0) -> bytes:
    """NetParameter bytes with random weights bound to the deploy's
    layer names.  Channel counts are tracked through the graph so conv
    and InnerProduct fan-ins are right."""
    net = parse_prototxt(deploy_text)
    rng = np.random.default_rng(seed)
    ch: Dict[str, int] = {}
    # spatial tracking for InnerProduct fan-in (Caffe flattens C*H*W)
    sp: Dict[str, tuple] = {}
    for name, shape in zip(_as_list(net.get("input")),
                           _as_list(net.get("input_shape"))):
        dims = [int(d) for d in _as_list(shape.get("dim"))]
        ch[name] = dims[1] if len(dims) > 1 else 1
        sp[name] = tuple(dims[2:]) if len(dims) > 2 else ()
    if _as_list(net.get("input")) and net.get("input_dim"):
        dims = [int(d) for d in _as_list(net["input_dim"])]
        name = _as_list(net["input"])[0]
        ch[name] = dims[1]
        sp[name] = tuple(dims[2:])

    def blob(arr: np.ndarray) -> dict:
        return {"shape": {"dim": list(arr.shape)},
                "data": arr.astype(np.float32).ravel()}

    out_layers: List[dict] = []
    for layer in _as_list(net.get("layer")):
        lt = layer["type"]
        name = layer["name"]
        bots = _as_list(layer.get("bottom"))
        tops = _as_list(layer.get("top"))
        cin = ch.get(bots[0]) if bots else None
        spin = sp.get(bots[0], ()) if bots else ()
        blobs = []
        cout = cin
        spout = spin
        if lt == "Convolution":
            p = layer.get("convolution_param", {})
            cout = int(p["num_output"])
            k = int(_first(p.get("kernel_size"), 1))
            s = int(_first(p.get("stride"), 1))
            pad = int(_first(p.get("pad"), 0))
            grp = int(p.get("group", 1))
            w = rng.normal(0, (2.0 / (cin // grp * k * k)) ** 0.5,
                           size=(cout, cin // grp, k, k))
            blobs = [blob(w)]
            if bool(p.get("bias_term", True)):
                blobs.append(blob(np.zeros(cout)))
            if spin:
                spout = tuple((d + 2 * pad - k) // s + 1 for d in spin)
        elif lt == "InnerProduct":
            p = layer.get("inner_product_param", {})
            cout = int(p["num_output"])
            fan_in = cin * int(np.prod(spin)) if spin else cin
            w = rng.normal(0, (1.0 / fan_in) ** 0.5, size=(cout, fan_in))
            blobs = [blob(w)]
            if bool(p.get("bias_term", True)):
                blobs.append(blob(np.zeros(cout)))
            spout = ()
        elif lt == "BatchNorm":
            # mean, variance, scale_factor — Caffe divides by the factor
            blobs = [blob(rng.normal(0, 0.1, size=cin)),
                     blob(rng.uniform(0.5, 2.0, size=cin)),
                     blob(np.asarray([1.0]))]
        elif lt == "Scale":
            p = layer.get("scale_param", {})
            blobs = [blob(rng.uniform(0.5, 1.5, size=cin))]
            if bool(p.get("bias_term", False)):
                blobs.append(blob(rng.normal(0, 0.1, size=cin)))
        elif lt == "PReLU":
            blobs = [blob(rng.uniform(0.1, 0.3, size=cin))]
        elif lt == "Concat":
            cout = sum(ch[b] for b in bots)
        elif lt == "Pooling":
            p = layer.get("pooling_param", {})
            if bool(p.get("global_pooling", False)):
                spout = (1, 1) if spin else ()
            elif spin:
                k = int(_first(p.get("kernel_size"), 1))
                s = int(_first(p.get("stride"), 1))
                pad = int(_first(p.get("pad"), 0))
                spout = tuple(
                    int(math.ceil((d + 2 * pad - k) / s)) + 1
                    for d in spin)
        elif lt == "Eltwise":
            cout = ch[bots[0]]
        # in-place / passthrough ops keep cin/spin
        for t in tops:
            ch[t] = cout
            sp[t] = spout
        entry = {"name": name, "type": lt,
                 "bottom": bots, "top": tops}
        if blobs:
            entry["blobs"] = blobs
        out_layers.append(entry)

    return encode({"name": "synthetic", "layer": out_layers},
                  NET_PARAMETER)


def write_synth(deploy: str, out: str, seed: int = 0) -> int:
    """Write ``synth_net`` of the deploy file ``deploy`` to ``out``;
    returns its size in bytes."""
    with open(deploy) as f:
        data = synth_net(f.read(), seed=seed)
    with open(out, "wb") as f:
        f.write(data)
    return len(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write a seeded synthetic .caffemodel for a deploy")
    ap.add_argument("deploy")
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    size = write_synth(args.deploy, args.out, args.seed)
    print(f"wrote {args.out}: {size/1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
