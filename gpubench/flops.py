"""The frozen count of work: operations and bytes of every conv and FC of
a configuration, from the benchmark's own layer list (``reference/``),
never from the program's optimized graph, so that a fusion or a new
kernel leaves the count as it was.  ``shapes`` knows every layer kind of
``reference/_qnet.py``; pairs, pools, adds and concats are not counted.

Operations are 2 x the multiply-adds.  Bytes: each input and weight
element read once and each output element written once at the precision
the configuration states (``act_bytes`` for activations and weights, and
``float_bytes`` for the float stem's input and the logits); a layer's
weight is read once a batch of ``graph_batch`` images.  A layer's least
time is the larger of its operations at the int8 peak and its bytes at
the memory's bandwidth."""

from __future__ import annotations

import math
from typing import Dict, List

# NVIDIA H100 SXM, dense: int8 tensor-core operations per second and HBM3
# bytes per second (the data sheet, at the 700 W limit).
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


def _pooled(n: int, L: dict) -> int:
    """Caffe's pooled size: ceil mode, the last window starting inside the
    (left-padded) input."""
    k, s, p = L["k"], L["stride"], L["pad"]
    o = math.ceil((n + 2 * p - k) / s) + 1
    return o - 1 if (o - 1) * s >= n + p else o


def shapes(layers: List[dict], cfg: dict) -> Dict[str, tuple]:
    """(H, W, C) of every value of one image."""
    h, w = cfg["input_hw"]
    out = {"data": (h, w, cfg["channels"])}
    for L in layers:
        op = L["op"]
        if op == "conv":
            h, w, _ = out[L["src"]]
            k, s, p = L["k"], L["stride"], L["pad"]
            out[L["name"]] = ((h + 2 * p - k) // s + 1,
                              (w + 2 * p - k) // s + 1, L["cout"])
        elif op == "maxpool" or (op == "avgpool" and "k" in L):
            h, w, c = out[L["src"]]
            out[L["name"]] = (_pooled(h, L), _pooled(w, L), c)
        elif op == "avgpool":
            out[L["name"]] = (1, 1, out[L["src"]][2])
        elif op == "add":
            out[L["name"]] = out[L["srcs"][0]]
        elif op == "concat":
            h, w, _ = out[L["srcs"][0]]
            out[L["name"]] = (h, w, sum(out[v][2] for v in L["srcs"]))
        elif op == "bn":
            out[L["name"]] = out[L["src"]]
        elif op == "fc":
            out[L["name"]] = (1, 1, L["cout"])
    return out


def layer_costs(layers: List[dict], cfg: dict) -> List[dict]:
    """Per conv and FC layer: ``macs`` and ``bytes`` per image."""
    sh = shapes(layers, cfg)
    batch = cfg["graph_batch"]
    act, flt = cfg["act_bytes"], cfg["float_bytes"]
    last = layers[-1]["name"]
    rows = []
    for L in layers:
        if L["op"] not in ("conv", "fc"):
            continue
        hi, wi, ci = sh[L["src"]]
        ho, wo, co = sh[L["name"]]
        if L["op"] == "conv":
            taps = L["k"] * L["k"] * ci // L["group"]
            macs = ho * wo * co * taps
            weights = taps * co
        else:
            macs = weights = hi * wi * ci * co
        in_bytes = hi * wi * ci * (flt if L["src"] == "data" else act)
        out_bytes = ho * wo * co * (flt if L["name"] == last else act)
        rows.append({"name": L["name"], "macs": macs,
                     "bytes": in_bytes + out_bytes + weights * act / batch})
    return rows


def ops_per_image(layers, cfg) -> float:
    return 2.0 * sum(r["macs"] for r in layer_costs(layers, cfg))


def least_seconds_per_image(layers, cfg) -> float:
    """The least time of all conv and FC layers for one image."""
    return sum(max(2.0 * r["macs"] / PEAK_INT8_OPS,
                   r["bytes"] / PEAK_HBM_BYTES)
               for r in layer_costs(layers, cfg))
