"""Model summary — a copy of ``feathercnn_tpu/utils/summary.py``: per-layer
output shape, params, FLOPs and activation bytes.

FLOPs count MAC*2 on conv/deconv/FC and the fused bottlenecks; bytes are
the layer's output activation at the stated dtype.  The same graph gives
the reference's string.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["node_flops", "summarize"]


def node_flops(graph, n) -> float:
    """MAC*2 FLOPs of one node (0 for ops other than conv, deconv, FC
    and the fused bottlenecks)."""
    if n.op in ("FusedBottleneck", "FusedChain"):
        spec = graph.specs[n.outputs[0]]
        _, oh, ow, c = spec.shape
        w1 = graph.params[n.params[0]]
        cm = w1.shape[-1]
        nb = n.attrs.get("nb", 1)
        return 2.0 * oh * ow * (2 * c * cm + 9 * cm * cm) * nb
    if n.op in ("Convolution", "Deconvolution"):
        kh = n.attrs.get("kernel_h", n.attrs.get("kernel_size", 1))
        kw = n.attrs.get("kernel_w", n.attrs.get("kernel_size", 1))
        group = n.attrs.get("group", 1)
        in_spec = graph.specs[n.inputs[0]]
        cin = in_spec.shape[-1]
        if n.op == "Deconvolution":
            _, oh, ow, _ = in_spec.shape
            co = n.attrs["num_output"]
        else:
            _, oh, ow, co = graph.specs[n.outputs[0]].shape
        return 2.0 * oh * ow * co * kh * kw * (cin / group)
    if n.op == "InnerProduct":
        w = graph.params[n.params[0]]
        return 2.0 * w.shape[0] * w.shape[1]
    return 0.0


def summarize(graph, act_bytes: int = 4,
              top: Optional[int] = None) -> str:
    """Text table of the (post-pass, if called on an Engine's graph)
    layers: output shape, params, FLOPs/img, output MB/img."""
    if not graph.specs:   # .ftpu loads arrive spec-less
        from ..ir import infer_shapes
        infer_shapes(graph)
    batch = next(iter(graph.inputs.values())).shape[0] or 1
    rows: List[tuple] = []
    tot_p = tot_f = tot_b = 0.0
    for n in graph.nodes:
        spec = graph.specs[n.outputs[0]]
        n_params = sum(int(np.prod(graph.params[p].shape))
                       for p in n.params)
        # node_flops is already per-image (batch never enters the
        # formula); only the activation bytes carry the batch dim.
        fl = node_flops(graph, n)
        out_b = spec.size / batch * act_bytes
        tot_p += n_params
        tot_f += fl
        tot_b += out_b
        rows.append((n.name, n.op, spec.shape, n_params, fl, out_b))
    if top:
        rows = sorted(rows, key=lambda r: -r[4])[:top]
    w_name = max([len(r[0]) for r in rows] + [5])
    lines = [f"{'layer':{w_name}s} {'op':16s} {'output':22s} "
             f"{'params':>12s} {'MFLOPs/img':>11s} {'out MB/img':>11s}"]
    for name, op, shape, p, fl, ob in rows:
        lines.append(f"{name:{w_name}s} {op:16s} {str(shape):22s} "
                     f"{p:12,d} {fl / 1e6:11.1f} {ob / 1e6:11.3f}")
    lines.append(
        f"TOTAL: {tot_p / 1e6:.2f}M params, {tot_f / 1e9:.2f} GFLOPs/img, "
        f"{tot_b / 1e6:.1f} MB activations/img (@{act_bytes}B)")
    return "\n".join(lines)
