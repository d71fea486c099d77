"""Space-to-depth stem rewrite — a copy of ``feathercnn_tpu/passes_stem.py``
(``EngineConfig.s2d_stem``; the MLPerf ResNet trick).

Rewrites

    conv7x7 s2 p3 (C=3)   over (N, 224, 224, 3)

as

    space-to-depth 2x2 -> (N, 115, 115, 12)
    conv4x4 s1        with weights re-packed from the padded 8x8 kernel

which quadruples K (3->12), removes the stride, and keeps the arithmetic
exactly equal (the 8th kernel row/col is zero padding).  The rewrite
inserts a ``SpaceToDepth`` node and swaps the conv's attrs/weights;
everything else (bias, fused activation, quantization metadata) carries
over unchanged.  ``SpaceToDepth``'s shape function lives in ``ir.py`` with
the others, so a graph saved after the pass loads without this module.

Derivation: y[oh,ow] = sum_{kh,kw} xp[2oh+kh, 2ow+kw] w[kh,kw] with xp
padded by 3.  Write kh = 2a+i (a in 0..3, i in 0..1 after zero-padding w
to 8x8): xp[2(oh+a)+i, ...] = s2d(xp)[oh+a, ow+b, (i,j)-plane], so the
4x4 s1 conv over the 2x2-space-to-depth of xp with weights
w8[2a+i, 2b+j] -> w4[a, b, (i, j, c)] reproduces y exactly.
"""

from __future__ import annotations

import numpy as np

from .ir import Graph, Node

__all__ = ["space_to_depth_stem"]


def space_to_depth_stem(graph: Graph) -> int:
    """Rewrite eligible stem convs; returns how many were rewritten."""
    count = 0
    new_nodes = []
    for node in graph.nodes:
        a = node.attrs
        eligible = (
            node.op == "Convolution"
            and a.get("kernel_h", a.get("kernel_size", 1)) == 7
            and a.get("kernel_w", a.get("kernel_size", 1)) == 7
            and a.get("stride_h", a.get("stride", 1)) == 2
            and a.get("stride_w", a.get("stride", 1)) == 2
            and a.get("pad_h", a.get("pad", 0)) == 3
            and a.get("group", 1) == 1 and a.get("dilation", 1) == 1
            and graph.specs.get(node.inputs[0]) is not None
            and graph.specs[node.inputs[0]].shape[-1] <= 4
            and graph.specs[node.inputs[0]].shape[1] % 2 == 0
        )
        if not eligible:
            new_nodes.append(node)
            continue

        c_in = graph.specs[node.inputs[0]].shape[-1]
        w = np.asarray(graph.params[node.params[0]])  # (7,7,C,O), f32 or int8
        co = w.shape[-1]
        w8 = np.zeros((8, 8, c_in, co), w.dtype)
        w8[:7, :7] = w
        # w8[2a+i, 2b+j, c, o] -> w4[a, b, (i, j, c), o]
        w4 = w8.reshape(4, 2, 4, 2, c_in, co).transpose(0, 2, 1, 3, 4, 5)
        w4 = np.ascontiguousarray(w4.reshape(4, 4, 4 * c_in, co))
        graph.params[node.params[0]] = w4

        s2d_out = node.inputs[0] + "/s2d"
        new_nodes.append(Node(
            name=node.name + "/s2d", op="SpaceToDepth",
            inputs=[node.inputs[0]], outputs=[s2d_out],
            attrs={"block": 2, "pad": 3}))
        node.inputs = [s2d_out]
        node.attrs = dict(a)
        node.attrs.update(kernel_h=4, kernel_w=4, kernel_size=4,
                          stride=1, stride_h=1, stride_w=1,
                          pad=0, pad_h=0, pad_w=0)
        new_nodes.append(node)
        count += 1
    if count:
        graph.nodes = new_nodes
    return count
