"""Channel tensor parallelism — counterpart of ``feathercnn_tpu/parallel/tp.py``.

The Megatron column/row-parallel pair restated for convolutions, with a
process group in place of the reference's ``(mesh, axis)`` and explicit
collectives in place of ``shard_map``.  Each function takes the arrays this
rank holds under the reference's ``in_specs`` and returns what it holds
under its ``out_specs``:

  - column-parallel: W split on C_out, x whole; each rank computes its
    channel slice (all-gathered on channels with ``gather_output``).
  - row-parallel: W split on C_in, x channel-split (a column-parallel
    layer's output); the partial results are summed with ``all_reduce``
    (``reduce_scatter`` on channels with ``scatter_output``).

The convs are ``F.conv2d`` in NHWC/HWIO terms, as the reference's
``conv_general_dilated`` (outside any Pallas kernel) is.

``shard_graph`` is the engine's form of column parallelism: a rank-local
copy of an optimized graph in which every TP node (``param_shardings``)
holds its output-channel slice of the weight, the bias, the per-channel
``w_scale`` and the merged convs' ``act_segments``.  The engine computes
each TP node's slice on the hand-written kernels and all-gathers it on
channels before any reader (``ops/lowering.py``): exact under int8, since
each output column's int32 sum and epilogue do not read the others.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..numerics import nchw_conv
from .dist import all_gather, all_reduce, reduce_scatter

__all__ = ["column_parallel_conv", "row_parallel_conv", "tp_conv_pair",
           "shard_graph"]


def _conv_nhwc(x, w, stride, pad):
    return nchw_conv(x.float(), w.float(), stride, pad).to(x.dtype)


def column_parallel_conv(group, x, w, bias=None, stride: int = 1,
                         pad: int = 0, gather_output: bool = False):
    """``w`` (KH, KW, Cin, Cout/n) and ``bias`` (Cout/n) this rank's slice
    of C_out; ``x`` whole.  Returns this rank's channel slice of the
    output, or the whole output with ``gather_output``."""
    y = _conv_nhwc(x, w, stride, pad)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if gather_output:
        y = all_gather(y, 3, group)
    return y


def row_parallel_conv(group, x, w, bias=None, stride: int = 1, pad: int = 0,
                      scatter_output: bool = False):
    """``x`` this rank's channel slice (N, H, W, Cin/n), ``w`` (KH, KW,
    Cin/n, Cout) the matching rows.  The partial products are summed over
    the group; with ``scatter_output`` each rank keeps its C_out slice
    (``bias`` then its slice too)."""
    part = _conv_nhwc(x, w, stride, pad)
    y = (reduce_scatter(part, 3, group) if scatter_output
         else all_reduce(part, group))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def tp_conv_pair(group, x, w1, b1, w2, b2, stride1: int = 1, pad1: int = 0,
                 stride2: int = 1, pad2: int = 0):
    """Column-parallel conv1 -> ReLU -> row-parallel conv2 with one
    ``all_reduce``: ``w1``/``b1`` this rank's C_out slice, ``w2`` the
    matching C_in rows, ``b2`` whole.  Returns the whole output."""
    h = _conv_nhwc(x, w1, stride1, pad1) + b1.to(x.dtype)
    h = torch.clamp_min(h, 0)
    y = all_reduce(_conv_nhwc(h, w2, stride2, pad2), group)
    return y + b2.to(y.dtype)


# ----------------------------------------------------------------------
# the engine's rank-local graph
# ----------------------------------------------------------------------

def _segments_slice(segments, c0: int, c1: int):
    """The ``act_segments`` of output channels [c0, c1): each kept
    channel keeps its own activation."""
    out, start = [], 0
    for act, c in segments:
        lo, hi = max(start, c0), min(start + c, c1)
        if hi > lo:
            out.append((act, hi - lo))
        start += c
    return tuple(out)


def shard_graph(graph, mesh, cfg) -> Tuple[
        object, Dict[str, Tuple[int, int, Optional[Tuple[int, int]]]]]:
    """(rank-local copy of ``graph``, TP node name -> (c0, c1, inputs):
    its [c0, c1) output channels on this rank, and for a depthwise conv
    the [i0, i1) input channels they read, None for any other node, which
    reads its whole input).  A depthwise conv of channel multiplier m
    (C_out = m C_in) reads [c0/m, c1/m) in (c1 - c0)/m groups; one whose
    groups do not divide the model axis raises, since a rank's slice would
    split a group's outputs.  Nodes outside TP, and every param they read,
    are shared with ``graph``; a TP node is a copy whose params, bias,
    ``w_scale``, ``act_segments`` and ``num_output`` (and a depthwise
    conv's ``group``) are this rank's slice."""
    from .mesh import param_shardings
    shardings = param_shardings(graph, mesh, cfg)
    n = mesh.shape[cfg.model_axis]
    me = mesh.coords[cfg.model_axis]
    local = copy.copy(graph)
    local.nodes = list(graph.nodes)
    local.params = dict(graph.params)
    local.meta = dict(graph.meta)
    quant = dict(graph.meta.get("quant", {}))
    slices: Dict[str, Tuple[int, int, Optional[Tuple[int, int]]]] = {}
    for i, node in enumerate(graph.nodes):
        if (node.op not in ("Convolution", "InnerProduct") or not node.params
                or shardings[node.params[0]][-1:] != (cfg.model_axis,)):
            continue
        cout = np.asarray(graph.params[node.params[0]]).shape[-1]
        c0, c1 = me * cout // n, (me + 1) * cout // n
        groups = node.attrs.get("group", 1)   # > 1: Cin/g == 1 here
        reads = None
        if groups > 1:
            if groups % n:
                raise ValueError(
                    f"{node.name}: depthwise conv of {groups} groups and "
                    f"{cout} outputs cannot split over {n} model ranks")
            m = cout // groups
            reads = (c0 // m, c1 // m)
        slices[node.name] = (c0, c1, reads)
        mine = copy.copy(node)
        mine.attrs = dict(node.attrs)
        mine.attrs["num_output"] = c1 - c0
        if reads is not None:
            mine.attrs["group"] = reads[1] - reads[0]
        if node.attrs.get("act_segments"):
            mine.attrs["act_segments"] = _segments_slice(
                node.attrs["act_segments"], c0, c1)
        for p in node.params:
            a = np.asarray(graph.params[p])
            if shardings[p][-1:] == (cfg.model_axis,):
                local.params[p] = np.ascontiguousarray(a[..., c0:c1])
        q = quant.get(node.name)
        if q is not None and np.ndim(q.get("w_scale")) == 1:
            q = dict(q)
            q["w_scale"] = np.ascontiguousarray(
                np.asarray(q["w_scale"])[c0:c1])
            quant[node.name] = q
        local.nodes[i] = mine
    if quant:
        local.meta["quant"] = quant
    return local, slices
