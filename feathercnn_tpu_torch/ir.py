"""Typed intermediate representation — a copy of ``feathercnn_tpu/ir.py``
(``TensorSpec``, ``Node``, ``Graph``, ``infer_shapes``, ``conv_out_dim``)
with the shape functions of the ops the port lowers.

A model is a flat, topologically ordered list of Caffe-shaped nodes
(Convolution, Pooling, InnerProduct, BatchNorm, Scale, Eltwise, ...) wired
by value name, with weights in ``Graph.params``.  Passes rewrite the graph
before the engine walks it.  The IR is NHWC end to end, with HWIO conv
weights and (in, out) FC weights, exactly as in the reference, so both
engines read one graph the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

__all__ = [
    "TensorSpec",
    "Node",
    "Graph",
    "register_shape_fn",
    "infer_shapes",
    "topo_sort",
]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype of one IR value.  NHWC for rank-4 feature maps.

    The analog of ``feather::Blob``'s (num, channels, height, width) header
    ([pub] src/blob.h) — but data lives in ``Graph.params`` / tensors,
    never inside the spec.
    """

    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def with_dtype(self, dtype: str) -> "TensorSpec":
        return TensorSpec(self.shape, dtype)


@dataclasses.dataclass
class Node:
    """One operator instance.

    The analog of a constructed ``feather::Layer`` ([pub] src/layer.h):
    ``op`` is the Caffe type string, ``inputs``/``outputs`` are the
    bottom/top blob names, ``attrs`` is the parsed <op>_param table, and
    ``params`` names weight entries in ``Graph.params`` (the layer's
    ``weight_blobs_``).
    """

    name: str
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    params: List[str] = dataclasses.field(default_factory=list)

    def attr(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)


@dataclasses.dataclass
class Graph:
    """A whole model: the analog of ``feather::Net``'s parsed state.

    - ``inputs``: name -> TensorSpec for graph inputs (InputLayer analog).
    - ``outputs``: names of the values returned by a forward pass.
    - ``nodes``: topologically ordered operator list.
    - ``params``: name -> ndarray weight store (host side; the engine
      moves it to the device once).
    - ``specs``: name -> TensorSpec for every value, filled by
      ``infer_shapes`` (the analog of GenerateTopBlobs).
    """

    name: str
    inputs: Dict[str, TensorSpec]
    outputs: List[str]
    nodes: List[Node]
    params: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    specs: Dict[str, TensorSpec] = dataclasses.field(default_factory=dict)
    # Free-form metadata (quantization scales live under "quant").
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    def node_map(self) -> Dict[str, Node]:
        return {n.name: n for n in self.nodes}

    def producers(self) -> Dict[str, Node]:
        """Map value-name -> producing node."""
        out: Dict[str, Node] = {}
        for n in self.nodes:
            for o in n.outputs:
                out[o] = n
        return out

    def consumers(self) -> Dict[str, List[Node]]:
        """Map value-name -> consuming nodes."""
        out: Dict[str, List[Node]] = {}
        for n in self.nodes:
            for i in n.inputs:
                out.setdefault(i, []).append(n)
        return out

    def validate(self) -> None:
        """Structural checks: SSA, defined-before-use, outputs exist."""
        defined = set(self.inputs)
        names = set()
        for n in self.nodes:
            if n.name in names:
                raise ValueError(f"duplicate node name {n.name!r}")
            names.add(n.name)
            for i in n.inputs:
                if i not in defined:
                    raise ValueError(
                        f"node {n.name!r} reads undefined value {i!r}"
                    )
            for o in n.outputs:
                if o in defined:
                    raise ValueError(
                        f"node {n.name!r} redefines value {o!r} (IR is SSA)"
                    )
                defined.add(o)
            for p in n.params:
                if p not in self.params:
                    raise ValueError(
                        f"node {n.name!r} references missing param {p!r}"
                    )
        for o in self.outputs:
            if o not in defined:
                raise ValueError(f"graph output {o!r} is never defined")

    def param_arrays(self, node: Node) -> List[np.ndarray]:
        return [self.params[p] for p in node.params]


# ----------------------------------------------------------------------
# Topological sort (converter emits Caffe order which is already topo, but
# passes may append/remove nodes; keep a canonicalizer).
# ----------------------------------------------------------------------

def topo_sort(graph: Graph) -> None:
    ready = set(graph.inputs)
    remaining = list(graph.nodes)
    ordered: List[Node] = []
    while remaining:
        progressed = False
        still: List[Node] = []
        for n in remaining:
            if all(i in ready for i in n.inputs):
                ordered.append(n)
                ready.update(n.outputs)
                progressed = True
            else:
                still.append(n)
        if not progressed:
            stuck = [n.name for n in still]
            raise ValueError(f"graph has a cycle or undefined inputs: {stuck}")
        remaining = still
    graph.nodes = ordered


# ----------------------------------------------------------------------
# Shape inference — per-op registry, the analog of Layer::GenerateTopBlobs
# ([pub] src/layer.cpp).  All rank-4 shapes are NHWC.
# ----------------------------------------------------------------------

ShapeFn = Callable[[Node, List[TensorSpec], Graph], List[TensorSpec]]
_SHAPE_FNS: Dict[str, ShapeFn] = {}


def register_shape_fn(op: str):
    def deco(fn: ShapeFn) -> ShapeFn:
        _SHAPE_FNS[op] = fn
        return fn

    return deco


def infer_shapes(graph: Graph) -> None:
    graph.specs = dict(graph.inputs)
    for n in graph.nodes:
        in_specs = [graph.specs[i] for i in n.inputs]
        fn = _SHAPE_FNS.get(n.op)
        if fn is None:
            raise NotImplementedError(f"no shape fn for op {n.op!r}")
        out_specs = fn(n, in_specs, graph)
        if len(out_specs) != len(n.outputs):
            raise ValueError(
                f"{n.name}: shape fn returned {len(out_specs)} specs for "
                f"{len(n.outputs)} outputs"
            )
        for name, spec in zip(n.outputs, out_specs):
            graph.specs[name] = spec


# -- helpers -----------------------------------------------------------

def conv_out_dim(size: int, kernel: int, stride: int, pad: int,
                 dilation: int = 1, ceil_mode: bool = False) -> int:
    """Caffe's output-size arithmetic.

    Convolution uses floor; Pooling uses ceil (Caffe's historical quirk,
    which the reference inherits via its Caffe-converted models).
    """
    eff = dilation * (kernel - 1) + 1
    num = size + 2 * pad - eff
    if ceil_mode:
        out = -(-num // stride) + 1
        # Caffe clips the last pooling window to start inside the padded
        # region ([pub] behavior of PoolingLayer::Reshape).
        if pad > 0 and (out - 1) * stride >= size + pad:
            out -= 1
    else:
        out = num // stride + 1
    return int(out)


def _conv_attrs(node: Node):
    a = node.attrs
    kh = a.get("kernel_h", a.get("kernel_size", 1))
    kw = a.get("kernel_w", a.get("kernel_size", 1))
    sh = a.get("stride_h", a.get("stride", 1))
    sw = a.get("stride_w", a.get("stride", 1))
    ph = a.get("pad_h", a.get("pad", 0))
    pw = a.get("pad_w", a.get("pad", 0))
    dil = a.get("dilation", 1)
    return kh, kw, sh, sw, ph, pw, dil


@register_shape_fn("Input")
def _input_shape(node, in_specs, graph):
    return [TensorSpec(tuple(node.attrs["shape"]))]


@register_shape_fn("Convolution")
def _conv_shape(node, in_specs, graph):
    (n, h, w, c) = in_specs[0].shape
    kh, kw, sh, sw, ph, pw, dil = _conv_attrs(node)
    co = node.attrs["num_output"]
    oh = conv_out_dim(h, kh, sh, ph, dil)
    ow = conv_out_dim(w, kw, sw, pw, dil)
    return [TensorSpec((n, oh, ow, co), in_specs[0].dtype)]


@register_shape_fn("Deconvolution")
def _deconv_shape(node, in_specs, graph):
    """Transposed conv (Caffe Deconvolution, the FCN upsampling op):
    out = stride*(in-1) + dilated_kernel - 2*pad."""
    (n, h, w, c) = in_specs[0].shape
    kh, kw, sh, sw, ph, pw, dil = _conv_attrs(node)
    co = node.attrs["num_output"]
    oh = sh * (h - 1) + dil * (kh - 1) + 1 - 2 * ph
    ow = sw * (w - 1) + dil * (kw - 1) + 1 - 2 * pw
    return [TensorSpec((n, oh, ow, co), in_specs[0].dtype)]


def _interp_out(size: int, attrs) -> int:
    """Caffe InterpLayer (the DeepLab fork) output size, align-corners:
    zoom gives (in-1)*z+1, shrink (in-1)/s+1, shrink first."""
    if attrs.get("shrink_factor", 1) != 1:
        size = (size - 1) // attrs["shrink_factor"] + 1
    if attrs.get("zoom_factor", 1) != 1:
        size = (size - 1) * attrs["zoom_factor"] + 1
    return size


@register_shape_fn("Interp")
def _interp_shape(node, in_specs, graph):
    (n, h, w, c) = in_specs[0].shape
    a = node.attrs
    # pad_beg/pad_end are <= 0 (a crop before the resize)
    h += a.get("pad_beg", 0) + a.get("pad_end", 0)
    w += a.get("pad_beg", 0) + a.get("pad_end", 0)
    oh = a.get("height") or _interp_out(h, a)
    ow = a.get("width") or _interp_out(w, a)
    return [TensorSpec((n, int(oh), int(ow), c), in_specs[0].dtype)]


def _priorbox_count(node) -> int:
    """Priors per feature-map cell (Caffe PriorBoxLayer Reshape):
    one per min_size, one sqrt(min*max) per max_size, plus one per extra
    aspect ratio (x2 when flipped) per min_size."""
    a = node.attrs
    n_min = len(a.get("min_sizes", []))
    n_max = len(a.get("max_sizes", []))
    ars = [r for r in a.get("aspect_ratios", []) if abs(r - 1.0) > 1e-6]
    per_ar = 2 if a.get("flip", True) else 1
    return n_min * (1 + per_ar * len(ars)) + n_max


@register_shape_fn("PriorBox")
def _priorbox_shape(node, in_specs, graph):
    """(1, 2, H*W*num_priors*4): row 0 = boxes, row 1 = variances
    (Caffe ssd PriorBoxLayer top shape)."""
    (_, h, w, _) = in_specs[0].shape
    return [TensorSpec((1, 2, h * w * _priorbox_count(node) * 4),
                       "float32")]


@register_shape_fn("Permute")
def _permute_shape(node, in_specs, graph):
    """Caffe ssd PermuteLayer.  Only order (0,2,3,1) is supported — the
    SSD head pattern NCHW->NHWC, which is the IDENTITY in this IR's NHWC
    storage; after it the value is treated as a literal tensor (Flatten
    then reads it in Caffe's post-permute order for free)."""
    order = tuple(node.attrs.get("order", (0, 1, 2, 3)))
    if order == (0, 1, 2, 3):
        return [in_specs[0]]
    if order != (0, 2, 3, 1):
        raise NotImplementedError(
            f"{node.name}: Permute order {order} (only the SSD NCHW->NHWC "
            "pattern (0,2,3,1) is supported)")
    return [in_specs[0]]


@register_shape_fn("Normalize")
def _normalize_shape(node, in_specs, graph):
    return [in_specs[0]]


@register_shape_fn("DetectionOutput")
def _detection_output_shape(node, in_specs, graph):
    """Fixed-shape variant of Caffe ssd DetectionOutputLayer: the
    reference emits a ragged (1, 1, num_det, 7); static XLA shapes make
    it (N, keep_top_k, 7) padded with label -1 rows."""
    n = in_specs[0].shape[0]
    keep = int(node.attrs.get("keep_top_k", 200))
    return [TensorSpec((n, keep, 7), "float32")]


@register_shape_fn("Proposal")
def _proposal_shape(node, in_specs, graph):
    """RPN ProposalLayer (the C++ 'Proposal' layer of the Faster R-CNN
    Caffe forks; semantics of py-faster-rcnn's proposal_layer.py):
    anchors + deltas -> decoded, clipped, NMS'd ROIs.  Static-shape
    form: (batch * post_nms_top_n, 5) rows [batch_idx, x1, y1, x2, y2]
    with batch_idx = image index (-1 on padding rows); per-image NMS
    vmaps over the batch (the reference layer is batch-1 only).  A
    second output is NOT emitted — the deploy graphs only consume the
    rois."""
    n = int(node.attrs.get("post_nms_top_n", 300))
    batch = int(in_specs[0].shape[0])
    return [TensorSpec((batch * n, 5), "float32")]


@register_shape_fn("ROIPooling")
def _roipool_shape(node, in_specs, graph):
    """Fast R-CNN ROIPoolingLayer: (R, pooled_h, pooled_w, C)."""
    r = in_specs[1].shape[0]
    c = in_specs[0].shape[-1]
    ph = int(node.attrs["pooled_h"])
    pw = int(node.attrs["pooled_w"])
    return [TensorSpec((r, ph, pw, c), in_specs[0].dtype)]


@register_shape_fn("PSROIPooling")
def _psroipool_shape(node, in_specs, graph):
    """R-FCN's position-sensitive ROI pooling (psroi_pooling_layer.cu):
    (R, group_size, group_size, output_dim) — each bin averages its own
    channel group."""
    r = in_specs[1].shape[0]
    k = int(node.attrs["group_size"])
    c = int(node.attrs["output_dim"])
    cin = in_specs[0].shape[-1]
    if cin != k * k * c:
        raise ValueError(
            f"{node.name}: PSROIPooling input channels {cin} != "
            f"group_size^2 * output_dim = {k * k * c}")
    if node.attrs.get("fuse_ave"):
        # fused vote-average tail (passes.fuse_psroi_ave): the global
        # AVE pool's (R, 1, 1, C) shape, bins contracted away
        return [TensorSpec((r, 1, 1, c), in_specs[0].dtype)]
    return [TensorSpec((r, k, k, c), in_specs[0].dtype)]


@register_shape_fn("Crop")
def _crop_shape(node, in_specs, graph):
    """Caffe Crop: bottom[0] cut to bottom[1]'s size on the NHWC
    ``axes``."""
    axes = node.attrs.get("axes", [1, 2])
    shape = list(in_specs[0].shape)
    for d in axes:
        shape[d % in_specs[0].rank] = in_specs[1].shape[d]
    return [TensorSpec(tuple(shape), in_specs[0].dtype)]


@register_shape_fn("SPP")
def _spp_shape(node, in_specs, graph):
    """Caffe SPPLayer: 2^l x 2^l bins for l < pyramid_height, each
    flattened in NCHW order and concatenated -> (N, C*sum(4^l))."""
    n, h, w, c = in_specs[0].shape
    p = int(node.attrs.get("pyramid_height", 1))
    total = sum((2 ** l) ** 2 for l in range(p))
    return [TensorSpec((n, c * total), in_specs[0].dtype)]


@register_shape_fn("Tile")
def _tile_shape(node, in_specs, graph):
    """Caffe TileLayer: the tensor repeated ``tiles`` times along the NHWC
    ``axis``."""
    axis = node.attrs.get("axis", -1) % in_specs[0].rank
    shape = list(in_specs[0].shape)
    shape[axis] *= int(node.attrs.get("tiles", 1))
    return [TensorSpec(tuple(shape), in_specs[0].dtype)]


@register_shape_fn("Reduction")
def _reduction_shape(node, in_specs, graph):
    """Caffe ReductionLayer: every dim from ``axis`` (Caffe's NCHW terms)
    reduced away; f32."""
    axis = int(node.attrs.get("axis", 0))
    shape = in_specs[0].shape
    if len(shape) == 4:
        n, h, w, c = shape
        shape = (n, c, h, w)
    if not 0 <= axis < len(shape):
        raise ValueError(f"{node.name}: Reduction axis {axis} out of "
                         f"range for rank {len(shape)}")
    return [TensorSpec(tuple(shape[:axis]), "float32")]


@register_shape_fn("ArgMax")
def _argmax_shape(node, in_specs, graph):
    """Caffe ArgMaxLayer: with ``axis`` that dim becomes top_k; without,
    (N, 1, top_k) indices or (N, 2, top_k) [indices; values].  f32."""
    k = int(node.attrs.get("top_k", 1))
    spec = in_specs[0]
    if node.attrs.get("axis") is not None:
        shape = list(spec.shape)
        shape[node.attrs["axis"] % spec.rank] = k
        return [TensorSpec(tuple(shape), "float32")]
    rows = 2 if node.attrs.get("out_max_val") else 1
    return [TensorSpec((spec.shape[0], rows, k), "float32")]


@register_shape_fn("Pooling")
def _pool_shape(node, in_specs, graph):
    (n, h, w, c) = in_specs[0].shape
    if node.attrs.get("global_pooling", False):
        return [TensorSpec((n, 1, 1, c), in_specs[0].dtype)]
    kh, kw, sh, sw, ph, pw, _ = _conv_attrs(node)
    ceil = node.attrs.get("ceil_mode", True)  # Caffe pooling default
    oh = conv_out_dim(h, kh, sh, ph, 1, ceil_mode=ceil)
    ow = conv_out_dim(w, kw, sw, pw, 1, ceil_mode=ceil)
    return [TensorSpec((n, oh, ow, c), in_specs[0].dtype)]


@register_shape_fn("InnerProduct")
def _fc_shape(node, in_specs, graph):
    n = in_specs[0].shape[0]
    return [TensorSpec((n, node.attrs["num_output"]), in_specs[0].dtype)]


def _elementwise_shape(node, in_specs, graph):
    return [in_specs[0]]


for _op in ["ReLU", "ReLU6", "Sigmoid", "BatchNorm", "Scale", "Bias",
            "Dropout", "LRN", "Softmax", "Split", "FusedBottleneck",
            "FusedChain", "PReLU", "TanH", "ELU", "AbsVal", "Exp", "Log",
            "BNLL", "Power", "Threshold", "MVN"]:
    register_shape_fn(_op)(_elementwise_shape)


@register_shape_fn("Axpy")
def _axpy_shape(node, in_specs, graph):
    """SENet-Caffe's Axpy layer: out = a*x + y with bottoms [a (the
    per-channel gate, (N, 1, 1, C) or (N, C)), x, y]."""
    s, x, y = in_specs
    if x.shape != y.shape:
        raise ValueError(f"{node.name}: Axpy x/y shapes differ "
                         f"{x.shape} vs {y.shape}")
    if s.shape[0] != x.shape[0] or s.shape[-1] != x.shape[-1]:
        raise ValueError(f"{node.name}: Axpy scale shape {s.shape} does "
                         f"not broadcast over {x.shape}")
    return [TensorSpec(x.shape, x.dtype)]


@register_shape_fn("ShuffleChannel")
def _shuffle_channel_shape(node, in_specs, graph):
    """ShuffleNet's channel shuffle: a permutation of the channel axis."""
    g = int(node.attrs.get("group", 1))
    c = in_specs[0].shape[-1]
    if c % g:
        raise ValueError(
            f"{node.name}: channels {c} not divisible by group {g}")
    return [in_specs[0]]


@register_shape_fn("Eltwise")
def _eltwise_shape(node, in_specs, graph):
    base = in_specs[0]
    for s in in_specs[1:]:
        if s.shape != base.shape:
            raise ValueError(
                f"{node.name}: Eltwise shape mismatch {s.shape} vs {base.shape}"
            )
    return [base]


@register_shape_fn("Concat")
def _concat_shape(node, in_specs, graph):
    axis = node.attrs.get("axis", -1)  # NHWC channel axis
    axis = axis % in_specs[0].rank
    dim = sum(s.shape[axis] for s in in_specs)
    shape = list(in_specs[0].shape)
    shape[axis] = dim
    return [TensorSpec(tuple(shape), in_specs[0].dtype)]


@register_shape_fn("LadderInit")
def _ladder_init_shape(node, in_specs, graph):
    """Concat-ladder buffer (passes_ladder.py): base+parts zero-padded
    to the chain's final channel count."""
    shape = list(in_specs[0].shape)
    shape[-1] = node.attrs["total"]
    return [TensorSpec(tuple(shape), in_specs[0].dtype)]


@register_shape_fn("LadderAppend")
def _ladder_append_shape(node, in_specs, graph):
    return [TensorSpec(in_specs[0].shape, in_specs[0].dtype)]


@register_shape_fn("LadderView")
def _ladder_view_shape(node, in_specs, graph):
    shape = list(in_specs[0].shape)
    shape[-1] = node.attrs["channels"]
    return [TensorSpec(tuple(shape), in_specs[0].dtype)]


@register_shape_fn("SpaceToDepth")
def _s2d_shape(node, in_specs, graph):
    """The space-to-depth stem's input rewrite (passes_stem.py); here, not
    in the pass's module, so a graph saved after the pass infers its
    shapes on load."""
    n, h, w, c = in_specs[0].shape
    blk = node.attrs.get("block", 2)
    pad = node.attrs.get("pad", 0)
    hp, wp = h + 2 * pad, w + 2 * pad
    return [TensorSpec((n, hp // blk, wp // blk, c * blk * blk),
                       in_specs[0].dtype)]


@register_shape_fn("Slice")
def _slice_shape(node, in_specs, graph):
    axis = node.attrs.get("axis", -1) % in_specs[0].rank
    points = list(node.attrs.get("slice_points", []))
    total = in_specs[0].shape[axis]
    if not points:
        k = len(node.outputs)
        if total % k:
            raise ValueError(f"{node.name}: cannot evenly slice {total} into {k}")
        points = [total // k * i for i in range(1, k)]
    bounds = [0] + points + [total]
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        shape = list(in_specs[0].shape)
        shape[axis] = hi - lo
        out.append(TensorSpec(tuple(shape), in_specs[0].dtype))
    return out


@register_shape_fn("Flatten")
def _flatten_shape(node, in_specs, graph):
    n = in_specs[0].shape[0]
    return [TensorSpec((n, in_specs[0].size // n), in_specs[0].dtype)]


@register_shape_fn("Reshape")
def _reshape_shape(node, in_specs, graph):
    shape = list(node.attrs["shape"])
    # Caffe ReshapeLayer: dim 0 copies the input dim at the same index
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = in_specs[0].shape[i]
    size = in_specs[0].size
    if -1 in shape:
        idx = shape.index(-1)
        known = int(np.prod([d for d in shape if d != -1])) or 1
        shape[idx] = size // known
    return [TensorSpec(tuple(shape), in_specs[0].dtype)]
