"""Caffe -> .ftpu converter — the port's counterpart of
``tools/convert_caffe.py`` (the feather_convert_caffe analog), on the
port's own ``ir.py``, ``model_format.py``, wire codec and text parser, so
that a model converts on a machine without JAX:

    python -m feathercnn_tpu_torch.tools.convert_caffe deploy.prototxt \
        model.caffemodel out.ftpu [--batch N]

Every layer mapping is the reference's, so both converters give the same
graph, node for node and bit for bit: parse the deploy (text protobuf)
for the structure and the ``.caffemodel`` (binary protobuf, new-style
``layer`` or V1 ``layers``) for the weights, match layers by name, and
move each to the engine's NHWC layout once, offline:

  - conv weights  (O, I/g, KH, KW)  ->  (KH, KW, I/g, O)
  - FC weights    (O, C*H*W)        ->  (H*W*C, O)   (NHWC flattening)
  - BatchNorm     mean,var,scale_factor -> mean/sf, var/sf

As in the reference, a conv's ``stride_h``/``stride_w`` pair is kept as
one square stride (``stride_h``'s): ``_conv_attrs`` mirrors it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from ..ir import Graph, Node, TensorSpec, infer_shapes
from ..model_format import save_ftpu
from .caffe_pb import parse_net
from .prototxt import parse_prototxt

# Caffe layer types we drop silently at inference time.
_SKIP_TYPES = {"Data", "ImageData", "HDF5Data", "Accuracy", "SoftmaxWithLoss",
               "Silence", "Python"}
_ELTWISE_OPS = {0: "PROD", 1: "SUM", 2: "MAX",
                "PROD": "PROD", "SUM": "SUM", "MAX": "MAX"}
_POOL_MODES = {0: "MAX", 1: "AVE", 2: "STOCHASTIC",
               "MAX": "MAX", "AVE": "AVE", "STOCHASTIC": "STOCHASTIC"}


def _as_list(v) -> List:
    if v is None:
        return []
    if isinstance(v, np.ndarray):   # packed fields off the binary wire
        return v.tolist()
    return v if isinstance(v, list) else [v]


def _first(v, default=None):
    lst = _as_list(v)
    return lst[0] if lst else default


def _i32(v) -> int:
    """Negative int32 arrives as a 64-bit two's-complement varint from the
    binary wire (the text parser yields it signed already)."""
    v = int(v)
    return v - 2 ** 64 if v >= 2 ** 63 else v


def _blob_array(blob: Dict[str, Any]) -> np.ndarray:
    data = np.asarray(blob.get("data", []), np.float32)
    if "shape" in blob and blob["shape"].get("dim"):
        shape = [int(d) for d in blob["shape"]["dim"]]
    else:
        shape = [int(blob.get(k, 1)) for k in ("num", "channels",
                                               "height", "width")]
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    return data.reshape(shape)


def _conv_attrs(p: Dict[str, Any]) -> Dict[str, Any]:
    ks = _first(p.get("kernel_size"))
    attrs = {
        "num_output": int(p["num_output"]),
        "kernel_h": int(p.get("kernel_h", ks or 1)),
        "kernel_w": int(p.get("kernel_w", ks or 1)),
        "stride_h": int(p.get("stride_h", _first(p.get("stride"), 1))),
        "stride_w": int(p.get("stride_w", _first(p.get("stride"), 1))),
        "pad_h": int(p.get("pad_h", _first(p.get("pad"), 0))),
        "pad_w": int(p.get("pad_w", _first(p.get("pad"), 0))),
        "group": int(p.get("group", 1)),
        "dilation": int(_first(p.get("dilation"), 1)),
        "bias_term": bool(p.get("bias_term", True)),
    }
    # normalize square attrs for readability
    attrs["stride"] = attrs.pop("stride_h") if (
        attrs["stride_h"] == attrs["stride_w"]) else attrs["stride_h"]
    if "stride" in attrs:
        attrs["stride_w"] = attrs["stride"]
        attrs["stride_h"] = attrs["stride"]
    return attrs


class Converter:
    def __init__(self, deploy: Dict[str, Any],
                 weights: Optional[Dict[str, Any]] = None,
                 batch: Optional[int] = None):
        self.deploy = deploy
        self.wmap: Dict[str, List[np.ndarray]] = {}
        if weights:
            for layer in weights.get("layer", []):
                blobs = [_blob_array(b) for b in layer.get("blobs", [])]
                if blobs:
                    self.wmap[layer["name"]] = blobs
        self.batch = batch
        self.graph: Optional[Graph] = None
        self._fc_pending: List[str] = []
        # Caffe allows in-place layers (top == bottom); our IR is SSA.
        # _current maps each Caffe blob name to its latest SSA name.
        self._current: Dict[str, str] = {}
        self._ssa_counter = 0
        # Caffe-rank of each SSA blob: Caffe canonicalizes negative
        # axes against the actual bottom rank, not a fixed 4 (e.g. Tile
        # axis=-1 after an InnerProduct means axis 1 of a rank-2 blob).
        self._rank: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def convert(self) -> Graph:
        d = self.deploy
        name = d.get("name", "caffe_net")
        g = Graph(name=name, inputs={}, outputs=[], nodes=[])
        self.graph = g

        # Inputs: `input:`+`input_dim`/`input_shape`, or Input layers.
        inputs = _as_list(d.get("input"))
        if inputs:
            dims = [int(x) for x in _as_list(d.get("input_dim"))]
            shapes = _as_list(d.get("input_shape"))
            for i, iname in enumerate(inputs):
                if dims:
                    nchw = dims[4 * i: 4 * i + 4]
                else:
                    nchw = [int(x) for x in _as_list(shapes[i]["dim"])]
                g.inputs[iname] = TensorSpec(self._nchw_to_nhwc(nchw))
                self._rank[iname] = len(nchw)

        produced = set(g.inputs)
        for layer in _as_list(d.get("layer") or d.get("layers")):
            self._convert_layer(layer, produced)

        # Outputs: values never consumed.
        consumed = {i for n in g.nodes for i in n.inputs}
        g.outputs = [o for n in g.nodes for o in n.outputs
                     if o not in consumed]
        if not g.outputs and g.nodes:
            g.outputs = list(g.nodes[-1].outputs)

        infer_shapes(g)
        self._fixup_fc_weights()
        infer_shapes(g)
        g.validate()
        return g

    def _nchw_to_nhwc(self, nchw: List[int]):
        if len(nchw) == 4:
            n, c, h, w = nchw
            if self.batch:
                n = self.batch
            return (n, h, w, c)
        if self.batch and nchw:
            nchw = [self.batch] + list(nchw[1:])
        return tuple(nchw)

    # ------------------------------------------------------------------
    def _convert_layer(self, layer: Dict[str, Any], produced: set) -> None:
        g = self.graph
        ltype = layer.get("type")
        lname = layer.get("name", f"layer{len(g.nodes)}")
        if ltype in _SKIP_TYPES:
            return
        bottoms = [self._current.get(b, b)
                   for b in _as_list(layer.get("bottom"))]
        raw_tops = _as_list(layer.get("top")) or [lname]
        blobs = self.wmap.get(lname) or [
            _blob_array(b) for b in layer.get("blobs", [])]

        tops = []
        for t in raw_tops:
            if self._current.get(t, t) in produced or t in produced:
                self._ssa_counter += 1
                new = f"{t}#{self._ssa_counter}"
            else:
                new = t
            self._current[t] = new
            tops.append(new)

        attrs: Dict[str, Any] = {}
        params: List[str] = []

        def add_param(suffix, arr):
            pname = f"{lname}/{suffix}"
            g.params[pname] = np.asarray(arr, np.float32)
            params.append(pname)

        if ltype == "Input":
            p = layer.get("input_param", {})
            for i, t in enumerate(tops):
                shp = _as_list(p.get("shape"))
                nchw = [int(x) for x in _as_list(shp[i]["dim"])] if shp else []
                g.inputs[t] = TensorSpec(self._nchw_to_nhwc(nchw))
                self._rank[t] = len(nchw)
                produced.add(t)
            return

        # rank of the first bottom, for negative-axis canonicalization
        brank = self._rank.get(bottoms[0], 4) if bottoms else 4

        if ltype == "Convolution":
            p = layer.get("convolution_param", {})
            attrs = _conv_attrs(p)
            if blobs:
                w = blobs[0]  # (O, I/g, KH, KW)
                if w.ndim == 4:
                    w = np.transpose(w, (2, 3, 1, 0))  # -> (KH,KW,I/g,O)
                add_param("w", w)
                if attrs["bias_term"] and len(blobs) > 1:
                    add_param("b", blobs[1].reshape(-1))
            op = "Convolution"
        elif ltype == "Deconvolution":
            # Caffe stores deconv weights (Cin, Cout/g, KH, KW); our IR
            # wants HWIO (KH, KW, Cin/g, Cout) with lax's grouped-output
            # convention (ops/lowering._lower_deconv)
            p = layer.get("convolution_param", {})
            attrs = _conv_attrs(p)
            if blobs:
                w = blobs[0]
                grp = attrs.get("group", 1)
                ci, cog, kh, kw = w.shape
                w = w.reshape(grp, ci // grp, cog, kh, kw)
                w = np.transpose(w, (3, 4, 1, 0, 2))
                add_param("w", np.ascontiguousarray(
                    w.reshape(kh, kw, ci // grp, grp * cog)))
                if attrs["bias_term"] and len(blobs) > 1:
                    add_param("b", blobs[1].reshape(-1))
            op = "Deconvolution"
        elif ltype == "Crop":
            p = layer.get("crop_param", {})
            ax = int(p.get("axis", 2))
            if ax >= 2 ** 63:     # negative int32 on the proto2 wire
                ax -= 2 ** 64
            if ax < 0:            # Caffe canonical-axis semantics
                ax += 4
            ax = min(max(ax, 0), 3)
            # Caffe crops every NCHW dim >= axis; translate the dim SET
            # to NHWC indices (N,C,H,W -> 0,3,1,2), offsets stay aligned
            nchw_to_nhwc = {0: 0, 1: 3, 2: 1, 3: 2}
            dims = list(range(ax, 4))
            offs = [int(o) for o in _as_list(p.get("offset", [0]))]
            attrs = {"axes": [nchw_to_nhwc[d] for d in dims],
                     "offsets": [offs[i] if i < len(offs) else offs[-1]
                                 for i in range(len(dims))]}
            op = "Crop"
        elif ltype == "Interp":
            # DeepLab fork's InterpLayer (interp_layer.cpp): align-corners
            # bilinear resize; exactly one of {height+width, zoom_factor,
            # shrink_factor, both factors} is set; pad_beg/pad_end <= 0
            # crop before the resize.
            p = layer.get("interp_param", {})
            attrs = {}
            for k in ("height", "width", "zoom_factor", "shrink_factor",
                      "pad_beg", "pad_end"):
                if p.get(k) is None:
                    continue
                v = int(p[k])
                if v >= 2 ** 63:      # negative int32 on the proto2 wire
                    v -= 2 ** 64
                attrs[k] = v
            op = "Interp"
        elif ltype == "InnerProduct":
            p = layer.get("inner_product_param", {})
            attrs = {"num_output": int(p["num_output"]),
                     "bias_term": bool(p.get("bias_term", True))}
            if blobs:
                w = blobs[0]  # (O, I) caffe; transpose=false default
                if bool(p.get("transpose", False)):
                    w = w.T  # stored (I, O) when transpose: true
                add_param("w", np.ascontiguousarray(w.T))  # -> (I, O)
                self._fc_pending.append(lname)
                if attrs["bias_term"] and len(blobs) > 1:
                    add_param("b", blobs[1].reshape(-1))
            op = "InnerProduct"
        elif ltype == "Pooling":
            p = layer.get("pooling_param", {})
            attrs = {"pool": _POOL_MODES.get(p.get("pool", 0), "MAX"),
                     "global_pooling": bool(p.get("global_pooling", False))}
            if not attrs["global_pooling"]:
                # kernel_size/stride/pad are `repeated` in caffe.proto —
                # the text parser yields lists (e.g. pool1's
                # `kernel_size: 3` arrives as [3]); _first unwraps
                ks = _first(p.get("kernel_size"), 0)
                attrs.update(
                    kernel_h=int(p.get("kernel_h", ks)),
                    kernel_w=int(p.get("kernel_w", ks)),
                    stride_h=int(p.get("stride_h",
                                       _first(p.get("stride"), 1))),
                    stride_w=int(p.get("stride_w",
                                       _first(p.get("stride"), 1))),
                    pad_h=int(p.get("pad_h", _first(p.get("pad"), 0))),
                    pad_w=int(p.get("pad_w", _first(p.get("pad"), 0))),
                    ceil_mode=(int(p.get("round_mode", 0)) == 0),
                )
            op = "Pooling"
        elif ltype == "ReLU":
            p = layer.get("relu_param", {})
            if p.get("negative_slope"):
                attrs["negative_slope"] = float(p["negative_slope"])
            op = "ReLU"
        elif ltype == "PReLU":
            p = layer.get("prelu_param", {})
            attrs["channel_shared"] = bool(p.get("channel_shared", False))
            if blobs:
                add_param("slope", blobs[0].reshape(-1))
            op = "PReLU"
        elif ltype == "BatchNorm":
            p = layer.get("batch_norm_param", {})
            attrs["eps"] = float(p.get("eps", 1e-5))
            if blobs:
                mean, var = blobs[0].reshape(-1), blobs[1].reshape(-1)
                sf = float(blobs[2].reshape(-1)[0]) if len(blobs) > 2 else 1.0
                sf = 1.0 / sf if sf != 0 else 0.0
                add_param("mean", mean * sf)
                add_param("var", var * sf)
            op = "BatchNorm"
        elif ltype == "Scale":
            p = layer.get("scale_param", {})
            attrs["bias_term"] = bool(p.get("bias_term", False))
            if len(bottoms) > 1:
                # two-bottom form: the scaler comes from bottom[1];
                # the only learned blob (if bias_term) is the BIAS
                if attrs["bias_term"] and blobs:
                    add_param("beta", blobs[0].reshape(-1))
            elif blobs:
                add_param("gamma", blobs[0].reshape(-1))
                if attrs["bias_term"] and len(blobs) > 1:
                    add_param("beta", blobs[1].reshape(-1))
            op = "Scale"
        elif ltype == "Eltwise":
            p = layer.get("eltwise_param", {})
            attrs["operation"] = _ELTWISE_OPS.get(p.get("operation", 1),
                                                  "SUM")
            if p.get("coeff") is not None:
                attrs["coeffs"] = [float(c) for c in np.asarray(p["coeff"])
                                   .reshape(-1)]
            op = "Eltwise"
        elif ltype == "Concat":
            p = layer.get("concat_param", {})
            axis = int(p.get("axis", p.get("concat_dim", 1)))
            attrs["axis"] = {0: 0, 1: -1, 2: 1, 3: 2}.get(axis, -1)
            op = "Concat"
        elif ltype == "Slice":
            p = layer.get("slice_param", {})
            axis = int(p.get("axis", p.get("slice_dim", 1)))
            attrs["axis"] = {0: 0, 1: -1, 2: 1, 3: 2}.get(axis, -1)
            pts = p.get("slice_point")
            if pts:
                attrs["slice_points"] = [int(x) for x in pts]
            op = "Slice"
        elif ltype == "LRN":
            p = layer.get("lrn_param", {})
            attrs = {"local_size": int(p.get("local_size", 5)),
                     "alpha": float(p.get("alpha", 1.0)),
                     "beta": float(p.get("beta", 0.75)),
                     "k": float(p.get("k", 1.0))}
            op = "LRN"
        elif ltype == "Permute":
            p = layer.get("permute_param", {})
            order = [int(o) for o in _as_list(p.get("order"))]
            order += list(range(len(order), 4))
            attrs["order"] = tuple(order)
            op = "Permute"
        elif ltype == "Normalize":
            p = layer.get("norm_param", {})
            attrs = {"across_spatial": bool(p.get("across_spatial", True)),
                     "channel_shared": bool(p.get("channel_shared", True))}
            if blobs:
                add_param("scale", blobs[0].reshape(-1))
            op = "Normalize"
        elif ltype == "PriorBox":
            p = layer.get("prior_box_param", {})
            attrs = {
                "min_sizes": [float(s) for s in _as_list(p.get("min_size"))],
                "max_sizes": [float(s) for s in _as_list(p.get("max_size"))],
                "aspect_ratios": [float(r)
                                  for r in _as_list(p.get("aspect_ratio"))],
                "flip": bool(p.get("flip", True)),
                "clip": bool(p.get("clip", False)),
                "variances": [float(v) for v in _as_list(p.get("variance"))]
                or [0.1],
                "offset": float(p.get("offset", 0.5)),
            }
            if p.get("step") is not None:
                attrs["step"] = float(p["step"])
            op = "PriorBox"
        elif ltype == "DetectionOutput":
            p = layer.get("detection_output_param", {})
            code = p.get("code_type", "CENTER_SIZE")
            if code not in ("CENTER_SIZE", 2):
                raise NotImplementedError(
                    f"layer {lname!r}: DetectionOutput code_type {code!r} "
                    "(only CENTER_SIZE — the SSD deploys' setting)")
            nms = p.get("nms_param", {})
            attrs = {
                "num_classes": int(p["num_classes"]),
                "share_location": bool(p.get("share_location", True)),
                "background_label_id":
                    int(p.get("background_label_id", 0)),
                "nms_threshold": float(nms.get("nms_threshold", 0.3)),
                "nms_top_k": int(nms.get("top_k", 400)),
                # proto default -1 = unbounded; static shapes need a cap
                "keep_top_k": _i32(p["keep_top_k"])
                if _i32(p.get("keep_top_k", -1)) > 0
                else int(nms.get("top_k", 400)),
                "confidence_threshold":
                    float(p.get("confidence_threshold", 0.01)),
            }
            op = "DetectionOutput"
        elif ltype == "ArgMax":
            p = layer.get("argmax_param", {})
            attrs = {"top_k": int(p.get("top_k", 1)),
                     "out_max_val": bool(p.get("out_max_val", False))}
            if p.get("axis") is not None:
                ax = int(p["axis"])
                if ax >= 2 ** 63:  # negative int32 on the proto2 wire
                    ax -= 2 ** 64
                if ax < 0:
                    ax += brank
                attrs["axis"] = ({0: 0, 1: -1, 2: 1, 3: 2}.get(ax, -1)
                                 if brank == 4 else ax)
            op = "ArgMax"
        elif ltype == "Dropout":
            op = "Dropout"
        elif ltype == "Softmax":
            p = layer.get("softmax_param", {})
            axis = int(p.get("axis", 1))
            attrs["axis"] = {1: -1}.get(axis, -1)
            op = "Softmax"
        elif ltype == "Flatten":
            op = "Flatten"
        elif ltype == "Reshape":
            p = layer.get("reshape_param", {})
            dims = [_i32(x) for x in _as_list(p.get("shape", {}).get("dim"))]
            # NCHW reshape spec -> NHWC equivalent (rank-4 only)
            attrs["shape"] = self._nchw_to_nhwc(dims) if len(dims) == 4 \
                else dims
            op = "Reshape"
        elif ltype == "Power":
            p = layer.get("power_param", {})
            attrs = {"power": float(p.get("power", 1.0)),
                     "scale": float(p.get("scale", 1.0)),
                     "shift": float(p.get("shift", 0.0))}
            op = "Power"
        elif ltype == "Proposal":
            # the Faster R-CNN forks' C++ proposal layer; the reference
            # python layer's params arrive via proposal_param in those
            # forks.  NOTE: deploys that express the RPN softmax as
            # NCHW Reshape(0,2,-1,0) cannot be converted mechanically
            # (NHWC storage changes the reshape's channel pairing) —
            # build the graph via models/zoo.py:faster_rcnn_vgg16
            # instead and load converted weights into it.
            p = layer.get("proposal_param", {})
            attrs = {"feat_stride": int(p.get("feat_stride", 16)),
                     "pre_nms_top_n": int(p.get("pre_nms_topn", 6000)),
                     "post_nms_top_n": int(p.get("post_nms_topn", 300)),
                     "nms_thresh": float(p.get("nms_thresh", 0.7)),
                     "min_size": int(p.get("min_size", 16))}
            if p.get("scale") is not None:
                attrs["scales"] = [float(s) for s in _as_list(p["scale"])]
            if p.get("ratio") is not None:
                attrs["ratios"] = [float(r) for r in _as_list(p["ratio"])]
            op = "Proposal"
        elif ltype == "PSROIPooling":
            p = layer.get("psroi_pooling_param", {})
            attrs = {"output_dim": int(p["output_dim"]),
                     "group_size": int(p["group_size"]),
                     "spatial_scale": float(p.get("spatial_scale",
                                                  1.0 / 16))}
            op = "PSROIPooling"
        elif ltype == "ROIPooling":
            p = layer.get("roi_pooling_param", {})
            attrs = {"pooled_h": int(p.get("pooled_h", 7)),
                     "pooled_w": int(p.get("pooled_w", 7)),
                     "spatial_scale": float(p.get("spatial_scale",
                                                  1.0 / 16))}
            op = "ROIPooling"
        elif ltype == "SPP":
            p = layer.get("spp_param", {})
            attrs = {"pyramid_height": int(p.get("pyramid_height", 1)),
                     "pool": _POOL_MODES.get(p.get("pool", 0), "MAX")}
            op = "SPP"
        elif ltype == "MVN":
            p = layer.get("mvn_param", {})
            attrs = {"normalize_variance":
                     bool(p.get("normalize_variance", True)),
                     "across_channels": bool(p.get("across_channels",
                                                   False)),
                     "eps": float(p.get("eps", 1e-9))}
            op = "MVN"
        elif ltype == "Tile":
            p = layer.get("tile_param", {})
            axis = _i32(p.get("axis", 1))
            if axis < 0:       # Caffe canonicalizes vs the bottom rank
                axis += brank
            # NCHW->NHWC axis remap applies to 4D bottoms only; lower
            # ranks pass through untransposed (a rank-2 IP output keeps
            # its (N, C) layout here)
            attrs = {"axis": ({0: 0, 1: -1, 2: 1, 3: 2}.get(axis, -1)
                              if brank == 4 else axis),
                     "tiles": int(p.get("tiles", 1))}
            op = "Tile"
        elif ltype == "Reduction":
            p = layer.get("reduction_param", {})
            ops_ = {1: "SUM", 2: "ASUM", 3: "SUMSQ", 4: "MEAN",
                    "SUM": "SUM", "ASUM": "ASUM", "SUMSQ": "SUMSQ",
                    "MEAN": "MEAN"}
            ax = _i32(p.get("axis", 0))
            attrs = {"operation": ops_.get(p.get("operation", 1), "SUM"),
                     "axis": ax + brank if ax < 0 else ax,
                     "coeff": float(p.get("coeff", 1.0))}
            op = "Reduction"
        elif ltype == "Axpy":
            # SENet-Caffe's custom layer: bottoms [gate, x, y] -> a*x+y
            op = "Axpy"
        elif ltype == "ShuffleChannel":
            p = layer.get("shuffle_channel_param", {})
            attrs["group"] = int(p.get("group", 1))
            op = "ShuffleChannel"
        elif ltype == "Threshold":
            p = layer.get("threshold_param", {})
            attrs["threshold"] = float(p.get("threshold", 0.0))
            op = "Threshold"
        elif ltype in ("Sigmoid", "TanH", "AbsVal", "BNLL", "Exp", "Log",
                       "ELU", "Split"):
            op = ltype
        else:
            raise NotImplementedError(
                f"layer {lname!r}: unsupported Caffe type {ltype!r}")

        g.nodes.append(Node(name=lname, op=op, inputs=bottoms, outputs=tops,
                            attrs=attrs, params=params))
        produced.update(tops)
        # Track Caffe-rank for downstream negative-axis canonicalization.
        # Most layers preserve their bottom's rank; the exceptions below
        # collapse (or fix) it.
        out_rank = brank
        if op in ("InnerProduct", "Flatten", "SPP"):
            out_rank = 2
        elif op == "Reshape":
            out_rank = len(attrs.get("shape", ())) or brank
        elif op in ("ROIPooling", "PSROIPooling"):
            out_rank = 4
        elif op == "Proposal":
            out_rank = 2
        elif op == "Reduction":
            out_rank = max(int(attrs.get("axis", 0)), 1)
        for t in tops:
            self._rank[t] = out_rank

    # ------------------------------------------------------------------
    def _fixup_fc_weights(self) -> None:
        """Permute FC weight rows from NCHW-flat to NHWC-flat order when
        the FC input is a rank-4 feature map."""
        g = self.graph
        for n in g.nodes:
            if n.op != "InnerProduct" or n.name not in self._fc_pending:
                continue
            spec = g.specs.get(n.inputs[0])
            if spec is None or spec.rank != 4:
                continue
            _, h, w, c = spec.shape
            if h == w == 1:
                continue  # flat already; order irrelevant
            wname = n.params[0]
            wmat = g.params[wname]  # (I=C*H*W caffe order, O)
            o = wmat.shape[1]
            wmat = wmat.reshape(c, h, w, o)          # caffe I index (c,h,w)
            wmat = np.transpose(wmat, (1, 2, 0, 3))  # -> (h,w,c,o)
            g.params[wname] = np.ascontiguousarray(
                wmat.reshape(h * w * c, o))


def convert(prototxt_path: str, caffemodel_path: Optional[str] = None,
            batch: Optional[int] = None) -> Graph:
    """The graph of a deploy file and, where given, a ``.caffemodel``'s
    weights (``batch`` replacing the deploy's batch)."""
    with open(prototxt_path) as f:
        deploy = parse_prototxt(f.read())
    weights = None
    if caffemodel_path:
        with open(caffemodel_path, "rb") as f:
            weights = parse_net(f.read())
    return Converter(deploy, weights, batch=batch).convert()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a Caffe model to .ftpu")
    ap.add_argument("prototxt")
    ap.add_argument("caffemodel", nargs="?")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the batch dimension")
    args = ap.parse_args(argv)
    g = convert(args.prototxt, args.caffemodel, batch=args.batch)
    out = args.output or os.path.splitext(args.prototxt)[0] + ".ftpu"
    save_ftpu(g, out)
    n_params = sum(int(np.prod(p.shape)) for p in g.params.values())
    print(f"wrote {out}: {len(g.nodes)} layers, {n_params/1e6:.2f}M params")
    return 0


if __name__ == "__main__":
    sys.exit(main())
