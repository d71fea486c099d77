"""GraphBuilder — a copy of ``feathercnn_tpu/models/builder.py`` with the
layer methods of the ops the port lowers.  Same seeded draws in the same
order, so a model built here has the reference zoo's weights.


The model zoo (the classification models of ``feathercnn_tpu/models/
zoo.py``) is defined with this builder using the exact layer sequences of
the public Caffe deploy prototxts that FeatherCNN's converter consumes
([pub] tools/feather_convert_caffe.cpp).  Weights are He-initialized unless
loaded from a converted model — so every model runs (and is benchmarked)
without needing the original .caffemodel files, while the converter drops
real weights into the identical graph structure.

Builders emit *unfused* graphs (separate BatchNorm/Scale/ReLU nodes, as a
Caffe prototxt would) so the optimization passes are exercised on real
structure.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ir import Graph, Node, TensorSpec, infer_shapes


class GraphBuilder:
    def __init__(self, name: str, seed: int = 0, init_weights: bool = True):
        self.graph = Graph(name=name, inputs={}, outputs=[], nodes=[])
        self.rng = np.random.default_rng(seed)
        self.init_weights = init_weights
        self._counter = 0
        # track channel count of every value for weight sizing
        self._channels = {}

    # ------------------------------------------------------------------
    def _param(self, name: str, shape: Tuple[int, ...], kind: str) -> str:
        if self.init_weights:
            if kind == "weight":
                fan_in = int(np.prod(shape[:-1])) or 1
                arr = self.rng.normal(
                    0.0, np.sqrt(2.0 / fan_in), size=shape).astype(np.float32)
            elif kind == "zeros":
                arr = np.zeros(shape, np.float32)
            elif kind == "ones":
                arr = np.ones(shape, np.float32)
            elif kind == "mean":
                arr = self.rng.normal(0, 0.1, size=shape).astype(np.float32)
            elif kind == "var":
                arr = np.abs(self.rng.normal(
                    1.0, 0.1, size=shape)).astype(np.float32)
            else:
                raise ValueError(kind)
        else:
            arr = np.zeros(shape, np.float32)
        self.graph.params[name] = arr
        return name

    def _add(self, node: Node) -> List[str]:
        self.graph.nodes.append(node)
        return node.outputs

    # ------------------------------------------------------------------
    def input(self, name: str, shape: Sequence[int]) -> str:
        self.graph.inputs[name] = TensorSpec(tuple(shape))
        self._channels[name] = shape[-1]
        return name

    def conv(self, name: str, x: str, num_output: int, kernel: int = 1,
             stride: int = 1, pad: int = 0, group: int = 1, bias: bool = True,
             dilation: int = 1, relu: bool = False,
             kernel_h: Optional[int] = None, kernel_w: Optional[int] = None,
             pad_h: Optional[int] = None, pad_w: Optional[int] = None) -> str:
        cin = self._channels[x]
        kh = kernel_h if kernel_h is not None else kernel
        kw = kernel_w if kernel_w is not None else kernel
        w = self._param(name + "/w", (kh, kw, cin // group, num_output),
                        "weight")
        params = [w]
        if bias:
            params.append(self._param(name + "/b", (num_output,), "zeros"))
        attrs = {"num_output": num_output, "kernel_h": kh, "kernel_w": kw,
                 "stride": stride, "group": group, "bias_term": bias,
                 "dilation": dilation,
                 "pad_h": pad_h if pad_h is not None else pad,
                 "pad_w": pad_w if pad_w is not None else pad}
        out = self._add(Node(name, "Convolution", [x], [name], attrs,
                             params))[0]
        self._channels[out] = num_output
        if relu:
            out = self.relu(name + "/relu", out)
        return out

    def deconv(self, name: str, x: str, num_output: int, kernel: int,
               stride: int = 1, pad: int = 0, group: int = 1,
               bias: bool = True, dilation: int = 1,
               relu: bool = False) -> str:
        """Transposed conv (Caffe Deconvolution); weights HWIO
        (KH, KW, Cin/g, Cout)."""
        cin = self._channels[x]
        w = self._param(name + "/w", (kernel, kernel, cin // group,
                                      num_output), "weight")
        params = [w]
        if bias:
            params.append(self._param(name + "/b", (num_output,), "zeros"))
        attrs = {"num_output": num_output, "kernel_h": kernel,
                 "kernel_w": kernel, "stride": stride, "group": group,
                 "bias_term": bias, "dilation": dilation,
                 "pad_h": pad, "pad_w": pad}
        out = self._add(Node(name, "Deconvolution", [x], [name], attrs,
                             params))[0]
        self._channels[out] = num_output
        if relu:
            out = self.relu(name + "/relu", out)
        return out

    def normalize(self, name: str, x: str,
                  across_spatial: bool = False,
                  channel_shared: bool = False,
                  init_scale: float = 1.0) -> str:
        """SSD NormalizeLayer: channel L2 + learned scale."""
        c = 1 if channel_shared else self._channels[x]
        pname = name + "/scale"
        self.graph.params[pname] = np.full((c,), init_scale, np.float32)
        out = self._add(Node(name, "Normalize", [x], [name],
                             {"across_spatial": across_spatial,
                              "channel_shared": channel_shared},
                             [pname]))[0]
        self._channels[out] = self._channels[x]
        return out

    def priorbox(self, name: str, feat: str, data: str,
                 min_sizes, max_sizes=(), aspect_ratios=(),
                 flip: bool = True, clip: bool = False,
                 variances=(0.1, 0.1, 0.2, 0.2), step: float = 0,
                 offset: float = 0.5) -> str:
        attrs = {"min_sizes": list(min_sizes),
                 "max_sizes": list(max_sizes),
                 "aspect_ratios": list(aspect_ratios), "flip": flip,
                 "clip": clip, "variances": list(variances),
                 "offset": offset}
        if step:
            attrs["step"] = step
        out = self._add(Node(name, "PriorBox", [feat, data], [name],
                             attrs))[0]
        self._channels[out] = 2
        return out

    def permute(self, name: str, x: str, order=(0, 2, 3, 1)) -> str:
        """SSD PermuteLayer; only the NCHW->NHWC head pattern (identity in
        this IR's NHWC storage) is supported — see ir._permute_shape."""
        out = self._add(Node(name, "Permute", [x], [name],
                             {"order": tuple(order)}))[0]
        self._channels[out] = self._channels[x]
        return out

    def reshape(self, name: str, x: str, shape) -> str:
        out = self._add(Node(name, "Reshape", [x], [name],
                             {"shape": list(shape)}))[0]
        self._channels[out] = shape[-1] if shape[-1] > 0 \
            else self._channels.get(x, 0)
        return out

    def detection_output(self, name: str, loc: str, conf: str,
                         priors: str, num_classes: int,
                         nms_threshold: float = 0.45,
                         nms_top_k: int = 400, keep_top_k: int = 200,
                         confidence_threshold: float = 0.01,
                         background_label_id: int = 0) -> str:
        out = self._add(Node(
            name, "DetectionOutput", [loc, conf, priors], [name],
            {"num_classes": num_classes, "share_location": True,
             "background_label_id": background_label_id,
             "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k,
             "confidence_threshold": confidence_threshold}))[0]
        self._channels[out] = 7
        return out

    def argmax(self, name: str, x: str, axis: int = -1, top_k: int = 1,
               out_max_val: bool = False) -> str:
        attrs = {"top_k": top_k, "out_max_val": out_max_val}
        if axis is not None:
            attrs["axis"] = axis
        out = self._add(Node(name, "ArgMax", [x], [name], attrs))[0]
        self._channels[out] = top_k if axis is not None else 1
        return out

    def interp(self, name: str, x: str, **attrs) -> str:
        """Align-corners bilinear resize (DeepLab InterpLayer); attrs from
        {height, width, zoom_factor, shrink_factor, pad_beg, pad_end}."""
        out = self._add(Node(name, "Interp", [x], [name], dict(attrs)))[0]
        self._channels[out] = self._channels[x]
        return out

    def crop(self, name: str, x: str, ref: str,
             axes: Sequence[int] = (1, 2),
             offsets: Sequence[int] = (0,)) -> str:
        out = self._add(Node(name, "Crop", [x, ref], [name],
                             {"axes": list(axes),
                              "offsets": list(offsets)}))[0]
        self._channels[out] = self._channels[x]
        return out

    def dwconv(self, name: str, x: str, kernel: int = 3, stride: int = 1,
               pad: int = 1, bias: bool = True, relu: bool = False) -> str:
        c = self._channels[x]
        return self.conv(name, x, c, kernel, stride, pad, group=c, bias=bias,
                         relu=relu)

    def proposal(self, name: str, scores: str, deltas: str,
                 im_info: str, feat_stride: int = 16,
                 pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
                 nms_thresh: float = 0.7, min_size: int = 16,
                 scales=(8.0, 16.0, 32.0),
                 ratios=(0.5, 1.0, 2.0)) -> str:
        """RPN ProposalLayer (Faster R-CNN forks): anchors + deltas ->
        NMS'd (post_nms_top_n, 5) ROIs."""
        out = self._add(Node(name, "Proposal",
                             [scores, deltas, im_info], [name],
                             {"feat_stride": feat_stride,
                              "pre_nms_top_n": pre_nms_top_n,
                              "post_nms_top_n": post_nms_top_n,
                              "nms_thresh": nms_thresh,
                              "min_size": min_size,
                              "scales": list(scales),
                              "ratios": list(ratios)}))[0]
        self._channels[out] = 5
        return out

    def roi_pooling(self, name: str, x: str, rois: str, pooled_h: int,
                    pooled_w: int,
                    spatial_scale: float = 1.0 / 16) -> str:
        """Fast R-CNN ROIPoolingLayer: (R, pooled_h, pooled_w, C)."""
        out = self._add(Node(name, "ROIPooling", [x, rois], [name],
                             {"pooled_h": pooled_h, "pooled_w": pooled_w,
                              "spatial_scale": spatial_scale}))[0]
        self._channels[out] = self._channels[x]
        return out

    def psroi_pooling(self, name: str, x: str, rois: str,
                      output_dim: int, group_size: int,
                      spatial_scale: float = 1.0 / 16) -> str:
        """R-FCN position-sensitive ROI pooling."""
        out = self._add(Node(name, "PSROIPooling", [x, rois], [name],
                             {"output_dim": output_dim,
                              "group_size": group_size,
                              "spatial_scale": spatial_scale}))[0]
        self._channels[out] = output_dim
        return out

    def spp(self, name: str, x: str, pyramid_height: int,
            mode: str = "MAX") -> str:
        """Caffe SPPLayer: fixed-length pyramid pooling head."""
        out = self._add(Node(name, "SPP", [x], [name],
                             {"pyramid_height": pyramid_height,
                              "pool": mode}))[0]
        total = sum((2 ** lvl) ** 2 for lvl in range(pyramid_height))
        self._channels[out] = self._channels[x] * total
        return out

    def fc(self, name: str, x: str, num_output: int, bias: bool = True,
           relu: bool = False) -> str:
        cin = self._channels[x]
        spec = self.graph.inputs.get(x)
        # weight rows = flattened input features; builder models always
        # apply FC after a known-channel value; spatial dims resolved by
        # infer_shapes — we size from the current spec when needed.
        infer_shapes(self.graph)
        in_features = self.graph.specs[x].size // self.graph.specs[x].shape[0]
        w = self._param(name + "/w", (in_features, num_output), "weight")
        params = [w]
        if bias:
            params.append(self._param(name + "/b", (num_output,), "zeros"))
        attrs = {"num_output": num_output, "bias_term": bias}
        out = self._add(Node(name, "InnerProduct", [x], [name], attrs,
                             params))[0]
        self._channels[out] = num_output
        if relu:
            out = self.relu(name + "/relu", out)
        return out

    def pool(self, name: str, x: str, kernel: int, stride: int = 1,
             pad: int = 0, mode: str = "MAX",
             global_pooling: bool = False) -> str:
        attrs = {"pool": mode, "global_pooling": global_pooling}
        if not global_pooling:
            attrs.update(kernel_size=kernel, stride=stride, pad=pad)
        out = self._add(Node(name, "Pooling", [x], [name], attrs))[0]
        self._channels[out] = self._channels[x]
        return out

    def relu(self, name: str, x: str, negative_slope: float = 0.0) -> str:
        attrs = {"negative_slope": negative_slope} if negative_slope else {}
        out = self._add(Node(name, "ReLU", [x], [name], attrs))[0]
        self._channels[out] = self._channels[x]
        return out

    def relu6(self, name: str, x: str) -> str:
        """ReLU6 (MobileNet-v2's clipped activation)."""
        out = self._add(Node(name, "ReLU6", [x], [name]))[0]
        self._channels[out] = self._channels[x]
        return out

    def batchnorm(self, name: str, x: str, eps: float = 1e-5) -> str:
        c = self._channels[x]
        params = [self._param(name + "/mean", (c,), "mean"),
                  self._param(name + "/var", (c,), "var")]
        out = self._add(Node(name, "BatchNorm", [x], [name], {"eps": eps},
                             params))[0]
        self._channels[out] = c
        return out

    def scale(self, name: str, x: str, bias: bool = True) -> str:
        c = self._channels[x]
        params = [self._param(name + "/gamma", (c,), "var")]
        if bias:
            params.append(self._param(name + "/beta", (c,), "mean"))
        out = self._add(Node(name, "Scale", [x], [name],
                             {"bias_term": bias}, params))[0]
        self._channels[out] = c
        return out

    def bn_scale(self, name: str, x: str) -> str:
        """Caffe's BatchNorm+Scale pair (BN has no learned affine)."""
        x = self.batchnorm(name + "/bn", x)
        return self.scale(name + "/scale", x)

    def eltwise(self, name: str, xs: Sequence[str],
                operation: str = "SUM") -> str:
        out = self._add(Node(name, "Eltwise", list(xs), [name],
                             {"operation": operation}))[0]
        self._channels[out] = self._channels[xs[0]]
        return out

    def concat(self, name: str, xs: Sequence[str], axis: int = -1) -> str:
        out = self._add(Node(name, "Concat", list(xs), [name],
                             {"axis": axis}))[0]
        self._channels[out] = sum(self._channels[x] for x in xs)
        return out

    def dropout(self, name: str, x: str, ratio: float = 0.5) -> str:
        out = self._add(Node(name, "Dropout", [x], [name],
                             {"ratio": ratio}))[0]
        self._channels[out] = self._channels[x]
        return out

    def softmax(self, name: str, x: str, axis: int = None) -> str:
        attrs = {} if axis is None else {"axis": axis}
        out = self._add(Node(name, "Softmax", [x], [name], attrs))[0]
        self._channels[out] = self._channels[x]
        return out

    def lrn(self, name: str, x: str, local_size: int = 5,
            alpha: float = 1e-4, beta: float = 0.75) -> str:
        out = self._add(Node(name, "LRN", [x], [name],
                             {"local_size": local_size, "alpha": alpha,
                              "beta": beta}))[0]
        self._channels[out] = self._channels[x]
        return out

    def sigmoid(self, name: str, x: str) -> str:
        out = self._add(Node(name, "Sigmoid", [x], [name]))[0]
        self._channels[out] = self._channels[x]
        return out

    def axpy(self, name: str, scale: str, x: str, y: str) -> str:
        """SENet-Caffe Axpy: out = scale*x + y (fused SE gate +
        residual add)."""
        out = self._add(Node(name, "Axpy", [scale, x, y], [name]))[0]
        self._channels[out] = self._channels[x]
        return out

    def shuffle_channel(self, name: str, x: str, group: int) -> str:
        """ShuffleNet channel shuffle (caffe-ShuffleNet fork layer)."""
        out = self._add(Node(name, "ShuffleChannel", [x], [name],
                             {"group": group}))[0]
        self._channels[out] = self._channels[x]
        return out

    def flatten(self, name: str, x: str) -> str:
        out = self._add(Node(name, "Flatten", [x], [name]))[0]
        self._channels[out] = self._channels[x]
        return out

    # ------------------------------------------------------------------
    def finish(self, outputs: Sequence[str]) -> Graph:
        self.graph.outputs = list(outputs)
        infer_shapes(self.graph)
        self.graph.validate()
        return self.graph
