"""Per-op lowering: IR node -> PyTorch ops on NHWC tensors.

Counterpart of ``feathercnn_tpu/ops/lowering.py``.  Two backends share this
module, as there:

  - "torch": every op is plain PyTorch (the float oracle; int8 weights and
    int8 edges are dequantized first, as the reference's "xla" does); the
    int8 Eltwise and the bottleneck chains take their kernels' plain
    versions, through kernels/dispatch.py.
  - "cuda":  Convolution, InnerProduct, the int8 Eltwise, FusedBottleneck
    and FusedChain go through kernels/dispatch.py to the hand-written
    kernels (their plain versions on CPU tensors) or, for the "winograd"
    and "dot1x1" algos, to plain PyTorch as the reference's are plain jnp;
    the rest stays plain PyTorch.

The int8 and f32 arithmetic rules the lowerings use are ``numerics.py``'s.

An op with no lowering here raises ``NotImplementedError`` naming it
(``lower_node``); every op of the reference has one.

A sharded engine (``EngineConfig.sharding``, ``parallel/``) lowers each
node through ``lower_sharded``, which adds what GSPMD adds in the
reference: the all-gather of a TP node's channel slice (``gather_channels``)
or, under ``ring_overlap``, the ring collective matmul in its place
(``takes_ring``), and the spatial halo exchange or H gather.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ir import Graph, Node, conv_out_dim
from ..kernels import dispatch as kdispatch
from ..kernels.nms import greedy_nms
from ..numerics import (Scale, act_segment_bounds, apply_act_segments,
                        apply_activation, conv_hparams, dequantize,
                        edge_scale, fma, nchw_conv, quantize, requantize,
                        sum_terms)
from ..utils.profiling import kept_const

__all__ = ["LoweringCtx", "lower_node", "lower_sharded", "takes_ring",
           "gather_channels", "register_lowering"]


class LoweringCtx:
    """Carried through lowering: config, graph, device, per-node quant
    metadata, and the device copies of per-node constants (scales, clamp
    bounds, numbers in an operand's type, laid-out weights) made once and
    reused every forward, so that a forward copies no number to the card
    (``kept``; ``utils.profiling.record()`` counts its misses and hits).
    A sharded engine sets ``mesh`` (``parallel.mesh.Mesh``) and ``tp``
    (``parallel.tp.shard_graph``'s TP node name -> (c0, c1, the input
    channels a depthwise conv reads); ``graph`` is then its rank-local
    copy).  Each engine, and each pipeline stage, has its own, on the
    device its operands live on."""

    def __init__(self, graph: Graph, config, device: torch.device,
                 mesh=None, tp: Optional[Dict[str, tuple]] = None):
        self.graph = graph
        self.config = config
        self.device = device
        self.mesh = mesh
        self.tp = tp or {}
        self._consts: Dict[tuple, Any] = {}
        self._halo_nodes: Dict[str, Node] = {}

    @property
    def backend(self) -> str:
        return self.config.backend

    def qinfo(self, node: Node) -> Optional[Dict[str, Any]]:
        return self.graph.meta.get("quant", {}).get(node.name)

    def const(self, node: Node, key: str, make: Callable[[], Any],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Device tensor for ``make()`` (an array or a number), built on
        first use for (node, key): float32, or a number as the reference's
        arithmetic with an operand of ``dtype`` takes it (JAX's weak
        typing: rounded to that type first; key it by the type)."""
        if dtype != torch.float32:
            return self.kept(node, key, lambda: torch.tensor(
                make(), dtype=dtype, device=self.device))
        return self.kept(node, key, lambda: torch.as_tensor(
            np.asarray(make(), np.float32), device=self.device))

    def scale(self, node: Node, key: str, v: float) -> Scale:
        """The number ``v`` of (node, key) as a ``numerics.Scale``: the
        float a kernel takes and its f32 device tensor, made once."""
        return self.kept(node, key, lambda: Scale(v, torch.tensor(
            v, dtype=torch.float32, device=self.device)))

    def dequantize_edge(self, node: Node, x: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
        """An int8 ``x`` that ``node``'s float path reads, as ``dtype``:
        dequantized at ``numerics.edge_scale`` of the node's quant
        metadata, kept.  A float ``x`` passes as it is."""
        if x.dtype != torch.int8:
            return x
        s = self.const(node, "edge_scale",
                       lambda: edge_scale(self.qinfo(node)))
        return dequantize(x, s).to(dtype)

    def kept(self, node: Node, key: str,
             make: Callable[[], Any]) -> Any:
        """What ``make()`` returns, made on first use for (node, key) and
        kept."""
        k = (node.name, key)
        t = self._consts.get(k)
        made = t is None
        if made:
            t = self._consts[k] = make()
        kept_const(node.name, key, made)
        return t


LowerFn = Callable[[Node, List[torch.Tensor], List[torch.Tensor],
                    LoweringCtx], List[torch.Tensor]]
_LOWERINGS: Dict[str, LowerFn] = {}


def register_lowering(op: str):
    def deco(fn: LowerFn) -> LowerFn:
        _LOWERINGS[op] = fn
        return fn
    return deco


def lower_node(node: Node, inputs, params, ctx: LoweringCtx):
    fn = _LOWERINGS.get(node.op)
    if fn is None:
        raise NotImplementedError(
            f"no lowering for op {node.op!r} (node {node.name!r}) in the "
            "PyTorch port yet")
    return fn(node, inputs, params, ctx)


# ----------------------------------------------------------------------
# Convolution family
# ----------------------------------------------------------------------

def _dequant_for_oracle(x, w, q, node, ctx):
    """The "torch" backend is the float oracle: int8 weights and int8 edges
    are dequantized here, as the reference's "xla" backend does."""
    x = ctx.dequantize_edge(node, x, getattr(torch, ctx.config.compute_dtype))
    if w.dtype == torch.int8:
        ws = ctx.const(node, "w_scale", lambda: q["w_scale"]) \
            if q is not None else 1.0
        w = (w.float() * ws).to(x.dtype)
    else:
        w = w.to(x.dtype)
    return x, w


@register_lowering("Convolution")
def _lower_conv(node, inputs, params, ctx):
    x = inputs[0]
    w = params[0]  # HWIO (H, W, Cin/group, Cout)
    bias = params[1] if node.attrs.get("bias_term", True) and len(params) > 1 \
        else None
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    act = node.attrs.get("activation")

    if ctx.backend == "cuda":
        return [kdispatch.conv_forward(node, x, w, bias, ctx)]

    x, w = _dequant_for_oracle(x, w, ctx.qinfo(node), node, ctx)
    if _ring_chunk(ctx, node, x.shape[-1], w.shape[-2]):
        # a TP pointwise conv is the FC's product reshaped: the same ring
        nb, hh, wb, cc = x.shape
        y = _ring_tp_matmul(ctx, x.reshape(-1, cc),
                            w.reshape(w.shape[-2], -1), bias)
        y = apply_activation(y, act)
        return [y.to(x.dtype).reshape(nb, hh, wb, -1)]
    y = nchw_conv(x.float(), w.float(), (sh, sw), (ph, pw), dil, group)
    if bias is not None:
        y = y + bias
    segs = node.attrs.get("act_segments")
    y = apply_act_segments(y, *kdispatch.segment_bounds(node, segs, ctx)) \
        if segs else apply_activation(y, act)
    return [y.to(x.dtype)]


@register_lowering("InnerProduct")
def _lower_fc(node, inputs, params, ctx):
    x = inputs[0]
    w = params[0]  # (in, out)
    bias = params[1] if node.attrs.get("bias_term", True) and len(params) > 1 \
        else None
    act = node.attrs.get("activation")
    if x.dim() > 2:
        # NHWC flatten; FC weights are pre-permuted for it
        x = x.reshape(x.shape[0], -1)

    if ctx.backend == "cuda":
        return [kdispatch.fc_forward(node, x, w, bias, ctx)]

    x, w = _dequant_for_oracle(x, w, ctx.qinfo(node), node, ctx)
    if w.dim() == 2 and _ring_chunk(ctx, node, x.shape[-1], w.shape[0]):
        y = _ring_tp_matmul(ctx, x, w, bias)
        return [apply_activation(y, act).to(x.dtype)]
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias
    y = apply_activation(y, act)
    return [y.to(x.dtype)]


def _subpixel_plan(k: int, s: int, p: int):
    """Per-dimension plan of the subpixel deconv: a stride-s transposed
    conv is s dense convs (one per output phase r = oy mod s) with
    ~ceil(k/s)-tap subkernels, interleaved.  Returns (Lp, PL, taps),
    taps[t][r] the source kernel index (or -1), so that
    y[s*q + r] = sum_t x[q + t - PL] * W[taps[t][r]]; None where the
    geometry needs the textbook form (a pad would go negative)."""
    L = -(-k // s)
    a = [(r + p) // s for r in range(s)]
    Lp = L + (max(a) - min(a))
    PL = Lp - 1 - max(a)
    if PL < 0:
        return None
    taps = np.full((Lp, s), -1, np.int64)
    for r in range(s):
        b = (r + p) % s
        for t in range(Lp):
            idx = s * (PL + a[r] - t) + b
            if 0 <= idx < k:
                taps[t, r] = idx
    return Lp, PL, taps


def _subpixel_weight(w: torch.Tensor, plan_h, plan_w, sh, sw, group):
    """The subpixel plans' dense weight: the (Lph, Lpw, Cin/g,
    g*sh*sw*Cout/g) HWIO gather of ``w`` (zeros where a phase has no tap,
    each group's outputs contiguous)."""
    k_h, k_w, cig, cout = w.shape
    (lph, _, taps_h), (lpw, _, taps_w) = plan_h, plan_w
    ih = torch.as_tensor(np.clip(taps_h, 0, k_h - 1))
    iw = torch.as_tensor(np.clip(taps_w, 0, k_w - 1))
    mask = torch.as_tensor(((taps_h >= 0)[:, :, None, None]
                            & (taps_w >= 0)[None, None, :, :])
                           .astype(np.float32))
    wg = w[ih[:, :, None, None].to(w.device),
           iw[None, None, :, :].to(w.device)]      # (Lph, sh, Lpw, sw, ...)
    wg = wg * mask[..., None, None].to(wg.device, wg.dtype)
    g = group
    wg = wg.reshape(lph, sh, lpw, sw, cig, g, cout // g)
    wg = wg.permute(0, 2, 4, 5, 1, 3, 6)
    return wg.reshape(lph, lpw, cig, g * sh * sw * (cout // g))


@register_lowering("Deconvolution")
def _lower_deconv(node, inputs, params, ctx):
    """Transposed conv (Caffe Deconvolution, FCN's upsampling), as the
    reference lowers it: at stride > 1 without dilation the subpixel form
    (one dense conv of sh*sw*Cout outputs over ceil(k/s)-tap subkernels,
    then depth to space; the gathered weight made once per node), else the
    textbook conv of the stride-dilated input with the flipped kernel.
    The products of compute-dtype operands summed in f32 (the reference's
    ``preferred_element_type``), + bias, activation, x's type.  Weights
    HWIO (KH, KW, Cin/g, Cout), each group's outputs contiguous.  An int8
    x (an int8 edge) is dequantized first, as the dispatcher's
    does (``LoweringCtx.dequantize_edge``)."""
    x = ctx.dequantize_edge(node, inputs[0],
                            getattr(torch, ctx.config.compute_dtype))
    w = params[0].to(x.dtype)
    bias = (params[1] if node.attrs.get("bias_term", True)
            and len(params) > 1 else None)
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    n, ih, iw, _ = x.shape
    cout = w.shape[3]
    oh = sh * (ih - 1) + dil * (kh - 1) + 1 - 2 * ph
    ow = sw * (iw - 1) + dil * (kw - 1) + 1 - 2 * pw
    plan_h = _subpixel_plan(kh, sh, ph)
    plan_w = _subpixel_plan(kw, sw, pw)
    qh, qw = -(-oh // sh), -(-ow // sw)
    pr_h = qh + max((r + ph) // sh for r in range(sh)) - ih
    pr_w = qw + max((r + pw) // sw for r in range(sw)) - iw
    if (dil == 1 and (sh > 1 or sw > 1) and plan_h and plan_w
            and pr_h >= 0 and pr_w >= 0):
        wg = ctx.kept(node, f"subpixel/{x.dtype}", lambda: _subpixel_weight(
            w, plan_h, plan_w, sh, sw, group))
        xp = F.pad(x.float(), (0, 0, plan_w[1], pr_w, plan_h[1], pr_h))
        y = nchw_conv(xp, wg.float(), 1, 0, 1, group)
        y = y.reshape(n, qh, qw, group, sh, sw, cout // group)
        y = y.permute(0, 1, 4, 2, 5, 3, 6).reshape(
            n, qh * sh, qw * sw, cout)[:, :oh, :ow, :]
    else:
        # the input dilated by the stride, the kernel flipped, padding
        # dil*(k-1) - pad on each side
        xd = x.float()
        if sh > 1 or sw > 1:
            xd = x.new_zeros((n, (ih - 1) * sh + 1, (iw - 1) * sw + 1,
                              x.shape[3]), dtype=torch.float32)
            xd[:, ::sh, ::sw] = x.float()
        pad_h, pad_w = dil * (kh - 1) - ph, dil * (kw - 1) - pw
        if pad_h < 0 or pad_w < 0:
            xd = xd[:, max(-pad_h, 0):xd.shape[1] - max(-pad_h, 0),
                    max(-pad_w, 0):xd.shape[2] - max(-pad_w, 0)]
        y = nchw_conv(xd, torch.flip(w, (0, 1)).float(), 1,
                      (max(pad_h, 0), max(pad_w, 0)), dil, group)
    if bias is not None:
        y = y + bias.float()
    y = apply_activation(y, node.attrs.get("activation"))
    return [y.to(x.dtype)]


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Align-corners bilinear interpolation as a dense (n_out, n_in) f32
    matrix (Caffe InterpLayer: src = i*(in-1)/(out-1))."""
    a = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        a[:, 0] = 1.0
        return a
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1)
        lo = min(int(np.floor(src)), n_in - 2)
        frac = src - lo
        a[i, lo] = 1.0 - frac
        a[i, lo + 1] = frac
    return a


@register_lowering("Interp")
def _lower_interp(node, inputs, params, ctx):
    """Bilinear resize (DeepLab's InterpLayer), align-corners, as two
    dense f32 matrix products with the interpolation matrices (made once
    per node), the rows first; negative pads crop first."""
    x = inputs[0]
    pb = node.attrs.get("pad_beg", 0)
    pe = node.attrs.get("pad_end", 0)
    if pb or pe:
        x = x[:, -pb:x.shape[1] + pe, -pb:x.shape[2] + pe, :]
    n, h, w, c = x.shape
    oh, ow = ctx.graph.specs[node.outputs[0]].shape[1:3]
    y = x.float()
    if oh != h:
        ah = ctx.const(node, f"interp_h/{h}", lambda: _interp_matrix(h, oh))
        y = torch.matmul(ah, y.reshape(n, h, w * c)).reshape(n, oh, w, c)
    if ow != w:
        aw = ctx.const(node, f"interp_w/{w}", lambda: _interp_matrix(w, ow))
        y = torch.matmul(aw, y.reshape(n * y.shape[1], w, c)).reshape(
            n, y.shape[1], ow, c)
    return [y.to(x.dtype)]


@register_lowering("Crop")
def _lower_crop(node, inputs, params, ctx):
    """Caffe Crop: bottom[0] cut to bottom[1]'s size on the NHWC ``axes``
    at the parallel ``offsets`` (the last offset repeats); a window past
    the edge raises."""
    x, ref = inputs
    axes = [d % x.dim() for d in node.attrs.get("axes", [1, 2])]
    offsets = list(node.attrs.get("offsets", [0]))
    for i, d in enumerate(axes):
        off = offsets[i] if i < len(offsets) else offsets[-1]
        if off + ref.shape[d] > x.shape[d]:
            raise ValueError(
                f"{node.name}: crop offset {off} + ref size {ref.shape[d]} "
                f"exceeds input size {x.shape[d]} on axis {d}")
        x = x.narrow(d, off, ref.shape[d])
    return [x]


@register_lowering("ArgMax")
def _lower_argmax(node, inputs, params, ctx):
    """Caffe ArgMaxLayer, indices as f32 (the first of equal values
    first).  With ``axis``: that dim becomes top_k indices (max values
    under ``out_max_val``); without: per image over the NCHW-order
    flattening, (N, 1, top_k) indices or (N, 2, top_k) [indices;
    values]."""
    x = inputs[0].float()
    k = int(node.attrs.get("top_k", 1))
    out_max_val = bool(node.attrs.get("out_max_val"))
    axis = node.attrs.get("axis")

    def top(t, dim):
        if k == 1:
            val, idx = torch.max(t, dim=dim, keepdim=True)
            return val, idx
        val, idx = torch.sort(t, dim=dim, descending=True, stable=True)
        return val.narrow(dim, 0, k), idx.narrow(dim, 0, k)

    if axis is not None:
        val, idx = top(x, axis % x.dim())
        return [val if out_max_val else idx.float()]
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    val, idx = top(x.reshape(x.shape[0], -1), 1)
    if out_max_val:
        return [torch.stack([idx.float(), val], dim=1)]
    return [idx.float()[:, None, :]]


@register_lowering("SPP")
def _lower_spp(node, inputs, params, ctx):
    """Caffe SPPLayer: per level l a pooling of 2^l x 2^l bins (kernel
    ceil(size/bins), stride = kernel, pad (kernel*bins - size + 1)//2),
    each flattened in Caffe's NCHW order, concatenated."""
    x = inputs[0]
    n, h, w, c = x.shape
    levels = []
    for lvl in range(int(node.attrs.get("pyramid_height", 1))):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        sub = Node(f"{node.name}/pool_{lvl}", "Pooling", list(node.inputs),
                   [f"{node.name}/pool_{lvl}"],
                   {"pool": node.attrs.get("pool", "MAX"), "kernel_h": kh,
                    "kernel_w": kw, "stride_h": kh, "stride_w": kw,
                    "pad_h": (kh * bins - h + 1) // 2,
                    "pad_w": (kw * bins - w + 1) // 2, "ceil_mode": True})
        (y,) = _lower_pool(sub, [x], [], ctx)
        if y.shape[1] != bins or y.shape[2] != bins:
            raise ValueError(f"{node.name}: level {lvl} pooled to "
                             f"{tuple(y.shape)}, want {bins} x {bins}")
        levels.append(y.permute(0, 3, 1, 2).reshape(n, -1))
    return [torch.cat(levels, dim=-1)]


# ----------------------------------------------------------------------
# Pooling — Caffe semantics: ceil-mode output size; AVE divides by the
# window clipped to the *padded* region.
# ----------------------------------------------------------------------

def _pool_padding(size, k, s, p, ceil_mode):
    out = conv_out_dim(size, k, s, p, 1, ceil_mode=ceil_mode)
    needed = (out - 1) * s + k - size - 2 * p  # extra high-side pad
    return out, max(needed, 0)


def _window_reduce(xp, kh, kw, sh, sw, oh, ow, op):
    """Reduce the kh x kw windows of the padded NHWC ``xp`` with ``op``
    (torch.maximum or torch.add), one strided slice per tap."""
    y = None
    for dh in range(kh):
        for dw in range(kw):
            sl = xp[:, dh:dh + (oh - 1) * sh + 1:sh,
                    dw:dw + (ow - 1) * sw + 1:sw]
            y = sl if y is None else op(y, sl)
    return y


@register_lowering("Pooling")
def _lower_pool(node, inputs, params, ctx):
    x = inputs[0]
    n, h, w, c = x.shape
    q = ctx.qinfo(node)
    rq = (q or {}).get("requant_int8")

    def _requant(avg_f32):
        # x_scale applies only when the producer really emitted int8
        int8 = x.dtype == torch.int8
        s = ctx.const(node, "requant_mul" + ("/int8" if int8 else ""),
                      lambda: (q["x_scale"] if int8 else 1.0) / q["y_scale"])
        return requantize(avg_f32, s)

    if node.attrs.get("global_pooling", False):
        if node.attrs.get("pool", "MAX") == "AVE":
            m = x.float().mean(dim=(1, 2), keepdim=True)
            return [_requant(m) if rq else m.to(x.dtype)]
        return [torch.amax(x, dim=(1, 2), keepdim=True)]

    kh = node.attrs.get("kernel_h", node.attrs.get("kernel_size"))
    kw = node.attrs.get("kernel_w", node.attrs.get("kernel_size"))
    sh = node.attrs.get("stride_h", node.attrs.get("stride", 1))
    sw = node.attrs.get("stride_w", node.attrs.get("stride", 1))
    ph = node.attrs.get("pad_h", node.attrs.get("pad", 0))
    pw = node.attrs.get("pad_w", node.attrs.get("pad", 0))
    ceil = node.attrs.get("ceil_mode", True)
    mode = node.attrs.get("pool", "MAX")

    oh, extra_h = _pool_padding(h, kh, sh, ph, ceil)
    ow, extra_w = _pool_padding(w, kw, sw, pw, ceil)
    pad = (0, 0, pw, pw + extra_w, ph, ph + extra_h)   # F.pad: last dim first

    if mode == "MAX":
        neg = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        xp = F.pad(x, pad, value=neg) if any(pad) else x
        return [_window_reduce(xp, kh, kw, sh, sw, oh, ow, torch.maximum)]
    if mode != "AVE":
        raise NotImplementedError(f"{node.name}: Pooling mode {mode!r}")

    # AVE: window sums (pad contributes zeros) over the window size clipped
    # to the padded extent [0, size + pad) — Caffe's pool_size.
    def counts(size, k, s, p, out):
        starts = np.arange(out) * s - p
        ends = np.minimum(starts + k, size + p)
        return (ends - starts).astype(np.float32)

    denom = ctx.const(node, "ave_denom", lambda: np.outer(
        counts(h, kh, sh, ph, oh), counts(w, kw, sw, pw, ow))[None, :, :, None])
    if rq and x.dtype == torch.int8:
        # int32 window sums (exact), x/y scales and the denominators folded
        # into one f32 multiply, as the reference's requantizing pool
        xp = F.pad(x.to(torch.int32), pad)
        y = _window_reduce(xp, kh, kw, sh, sw, oh, ow, torch.add)
        s = ctx.kept(node, "ave_mul", lambda: ctx.const(
            node, "x_over_y", lambda: q["x_scale"] / q["y_scale"]) / denom)
        return [requantize(y.float(), s)]
    xp = F.pad(x.float(), pad)
    y = _window_reduce(xp, kh, kw, sh, sw, oh, ow, torch.add) / denom
    return [_requant(y) if rq else y.to(x.dtype)]


# ----------------------------------------------------------------------
# Elementwise / shape ops
# ----------------------------------------------------------------------

@register_lowering("ReLU")
def _lower_relu(node, inputs, params, ctx):
    slope = node.attrs.get("negative_slope", 0.0)
    x = inputs[0]
    if slope:
        return [torch.where(x > 0, x, x * ctx.const(
            node, f"slope/{x.dtype}", lambda: slope, x.dtype))]
    return [torch.clamp_min(x, 0)]


@register_lowering("ReLU6")
def _lower_relu6(node, inputs, params, ctx):
    return [torch.clamp(inputs[0], 0, 6)]


@register_lowering("Eltwise")
def _lower_eltwise(node, inputs, params, ctx):
    op = node.attrs.get("operation", "SUM")
    q = ctx.qinfo(node)
    if q is not None and q.get("eltwise_int8"):
        # int8-edge residual add: dequant-accumulate in f32, fused
        # activation, requantize to the calibrated output scale.  Each
        # dequantizing multiply rounds once with the add that consumes it
        # (one FMA), where the reference's compiled add contracts it: the
        # first operand's product when it is one, else the second's; the
        # division by the output scale is, compiled, a multiply by its
        # reciprocal.  ``dispatch.eltwise_forward`` picks the kernel or
        # PyTorch's ops.
        return [kdispatch.eltwise_forward(node, inputs, ctx)]
    if op == "SUM":
        coeffs = node.attrs.get("coeffs")
        if coeffs:
            y = _coeff_sum(node, coeffs, inputs, ctx)
        else:
            y = inputs[0]
            for x in inputs[1:]:
                y = y + x
    elif op == "PROD":
        y = inputs[0]
        for x in inputs[1:]:
            y = y * x
    elif op == "MAX":
        y = inputs[0]
        for x in inputs[1:]:
            y = torch.maximum(y, x)
    else:
        raise ValueError(f"unknown Eltwise operation {op!r}")
    return [apply_activation(y, node.attrs.get("activation"))]


def _coeff_sum(node, coeffs, inputs, ctx):
    """``sum(c * x)`` as the reference's compiled Eltwise computes it, each
    coefficient rounded to x's type (kept per node and type): in f32 each
    product fused into the add that consumes it (``sum_terms``); in bf16
    every product and every sum rounded to bf16, left to right."""
    cs = [ctx.const(node, f"coeff{i}/{x.dtype}", lambda c=c: c, x.dtype)
          for i, (c, x) in enumerate(zip(coeffs, inputs))]
    if inputs[0].dtype == torch.float32:
        return sum_terms(list(zip(inputs, cs)))
    y = None
    for c, x in zip(cs, inputs):
        t = x * c
        y = t if y is None else y + t
    return y


def _onto_grid(node, i: int, x: torch.Tensor, s, y: float, ctx
               ) -> torch.Tensor:
    """Operand ``i`` of a requantizing concat or a ladder, on the output's
    grid ``y``: an int8 operand at scale ``s`` rescaled by
    ``round(x * (s / y))``, a float one quantized by ``round(x / y)``;
    the multiplier and the scale kept per node."""
    if x.dtype == torch.int8:
        if s is not None and s != y:
            x = requantize(x.float(),
                           ctx.const(node, f"onto_grid{i}", lambda: s / y))
        return x
    return quantize(x, ctx.const(node, "y_scale", lambda: y))


@register_lowering("Concat")
def _lower_concat(node, inputs, params, ctx):
    axis = node.attrs.get("axis", -1)
    q = ctx.qinfo(node)
    if q is not None and q.get("concat_int8"):
        # requantizing concat (quant/rewrite.py): each operand arrives int8
        # at its own calibrated scale or float; the output carries one scale
        y = q["y_scale"]
        return [torch.cat([_onto_grid(node, i, x, s, y, ctx) for i, (x, s)
                           in enumerate(zip(inputs, q["in_scales"]))],
                          dim=axis)]
    # float, or the single-scale int8 passthrough
    return [torch.cat(inputs, dim=axis)]


def _ladder_parts(node, parts, ctx):
    """A ladder node's parts, on the buffer's grid under int8
    (``ladder_int8``, passes_ladder.py), else as they come."""
    q = ctx.qinfo(node)
    if q is not None and q.get("ladder_int8"):
        return [_onto_grid(node, i, x, s, q["y_scale"], ctx)
                for i, (x, s) in enumerate(zip(parts, q["in_scales"]))]
    return list(parts)


def _write_parts(buf: torch.Tensor, parts, off: int) -> int:
    """Copy ``parts`` into ``buf``'s channels from ``off`` on, in place;
    returns the first channel after them."""
    for p in parts:
        k = p.shape[-1]
        buf[..., off:off + k].copy_(p)
        off += k
    return off


@register_lowering("LadderInit")
def _lower_ladder_init(node, inputs, params, ctx):
    """The concat ladder's buffer (passes_ladder.py), allocated once at the
    chain's final width: the parts first, zeros after."""
    parts = _ladder_parts(node, inputs, ctx)
    buf = torch.empty(parts[0].shape[:-1] + (node.attrs["total"],),
                      dtype=parts[0].dtype, device=parts[0].device)
    filled = _write_parts(buf, parts, 0)
    buf[..., filled:].zero_()
    return [buf]


@register_lowering("LadderAppend")
def _lower_ladder_append(node, inputs, params, ctx):
    """Writes its parts into the buffer in place, at channel ``offset``
    (the reference's ``dynamic_update_slice``): the append moves k
    channels, and the buffer it returns is the storage it was given."""
    buf = inputs[0]
    _write_parts(buf, _ladder_parts(node, inputs[1:], ctx),
                 node.attrs["offset"])
    return [buf]


@register_lowering("LadderView")
def _lower_ladder_view(node, inputs, params, ctx):
    """The buffer's first ``channels`` channels, a view (no copy); its
    rows are strided unless it is the whole buffer.  The prefix is never
    written again, so the view keeps its values."""
    x = inputs[0]
    c = node.attrs["channels"]
    return [x if c == x.shape[-1] else x[..., :c]]


@register_lowering("SpaceToDepth")
def _lower_s2d(node, inputs, params, ctx):
    """2x2 space-to-depth with edge padding (passes_stem.py), in the
    input's dtype (an int8 input pads with int8 zeros); channel order
    (i, j, c) to match the re-packed stem weights."""
    x = inputs[0]
    blk = node.attrs.get("block", 2)
    pad = node.attrs.get("pad", 0)
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    n, h, w, c = x.shape
    x = x.reshape(n, h // blk, blk, w // blk, blk, c)
    return [x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // blk, w // blk, blk * blk * c)]


@register_lowering("LRN")
def _lower_lrn(node, inputs, params, ctx):
    """Local response normalization across channels (the last axis):
    ``y = x / (k + alpha/n * sum_window x^2)^beta``.

    int8-edge mode (quant/rewrite.py ``requant_int8``): dequantize, LRN in
    f32, requantize with a divide (``round(y / y_scale)``).  The window sum
    is one exact f32 form for every ``lrn_band`` value (a TPU formulation
    flag): the terms added in channel order, as the reference's
    ``reduce_window`` adds them (its ``C < local_size`` case included: the
    window runs over zero padding).  ``k + (alpha/n)*sum`` rounds once, as
    the reference's compiled form contracts it.  beta 0.75 is
    ``r * sqrt(r)`` and 0.5 is ``r``, with ``r = 1 / sqrt(b)`` (two IEEE
    roundings, the same on the CPU and the card); any other beta ``b **
    -beta``."""
    q = ctx.qinfo(node)
    rq = q is not None and q.get("requant_int8")
    x = inputs[0]
    xf = _dequantize(node, "x_scale", x, q["x_scale"], ctx) if rq \
        else x.float()
    n = node.attrs.get("local_size", 5)
    alpha = node.attrs.get("alpha", 1e-4)
    beta = node.attrs.get("beta", 0.75)
    k = node.attrs.get("k", 1.0)
    half = n // 2
    c = xf.shape[-1]
    sq = F.pad(xf * xf, (half, n - 1 - half))
    ssum = sq[..., 0:c]
    for j in range(1, n):
        ssum = ssum + sq[..., j:j + c]
    del sq
    b = fma(ssum, ctx.const(node, "alpha_n", lambda: alpha / n),
            ctx.const(node, "k", lambda: k))
    if beta == 0.75:
        r = 1.0 / torch.sqrt(b)
        scl = r * torch.sqrt(r)
    elif beta == 0.5:
        scl = 1.0 / torch.sqrt(b)
    else:
        scl = torch.pow(b, -beta)
    y = xf * scl
    if rq:
        return [_quantize_out(node, y, q, ctx)]
    return [y.to(x.dtype)]


def _dequantize(node, key: str, x: torch.Tensor, s, ctx) -> torch.Tensor:
    """``numerics.dequantize`` of ``x`` at the node's scale ``s``, kept
    under ``key`` (a float ``x``, which reads no scale, as f32)."""
    if x.dtype != torch.int8:
        return x.float()
    return dequantize(x, ctx.const(node, key, lambda: s))


def _quantize_out(node, y: torch.Tensor, q, ctx) -> torch.Tensor:
    """``numerics.quantize`` of ``y`` at the node's kept ``y_scale``."""
    return quantize(y, ctx.const(node, "y_scale", lambda: q["y_scale"]))


def _channel_gate(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel gate or scaler given as (N, C) or (N, 1, 1, C),
    shaped to broadcast over ``x`` (N, H, W, C)."""
    if s.dim() < x.dim():
        s = s.reshape((s.shape[0],) + (1,) * (x.dim() - s.dim())
                      + tuple(s.shape[1:]))
    return s


@register_lowering("Sigmoid")
def _lower_sigmoid(node, inputs, params, ctx):
    """``1 / (1 + exp(-x))`` as the reference's compiled
    ``jax.nn.sigmoid`` computes it: ``exp`` and the add rounded to x's
    type, the division in f32 (``torch.sigmoid`` rounds once and differs
    by an ulp in ~30% of bf16 values).  The result stays f32: the
    reference's compiled consumer (the SE gate's Axpy) reads the division
    before its rounding to a bf16 x's type (XLA keeps the excess
    precision inside a fusion), so an f32 gate gives the reference's
    Axpy outputs; rounded to bf16 it is the reference's Sigmoid edge."""
    return [1 / (1 + torch.exp(-inputs[0])).float()]


@register_lowering("Scale")
def _lower_scale(node, inputs, params, ctx):
    """Per-channel affine (an un-folded Scale, or a BatchNorm that
    ``fold_batchnorm`` turned into one), in the reference's three forms:

    - int8 edge (quant/rewrite.py ``requant_int8``): an int8 ``x``
      dequantized by ``x_scale``, ``x * gamma + beta`` in f32 (one rounding,
      as the reference's compiled form contracts it), the fused activation,
      then ``round(y / y_scale)`` with a divide;
    - two bottoms (Caffe's ScaleLayer with a runtime scaler, e.g. an SE
      gate): ``x * bottom[1]`` broadcast over H and W in x's type, plus the
      learned bias ``params[0]`` where ``bias_term`` is set;
    - the plain per-channel affine in x's type."""
    x = inputs[0]
    a = node.attrs
    bias = a.get("bias_term", False)
    act = a.get("activation")
    q = ctx.qinfo(node)
    if q is not None and q.get("requant_int8"):
        xf = _dequantize(node, "x_scale", x, q["x_scale"], ctx)
        if bias and len(params) > 1:
            y = fma(xf, params[0].float(), params[1].float())
        else:
            y = xf * params[0].float()
        return [_quantize_out(node, apply_activation(y, act), q, ctx)]
    if len(inputs) > 1:
        y = x * _channel_gate(inputs[1], x).to(x.dtype)
        if bias and params:
            y = y + params[0].to(x.dtype)
        return [apply_activation(y, act)]
    y = x * params[0].to(x.dtype)
    if bias and len(params) > 1:
        y = y + params[1].to(x.dtype)
    return [apply_activation(y, act)]


@register_lowering("Axpy")
def _lower_axpy(node, inputs, params, ctx):
    """SENet-Caffe's Axpy: ``out = a * x + y``, ``a`` the SE path's
    per-channel gate ((N, C) or (N, 1, 1, C)), the fused activation after.

    int8-edge form (quant/rewrite.py ``axpy_int8``): x and y arrive int8 at
    their calibrated scales (``in_scales``) or float, the gate float; each
    int8 operand dequantized by its own multiply, ``a * x + y`` in f32 (one
    rounding, as the reference's compiled form contracts it), the
    activation, then ``round(out / y_scale)`` with a divide.  The float
    form computes ``a * x + y`` in f32 and returns x's type."""
    s, x, y = inputs
    s = _channel_gate(s, x).float()
    q = ctx.qinfo(node)
    act = node.attrs.get("activation")
    if q is not None and q.get("axpy_int8"):
        sx, sy = q["in_scales"]
        out = fma(s, _dequantize(node, "in_scale0", x, sx, ctx),
                  _dequantize(node, "in_scale1", y, sy, ctx))
        return [_quantize_out(node, apply_activation(out, act), q, ctx)]
    out = fma(s, x.float(), y.float())
    return [apply_activation(out, act).to(x.dtype)]


@register_lowering("Bias")
def _lower_bias(node, inputs, params, ctx):
    """Caffe's BiasLayer: ``x + b``, ``b`` the learned blob or the second
    bottom, in x's type."""
    x = inputs[0]
    b = params[0] if params else inputs[1]
    return [x + b.to(x.dtype)]


@register_lowering("BatchNorm")
def _lower_batchnorm(node, inputs, params, ctx):
    """Inference BatchNorm with stored statistics, ``(x - mean) /
    sqrt(var + eps)`` in f32, in x's type.  ``fold_batchnorm`` turns it
    into a Scale; this runs on the un-optimized graph
    (``Engine(..., optimize_graph=False)``, the oracle path)."""
    x = inputs[0]
    mean, var = params[0].float(), params[1].float()
    inv = torch.rsqrt(var + node.attrs.get("eps", 1e-5))
    return [((x.float() - mean) * inv).to(x.dtype)]


@register_lowering("ShuffleChannel")
def _lower_shuffle_channel(node, inputs, params, ctx):
    """ShuffleNet's channel shuffle: the channels viewed as (group,
    C/group), transposed and flattened, so output channel ``j*g + i`` reads
    input channel ``i*(C/g) + j``.  A permutation, the same for int8 and
    float edges; ``shuffle_matmul`` (the reference's TPU form: a one-hot
    permutation matmul, exact in every type) computes this same
    permutation."""
    x = inputs[0]
    g = int(node.attrs.get("group", 1))
    if g == 1:
        return [x]
    lead, c = tuple(x.shape[:-1]), x.shape[-1]
    return [x.reshape(lead + (g, c // g)).transpose(-1, -2)
            .reshape(lead + (c,))]


# ----------------------------------------------------------------------
# The loose ops: layers a converted Caffe graph may hold that no zoo
# builder uses.  Each computes in x's type, its Python-number attributes
# rounded to that type first, as the reference's arithmetic does.  The
# transcendental ones (TanH, ELU, Exp, Log, BNLL, a fractional Power) are
# evaluated in f64 and rounded once to x's type (``_in_f64``): a result
# within one ulp of the exact value, the same on every ATen CPU path and
# on the card (ATen's f32 ``tanh``, ``exp`` and ``log`` differ by ISA and
# build).
# ----------------------------------------------------------------------


def _in_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of x in f64, rounded once to x's type."""
    return fn(x.double()).to(x.dtype)


@register_lowering("PReLU")
def _lower_prelu(node, inputs, params, ctx):
    x = inputs[0]
    slope = params[0].to(x.dtype)      # (C,), or one value (channel_shared)
    return [torch.where(x > 0, x, x * slope)]


@register_lowering("TanH")
def _lower_tanh(node, inputs, params, ctx):
    return [_in_f64(torch.tanh, inputs[0])]


@register_lowering("ELU")
def _lower_elu(node, inputs, params, ctx):
    """``jax.nn.elu``: x where x > 0, else ``alpha * expm1(x)`` with alpha
    rounded to x's type, in f64 and rounded once."""
    x = inputs[0]
    alpha = ctx.const(node, f"alpha/{x.dtype}",
                      lambda: node.attrs.get("alpha", 1.0), x.dtype).double()
    neg = torch.where(x > 0, torch.zeros_like(x), x)
    return [torch.where(x > 0, x, _in_f64(
        lambda v: alpha * torch.expm1(v), neg))]


@register_lowering("AbsVal")
def _lower_abs(node, inputs, params, ctx):
    return [torch.abs(inputs[0])]


@register_lowering("Exp")
def _lower_exp(node, inputs, params, ctx):
    return [_in_f64(torch.exp, inputs[0])]


@register_lowering("Log")
def _lower_log(node, inputs, params, ctx):
    return [_in_f64(torch.log, inputs[0])]


@register_lowering("BNLL")
def _lower_bnll(node, inputs, params, ctx):
    """``softplus`` as ``jax.nn.softplus`` defines it (``logaddexp(x,
    0)``): ``max(x, 0) + log1p(exp(-|x|))`` in f64, rounded once; a NaN
    x stays NaN."""
    x = inputs[0]
    y = _in_f64(lambda v: torch.clamp_min(v, 0)
                + torch.log1p(torch.exp(-torch.abs(v))), x)
    return [torch.where(torch.isnan(x), x, y)]


@register_lowering("Power")
def _lower_power(node, inputs, params, ctx):
    """Caffe PowerLayer, ``(shift + scale * x) ** power``, with scale and
    shift rounded to x's type.  In f32 the multiply-add is one FMA and in
    bf16 two roundings, as the reference's compiled form computes them;
    a whole power is taken in f32 and rounded to x's type, any other in
    f64 and rounded once."""
    a = node.attrs
    x = inputs[0]
    scale, shift = (ctx.const(node, f"{k}/{x.dtype}",
                              lambda k=k, v=v: a.get(k, v), x.dtype)
                    for k, v in (("scale", 1.0), ("shift", 0.0)))
    if x.dtype == torch.float32:
        y = fma(x, scale, shift)
    else:
        y = x * scale + shift
    p = a.get("power", 1.0)
    if p == 1.0:
        return [y]
    if p != int(p):
        return [_in_f64(lambda v: torch.pow(v, p), y)]
    return [torch.pow(y.float(), p).to(x.dtype)]


@register_lowering("MVN")
def _lower_mvn(node, inputs, params, ctx):
    """Caffe MVNLayer: per-image mean (and, by default, variance)
    normalization in f32 over H, W (and C with ``across_channels``); the
    variance divides by ``std + eps``, as Caffe does."""
    x = inputs[0].float()
    dims = (1, 2, 3) if node.attrs.get("across_channels") else (1, 2)
    if x.dim() == 2:
        dims = (1,)
    y = x - x.mean(dim=dims, keepdim=True)
    if node.attrs.get("normalize_variance", True):
        std = torch.sqrt((y * y).mean(dim=dims, keepdim=True))
        y = y / (std + node.attrs.get("eps", 1e-9))
    return [y.to(inputs[0].dtype)]


@register_lowering("Tile")
def _lower_tile(node, inputs, params, ctx):
    """Caffe TileLayer: the whole tensor repeated along one axis."""
    x = inputs[0]
    reps = [1] * x.dim()
    reps[node.attrs.get("axis", -1) % x.dim()] = int(
        node.attrs.get("tiles", 1))
    return [x.repeat(*reps)]


@register_lowering("Reduction")
def _lower_reduction(node, inputs, params, ctx):
    """Caffe ReductionLayer: SUM, ASUM, SUMSQ or MEAN over every dim from
    ``axis`` (Caffe's NCHW terms: an NHWC x is transposed first), times
    ``coeff``; f32."""
    x = inputs[0].float()
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    axis = int(node.attrs.get("axis", 0))
    op = node.attrs.get("operation", "SUM")
    dims = tuple(range(axis, x.dim()))
    if op == "ASUM":
        y = torch.abs(x).sum(dim=dims)
    elif op == "SUMSQ":
        y = (x * x).sum(dim=dims)
    elif op == "MEAN":
        y = x.mean(dim=dims)
    elif op == "SUM":
        y = x.sum(dim=dims)
    else:
        raise ValueError(f"unknown Reduction operation {op!r}")
    coeff = node.attrs.get("coeff", 1.0)
    return [y * coeff if coeff != 1.0 else y]


@register_lowering("Threshold")
def _lower_threshold(node, inputs, params, ctx):
    """Caffe ThresholdLayer: 1 where x > threshold, else 0, in x's
    type."""
    x = inputs[0]
    return [(x > ctx.const(node, f"threshold/{x.dtype}",
                           lambda: node.attrs.get("threshold", 0.0),
                           x.dtype)).to(x.dtype)]


# ----------------------------------------------------------------------
# Region fusion (passes_fusion.py): identity bottlenecks
# ----------------------------------------------------------------------

@register_lowering("FusedBottleneck")
def _lower_fused_block(node, inputs, params, ctx):
    """One identity bottleneck: a 1-block chain (kernels/fused_chain,
    through ``dispatch.chain_forward``)."""
    w1, b1, w2, b2, w3, b3 = params
    # Graph weights are HWIO; the chain function wants stacked matrices.
    c, cm = w1.shape[-2], w1.shape[-1]
    weights = (w1.reshape(1, c, cm), b1.reshape(1, -1),
               w2.reshape(1, 9 * cm, cm), b2.reshape(1, -1),
               w3.reshape(1, cm, c), b3.reshape(1, -1))
    q = ctx.qinfo(node)
    if not (node.attrs.get("quant") and q is not None):
        return [kdispatch.chain_forward(node, inputs[0], weights, ctx)]
    ws = tuple(ctx.const(node, f"w{i + 1}s",
                         lambda s=s: np.asarray(s).reshape(1, -1))
               for i, s in enumerate(q["w_scales"]))
    a = node.attrs
    scales = ((a["s_x"],), (a["s_y1"],), (a["s_y2"],), a.get("s_out"))
    return [kdispatch.chain_forward(node, inputs[0], weights, ctx, ws,
                                    scales)]


@register_lowering("FusedChain")
def _lower_fused_chain(node, inputs, params, ctx):
    """Chained identity bottlenecks (passes_fusion.fuse_chains ->
    kernels/fused_chain)."""
    q = ctx.qinfo(node)
    if not (node.attrs.get("quant") and q is not None):
        return [kdispatch.chain_forward(node, inputs[0], params, ctx)]
    ws = tuple(ctx.const(node, k, lambda k=k: q[k])
               for k in ("w1s", "w2s", "w3s"))
    a = node.attrs
    scales = (a["sx"], a["sy1"], a["sy2"], a.get("s_out"))
    return [kdispatch.chain_forward(node, inputs[0], params, ctx, ws,
                                    scales)]


# ----------------------------------------------------------------------
# Detection heads (SSD: Permute, Normalize, PriorBox, DetectionOutput;
# two-stage: Proposal, ROIPooling, PSROIPooling).  Each computes one exact
# form of the reference's lowering, whatever its TPU formulation flags
# (``topk_radix``, ``det_thresh_first``, ``det_take_gather``,
# ``nms_blocked``, ``proposal_sort_payload``, ``roipool_table``,
# ``roipool_full_pyramid``) say.  Ties in every top-K and sort are broken
# by index, as the reference's CPU forms break them: a stable descending
# sort (``torch.topk`` keeps no tie order).  ``exp`` is the reference's
# own f32 expansion (``exp_f32``), and a product feeding an add is one
# rounding (``fma``), as the reference's compiled form contracts it.
# ----------------------------------------------------------------------

@register_lowering("Permute")
def _lower_permute(node, inputs, params, ctx):
    """SSD's NCHW->NHWC Permute: the identity in NHWC storage (the shape
    function refuses every other order); Flatten then reads the value in
    Caffe's post-permute order."""
    return [inputs[0]]


@register_lowering("Normalize")
def _lower_normalize(node, inputs, params, ctx):
    """Caffe ssd NormalizeLayer: f32 L2 norm over the channels of each
    pixel (or over the whole image with ``across_spatial``), ``sqrt(sum +
    1e-10)``, the division, then the learned per-channel (or shared)
    scale; x's type."""
    x = inputs[0].float()
    dims = (1, 2, 3) if node.attrs.get("across_spatial") else (-1,)
    norm = torch.sqrt((x * x).sum(dim=dims, keepdim=True)
                      + ctx.const(node, "eps", lambda: 1e-10))
    y = x / norm
    if params:
        y = y * params[0].float().reshape(-1)
    return [y.to(inputs[0].dtype)]


def priorbox_boxes(node, feat_shape, img_shape) -> np.ndarray:
    """Caffe ssd PriorBoxLayer (prior_box_layer.cpp Forward) on the host,
    the reference's numpy form: (1, 2, H*W*num_priors*4) f32, row 0 the
    boxes, row 1 the variances."""
    a = node.attrs
    _, fh, fw, _ = feat_shape
    _, ih, iw, _ = img_shape
    step_w = float(a.get("step", 0)) or iw / fw
    step_h = float(a.get("step", 0)) or ih / fh
    offset = float(a.get("offset", 0.5))
    min_sizes = [float(s) for s in a.get("min_sizes", [])]
    max_sizes = [float(s) for s in a.get("max_sizes", [])]
    flip = bool(a.get("flip", True))
    # Caffe expands aspect_ratios_ = [1] + [r, (1/r if flip)] per given r
    ars = [1.0]
    for r in a.get("aspect_ratios", []):
        r = float(r)
        if any(abs(r - e) < 1e-6 for e in ars):
            continue
        ars.append(r)
        if flip:
            ars.append(1.0 / r)
    wh = []      # (box_w, box_h) per prior, Caffe emission order
    for i, s in enumerate(min_sizes):
        wh.append((s, s))
        if max_sizes:
            sp = float(np.sqrt(s * max_sizes[i]))
            wh.append((sp, sp))
        for r in ars:
            if abs(r - 1.0) < 1e-6:
                continue
            wh.append((s * np.sqrt(r), s / np.sqrt(r)))
    wh = np.asarray(wh, np.float32)                      # (np, 2)
    cx = (np.arange(fw, dtype=np.float32) + offset) * step_w
    cy = (np.arange(fh, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)                       # (fh, fw)
    cxg = cxg[..., None]
    cyg = cyg[..., None]
    boxes = np.stack([
        (cxg - wh[:, 0] / 2) / iw, (cyg - wh[:, 1] / 2) / ih,
        (cxg + wh[:, 0] / 2) / iw, (cyg + wh[:, 1] / 2) / ih,
    ], axis=-1)                                          # (fh, fw, np, 4)
    if a.get("clip"):
        boxes = np.clip(boxes, 0.0, 1.0)
    var = [float(v) for v in a.get("variances", [0.1])]
    if len(var) == 1:
        var = var * 4
    variances = np.tile(np.asarray(var, np.float32),
                        fh * fw * len(wh))
    return np.stack([boxes.reshape(-1), variances])[None]


@register_lowering("PriorBox")
def _lower_priorbox(node, inputs, params, ctx):
    """The priors depend on shapes alone: made on the host once per node
    and kept on the device."""
    feat = ctx.graph.specs[node.inputs[0]].shape
    img = ctx.graph.specs[node.inputs[1]].shape
    return [ctx.const(node, "priors",
                      lambda: priorbox_boxes(node, feat, img))]


def _stable_top(x: torch.Tensor, k: int):
    """The k largest along the last axis, descending, ties by index (the
    reference's top-K on the CPU): values and indices."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[..., idx, :]`` per leading slice: t (..., P, F), idx (..., K)."""
    return torch.gather(t, -2, idx[..., None].expand(
        idx.shape + (t.shape[-1],)))


# The f32 ``exp`` of the reference's compiled heads (XLA's CPU expansion):
# x clamped, n = floor(x*log2(e) + 1/2), r = x - n*ln2 in two FMA steps,
# Cephes' degree-5 polynomial by FMA steps, 2^n applied to the exponent
# (2^127 * 2 at n = 128), results below f32's least normal flushed to 0.
_EXP_CLAMP = (-88.3762626647949, 88.7228391)
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
# the f32 steps' constants, in order: log2(e), 1/2, ln 2 in two parts
# (negated), the polynomial's coefficients after its first, 1
EXP_F32_CONSTS = np.asarray((1.44269504088896341, 0.5, -0.693359375,
                             2.12194440e-4, *_EXP_POLY[1:], 1.0), np.float32)


def exp_f32(x: torch.Tensor, c: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """f32 ``exp`` as the reference's compiled detection heads compute it
    (XLA's CPU expansion, the constants above), so a decoded box is the
    reference's to the bit: equal to ``jnp.exp`` up to 88.3763, within 6
    ulp above it, where the result passes 2.4e38
    (``tests/test_torch_detection_ops.py``).  Every step is an IEEE f32
    operation or an ``fma``: the same value on the CPU and the card.
    ``c``: ``EXP_F32_CONSTS`` on x's device, which a lowering keeps per
    node (made here where None)."""
    if c is None:
        c = torch.as_tensor(EXP_F32_CONSTS, device=x.device)
    x = torch.clamp(x.float(), *_EXP_CLAMP)
    n = torch.floor(fma(x, c[0], c[1]))
    r = fma(n, c[2], x)
    r = fma(n, c[3], r)
    y = torch.full_like(r, float(np.float32(_EXP_POLY[0])))
    for i in range(4, 4 + len(_EXP_POLY) - 1):
        y = fma(y, r, c[i])
    y = fma(y, r * r, r) + c[-1]
    k = n.to(torch.int32)
    top = k > 127
    y = y * ((torch.where(top, k - 1, k) + 127) << 23).view(torch.float32)
    y = torch.where(top, y * 2, y)
    return torch.where(y < torch.finfo(torch.float32).tiny,
                       torch.zeros((), device=x.device), y)


@register_lowering("DetectionOutput")
def _lower_detection_output(node, inputs, params, ctx):
    """Caffe ssd DetectionOutputLayer, fixed shape: CENTER_SIZE decode
    (``pvar * l * pw + pcx`` as the reference's compiled model computes
    it: ``pvar * l`` rounded, its product with pw fused into the add; a
    head compiled alone folds the constant ``pvar * pw`` first, one
    rounding apart), per class the top ``nms_top_k`` priors by score (ties by
    prior index), greedy NMS over those above ``confidence_threshold``
    (kernels/nms.py), then the ``keep_top_k`` best kept boxes over all
    classes (ties by class, then rank).  Output (N, keep_top_k, 7) rows
    [image_id, label, score, xmin, ymin, xmax, ymax], padded with label
    -1, score and box 0.  ``share_location=False`` decodes each class's
    own deltas.  The reference's ``topk_radix``, ``det_thresh_first`` and
    ``det_take_gather`` forms give these same rows."""
    a = node.attrs
    num_classes = int(a["num_classes"])
    bg = int(a.get("background_label_id", 0))
    conf_thresh = float(a.get("confidence_threshold", 0.01))
    nms_thresh = float(a.get("nms_threshold", 0.45))
    nms_top_k = int(a.get("nms_top_k", 400))
    keep_top_k = int(a.get("keep_top_k", 200))
    share_loc = bool(a.get("share_location", True))
    num_loc = 1 if share_loc else num_classes

    loc, conf, priors = inputs
    dev = loc.device
    n = loc.shape[0]
    pb = priors.float().reshape(2, -1, 4)
    pbox, pvar = pb[0], pb[1]
    P = pbox.shape[0]
    loc = loc.reshape(n, P, num_loc, 4).float()
    conf = conf.reshape(n, P, num_classes).float()
    K = min(nms_top_k, P)
    cls = [c for c in range(num_classes) if c != bg]
    cls_t = ctx.kept(node, "classes",
                     lambda: torch.as_tensor(cls, device=ctx.device))
    exp_c = ctx.const(node, "exp_f32", lambda: EXP_F32_CONSTS)

    pw = pbox[:, 2] - pbox[:, 0]
    ph = pbox[:, 3] - pbox[:, 1]
    pcx = (pbox[:, 0] + pbox[:, 2]) * 0.5
    pcy = (pbox[:, 1] + pbox[:, 3]) * 0.5

    def decode(l):                              # (..., P, 4) -> (..., P, 4)
        cx = fma(pvar[:, 0] * l[..., 0], pw, pcx)
        cy = fma(pvar[:, 1] * l[..., 1], ph, pcy)
        w = exp_f32(pvar[:, 2] * l[..., 2], exp_c) * pw
        h = exp_f32(pvar[:, 3] * l[..., 3], exp_c) * ph
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           dim=-1)

    rows = conf[:, :, cls_t].transpose(1, 2)              # (N, C', P)
    sc, idx = _stable_top(rows, K)                        # (N, C', K)
    if share_loc:
        boxes = decode(loc[:, :, 0])                      # (N, P, 4)
        bx = _take_rows(boxes[:, None].expand(n, len(cls), P, 4), idx)
    else:
        boxes = decode(loc[:, :, cls_t].transpose(1, 2))  # (N, C', P, 4)
        bx = _take_rows(boxes, idx)
    keep = greedy_nms(bx, sc > ctx.const(node, "conf_thresh",
                                         lambda: conf_thresh), nms_thresh)
    sc = torch.where(keep, sc, torch.full_like(sc, -1.0)).reshape(n, -1)
    bx = bx.reshape(n, -1, 4)
    lb = cls_t.float().repeat_interleave(K)               # (C' * K,)
    top, ti = _stable_top(sc, min(keep_top_k, sc.shape[1]))
    good = top > 0
    out = torch.cat([
        torch.where(good, lb[ti], torch.full_like(top, -1.0))[..., None],
        torch.where(good, top, torch.zeros_like(top))[..., None],
        torch.where(good[..., None], _take_rows(bx, ti),
                    torch.zeros((), device=dev))], dim=-1)
    pad = keep_top_k - out.shape[1]
    if pad:
        fill = ctx.const(node, "pad_row", lambda: [-1.0, 0, 0, 0, 0, 0])
        out = torch.cat([out, fill.expand(n, pad, 6)], dim=1)
    img_id = torch.arange(n, dtype=torch.float32, device=dev)
    return [torch.cat([img_id[:, None, None].expand(n, keep_top_k, 1), out],
                      dim=-1)]


def generate_anchors(base_size=16, ratios=(0.5, 1.0, 2.0),
                     scales=(8.0, 16.0, 32.0)) -> np.ndarray:
    """The RPN anchor grid (py-faster-rcnn generate_anchors.py): the base
    box's aspect ratios, then scales.  (A, 4) [x1, y1, x2, y2] f32 around
    the base box's center."""
    w = h = float(base_size)
    cx = cy = (base_size - 1) * 0.5
    out = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            out.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1),
                        cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
    return np.asarray(out, np.float32)


def _anchor_geometry(node, fh, fw):
    """(4, fh*fw*A) f32: the shifted anchors' widths, heights and centers
    with the +1 width convention, in the (h, w, anchor) order of the score
    map's channels."""
    a = node.attrs
    stride = float(a.get("feat_stride", 16))
    anchors = generate_anchors(int(a.get("base_size", 16)),
                               tuple(a.get("ratios", (0.5, 1.0, 2.0))),
                               tuple(a.get("scales", (8.0, 16.0, 32.0))))
    sx = np.arange(fw, dtype=np.float32) * np.float32(stride)
    sy = np.arange(fh, dtype=np.float32) * np.float32(stride)
    sxg, syg = np.meshgrid(sx, sy)
    shifts = np.stack([sxg, syg, sxg, syg], -1)
    al = (shifts[:, :, None, :] + anchors).reshape(-1, 4)
    one, half = np.float32(1.0), np.float32(0.5)
    aw = al[:, 2] - al[:, 0] + one
    ah = al[:, 3] - al[:, 1] + one
    return np.stack([aw, ah, al[:, 0] + half * aw, al[:, 1] + half * ah])


@register_lowering("Proposal")
def _lower_proposal(node, inputs, params, ctx):
    """RPN proposal generation (py-faster-rcnn proposal_layer.py): decode
    the deltas on the shifted anchors (+1 width convention; ``exp`` of a
    delta past f32's range is inf, and the clip takes the box to the
    image's edge), clip to ``im_info``'s [h, w, scale] (kept f32), drop
    boxes under ``min_size * scale`` (score -inf), take the
    ``pre_nms_top_n`` best (ties by index), greedy NMS at ``nms_thresh``,
    and emit the ``post_nms_top_n`` best kept as (N * post_nms_top_n, 5)
    rows [image, x1, y1, x2, y2], image-major; a padding row has image -1
    and a zero box.  ``proposal_sort_payload`` picks a TPU form of the
    same rows."""
    a = node.attrs
    pre_n = int(a.get("pre_nms_top_n", 6000))
    post_n = int(a.get("post_nms_top_n", 300))
    nms_thresh = float(a.get("nms_thresh", 0.7))
    min_size = float(a.get("min_size", 16))
    scores, deltas, im_info = inputs
    dev = scores.device
    im_info = im_info.float()
    n, fh, fw, c2a = scores.shape
    A = c2a // 2
    if im_info.shape[0] != n:
        im_info = im_info[:1].expand(n, im_info.shape[-1])
    aw, ah, acx, acy = ctx.const(node, f"anchors/{fh}x{fw}",
                                 lambda: _anchor_geometry(node, fh, fw))
    # channels are Caffe-ordered [bg*A, fg*A]: the fg half
    fg = scores[..., A:].float().reshape(n, -1)
    dl = deltas.float().reshape(n, -1, 4)
    cx = fma(dl[..., 0], aw, acx)
    cy = fma(dl[..., 1], ah, acy)
    exp_c = ctx.const(node, "exp_f32", lambda: EXP_F32_CONSTS)
    w = exp_f32(dl[..., 2], exp_c) * aw
    h = exp_f32(dl[..., 3], exp_c) * ah
    half = ctx.const(node, "half", lambda: 0.5)
    im_h, im_w, im_scale = (im_info[:, i:i + 1] for i in range(3))
    zero = torch.zeros((), device=dev)
    one = ctx.const(node, "one", lambda: 1.0)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - one)

    boxes = torch.stack([clip(cx - half * w, im_w), clip(cy - half * h, im_h),
                         clip(cx + half * w, im_w), clip(cy + half * h, im_h)],
                        dim=-1)                          # (N, P, 4)
    ms = ctx.const(node, "min_size", lambda: min_size) * im_scale
    bw = boxes[..., 2] - boxes[..., 0] + one
    bh = boxes[..., 3] - boxes[..., 1] + one
    fg = torch.where((bw >= ms) & (bh >= ms), fg,
                     torch.full_like(fg, -float("inf")))
    K = min(pre_n, fg.shape[1])
    top, order = _stable_top(fg, K)
    b = _take_rows(boxes, order)                         # (N, K, 4)
    keep = greedy_nms(b, top > -float("inf"), nms_thresh, plus_one=1.0)
    sc = torch.where(keep, top, torch.full_like(top, -float("inf")))
    R = min(post_n, K)
    sc_top, ri = _stable_top(sc, R)
    good = torch.gather(keep, 1, ri) & (sc_top > -float("inf"))
    rois = torch.where(good[..., None], _take_rows(b, ri),
                       torch.zeros((), device=dev))
    if R < post_n:
        rois = torch.cat([rois, rois.new_zeros(n, post_n - R, 4)], dim=1)
        good = torch.cat([good, good.new_zeros(n, post_n - R)], dim=1)
    img = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    bidx = torch.where(good, img.expand(n, post_n),
                       torch.full((), -1.0, device=dev))
    return [torch.cat([bidx[..., None], rois], dim=-1).reshape(n * post_n,
                                                                5)]


def _roi_batch(rois, n):
    """Each ROI's image (column 0 truncated and clamped to [0, n - 1]) and
    whether it is a padding row (column 0 < 0)."""
    r = rois.float()
    return r, torch.clamp(r[:, 0].to(torch.int32), 0, n - 1).long(), \
        r[:, 0] < 0


@register_lowering("ROIPooling")
def _lower_roipool(node, inputs, params, ctx):
    """Fast R-CNN ROIPoolingLayer: each ROI rounded onto the feature grid
    (``floor(coord * spatial_scale + 0.5)``, Caffe's half-away round of
    these non-negative coordinates), split into pooled_h x pooled_w bins
    with the exact integer floor/ceil boundaries the reference uses,
    clipped to the map; the MAX of each bin in x's type, 0 for an empty
    bin and for a padding ROI.  The bins are taken as a running max over
    each bin's rows (at most the longest bin's length of steps), then over
    its columns.  ``roipool_table`` and ``roipool_full_pyramid`` pick TPU
    forms of the same values."""
    x, rois = inputs
    ph = int(node.attrs["pooled_h"])
    pw = int(node.attrs["pooled_w"])
    scale = ctx.const(node, "spatial_scale", lambda: float(
        node.attrs.get("spatial_scale", 1.0 / 16)))
    N, H, W, C = x.shape
    r, bidx, pad_roi = _roi_batch(rois, N)
    half = ctx.const(node, "half", lambda: 0.5)
    x1, y1, x2, y2 = (torch.floor(r[:, i] * scale + half) for i in range(1, 5))
    one = ctx.const(node, "one", lambda: 1.0)
    rw = torch.maximum(x2 - x1 + one, one)
    rh = torch.maximum(y2 - y1 + one, one)

    def bounds(start, length, bins, size):
        st = start.to(torch.int64)[:, None]
        ln = length.to(torch.int64)[:, None]
        i = torch.arange(bins, device=x.device)[None, :]
        lo = torch.div(i * ln, bins, rounding_mode="floor") + st
        hi = torch.div((i + 1) * ln + bins - 1, bins,
                       rounding_mode="floor") + st
        return lo.clamp(0, size), hi.clamp(0, size)

    lo_h, hi_h = bounds(y1, rh, ph, H)                    # (R, ph)
    lo_w, hi_w = bounds(x1, rw, pw, W)                    # (R, pw)
    fill = ctx.const(node, f"fill/{x.dtype}", lambda: -float("inf"), x.dtype)
    # the rows of each bin: (R, ph, W, C)
    span_h = int((hi_h - lo_h).max())
    rows = fill.expand(lo_h.shape + (W, C)).clone()
    for t in range(span_h):
        y = lo_h + t
        v = x[bidx[:, None], y.clamp(max=H - 1)]
        rows = torch.where((y < hi_h)[..., None, None],
                           torch.maximum(rows, v), rows)
    # then the columns: (R, ph, pw, C)
    span_w = int((hi_w - lo_w).max())
    out = fill.expand(lo_h.shape + (pw, C)).clone()
    for t in range(span_w):
        xc = lo_w + t                                     # (R, pw)
        v = torch.gather(rows, 2, xc.clamp(max=W - 1)[:, None, :, None]
                         .expand(-1, ph, -1, C))
        out = torch.where((xc < hi_w)[:, None, :, None],
                          torch.maximum(out, v), out)
    full = ((hi_h > lo_h)[:, :, None] & (hi_w > lo_w)[:, None, :]
            & ~pad_roi[:, None, None])
    return [torch.where(full[..., None], out, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))]


@register_lowering("PSROIPooling")
def _lower_psroipool(node, inputs, params, ctx):
    """R-FCN's position-sensitive ROI pooling (psroi_pooling_layer.cu):
    bin (i, j) of an ROI AVERAGES its window of channel group
    ``(c*k + i)*k + j``; empty bins 0.  The window boundaries in the
    reference's exact integers (coordinates rounded half away from zero,
    the extent clamped to 0.1 feature cell, in units of 1/(10*q*k) pixels
    for ``spatial_scale = 1/q``).  The sums are taken in f64 over the two
    axes' 0/1 masks and rounded once to f32, then divided by the bin's
    count in f32.  With ``fuse_ave`` (passes.fuse_psroi_ave) the masks are
    first divided by their counts in f32 and the k x k bins summed away,
    then divided by k^2: (R, 1, 1, C), as the reference's fused form."""
    x, rois = inputs
    k = int(node.attrs["group_size"])
    cdim = int(node.attrs["output_dim"])
    scale = float(node.attrs.get("spatial_scale", 1.0 / 16))
    q = int(round(1.0 / scale))
    if abs(1.0 / scale - q) > 1e-4:
        raise NotImplementedError(
            f"{node.name}: spatial_scale {scale} is not 1/int")
    N, H, W, _ = x.shape
    dev = x.device
    r, bidx, pad_roi = _roi_batch(rois, N)
    half, one_half = (ctx.const(node, k, lambda v=v: v)
                      for k, v in (("half", 0.5), ("one_half", 1.5)))
    sx = torch.floor(r[:, 1] + half).to(torch.int64)
    sy = torch.floor(r[:, 2] + half).to(torch.int64)
    ex = torch.floor(r[:, 3] + one_half).to(torch.int64)
    ey = torch.floor(r[:, 4] + one_half).to(torch.int64)
    lx = torch.clamp_min(10 * (ex - sx), q)
    ly = torch.clamp_min(10 * (ey - sy), q)
    u = 10 * k * q

    def masks(s, ln, size, offset=None):
        i = torch.arange(k, device=dev)[None, :]
        lo = torch.div(i * ln[:, None] + 10 * k * s[:, None], u,
                       rounding_mode="floor").clamp(0, size)
        hi = torch.div((i + 1) * ln[:, None] + 10 * k * s[:, None] + u - 1,
                       u, rounding_mode="floor").clamp(0, size)
        if offset is not None:      # rows of the image, on the N*H axis
            lo = torch.where(pad_roi[:, None], 0, lo + offset[:, None])
            hi = torch.where(pad_roi[:, None], 0, hi + offset[:, None])
            size = N * size
        pos = torch.arange(size, device=dev)
        return ((pos >= lo[..., None]) & (pos < hi[..., None])).float()

    mh = masks(sy, ly, H, bidx * H)                       # (R, k, N*H)
    mw = masks(sx, lx, W)                                 # (R, k, W)
    R = mh.shape[0]
    fused = bool(node.attrs.get("fuse_ave"))
    if fused:
        mh = mh / torch.clamp_min(mh.sum(-1), 1.0)[..., None]
        mw = mw / torch.clamp_min(mw.sum(-1), 1.0)[..., None]
    # x's channels (c*k + i)*k + j -> (i, N*H, W * j * c), in f64
    xs = x.double().reshape(N * H, W, cdim, k, k).permute(3, 0, 1, 4, 2)
    t = torch.bmm(mh.double().transpose(0, 1),
                  xs.reshape(k, N * H, W * k * cdim))   # (i, R, W*j*c)
    t = t.reshape(k, R, W, k, cdim).permute(1, 3, 2, 0, 4).reshape(
        R * k, W, k * cdim)                               # (r*j, W, i*c)
    ssum = torch.bmm(mw.double().reshape(R * k, 1, W), t).reshape(
        R, k, k, cdim).transpose(1, 2)                    # (R, i, j, C)
    if fused:
        s_ = ssum.sum(dim=(1, 2)).float()
        return [(s_ / ctx.const(node, "bins", lambda: float(k * k)))[
            :, None, None, :].to(x.dtype)]
    s_ = ssum.float()
    count = mh.sum(-1)[:, :, None] * mw.sum(-1)[:, None, :]
    out = torch.where(count[..., None] > 0,
                      s_ / torch.clamp_min(count, 1.0)[..., None],
                      torch.zeros((), device=dev))
    return [out.to(x.dtype)]


@register_lowering("Slice")
def _lower_slice(node, inputs, params, ctx):
    x = inputs[0]
    axis = node.attrs.get("axis", -1) % x.dim()
    total = x.shape[axis]
    points = list(node.attrs.get("slice_points", []))
    if not points:
        k = len(node.outputs)
        points = [total // k * i for i in range(1, k)]
    bounds = [0] + points + [total]
    sizes = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]
    return list(torch.split(x, sizes, dim=axis))


@register_lowering("Softmax")
def _lower_softmax(node, inputs, params, ctx):
    axis = node.attrs.get("axis", -1)
    return [torch.softmax(inputs[0].float(), dim=axis).to(inputs[0].dtype)]


@register_lowering("Flatten")
def _lower_flatten(node, inputs, params, ctx):
    x = inputs[0]
    return [x.reshape(x.shape[0], -1)]


@register_lowering("Reshape")
def _lower_reshape(node, inputs, params, ctx):
    shape = list(node.attrs["shape"])
    for i, d in enumerate(shape):
        if d == 0:   # Caffe ReshapeLayer: copy the input dim
            shape[i] = inputs[0].shape[i]
    return [inputs[0].reshape(shape)]


@register_lowering("Dropout")
def _lower_dropout(node, inputs, params, ctx):
    return [inputs[0]]


@register_lowering("Split")
def _lower_split(node, inputs, params, ctx):
    return [inputs[0] for _ in node.outputs]


# ----------------------------------------------------------------------
# Sharded lowering (parallel/): what GSPMD inserts in the reference
# ----------------------------------------------------------------------

# Ops whose output rows read only the same rows of their inputs: under
# shard_spatial they run on this rank's rows.  Concat, Slice and Softmax
# join them when their axis is the channels.
_ROW_LOCAL = frozenset({
    "ReLU", "ReLU6", "Eltwise", "Sigmoid", "Scale", "Axpy", "Bias",
    "BatchNorm", "PReLU", "TanH", "ELU", "AbsVal", "Exp", "Log", "BNLL",
    "Power", "Threshold", "Dropout", "Split", "ShuffleChannel"})
_CHANNEL_AXIS_OPS = frozenset({"Concat", "Slice", "Softmax"})


def _model_group(ctx):
    return ctx.mesh.groups[ctx.config.sharding.model_axis]


def takes_ring(node: Node, x: torch.Tensor, ctx) -> bool:
    """True when TP node ``node`` reads ``x``, this rank's channel slice of
    a TP node's output (its K chunk), through the ring collective matmul
    (``ShardingConfig.ring_overlap``): an InnerProduct on a 2-D or 1x1
    input, or a 1x1 stride-1 unpadded ungrouped conv without
    ``act_segments``.  The ring then takes the place of ``x``'s all-gather
    (``gather_channels``), as it takes GSPMD's in the reference.  The
    reference takes the ring off its Pallas branch only, so on the "cuda"
    backend ``x`` is gathered and the kernels run on column slices."""
    if (ctx.backend == "cuda" or not ctx.config.sharding.ring_overlap
            or node.name not in ctx.tp):
        return False
    if node.op == "InnerProduct":
        return (np.ndim(ctx.graph.params[node.params[0]]) == 2
                and (x.dim() == 2 or (x.dim() == 4
                                      and x.shape[1] * x.shape[2] == 1)))
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    return (node.op == "Convolution" and not node.attrs.get("act_segments")
            and group == 1 and dil == 1 and kh == kw == 1 and sh == sw == 1
            and ph == pw == 0)


def gather_channels(x: torch.Tensor, ctx) -> torch.Tensor:
    """A TP node's output from this rank's channel slice: all-gathered on
    channels in the model group."""
    from ..parallel.dist import all_gather
    return all_gather(x.contiguous(), x.dim() - 1, _model_group(ctx))


def _ring_chunk(ctx, node: Node, k_x: int, k_w: int) -> bool:
    """True when ``x`` (K ``k_x``) is this rank's K chunk of the ``k_w``
    rows ``node``'s weight contracts: the engine handed it ungathered
    because ``takes_ring`` admitted the node."""
    return (node.name in ctx.tp
            and k_x * ctx.mesh.shape[ctx.config.sharding.model_axis] == k_w)


def _ring_tp_matmul(ctx, xm, wm, bias):
    """(M, K/n) this rank's K chunk @ (K, N/n) through
    ``parallel.overlap.allgather_matmul`` in its ``w_sharded_out`` form:
    the chunks go round the model group's ring while the chunks that
    arrived are multiplied; returns f32 (the caller applies activation and
    dtype)."""
    from ..parallel.overlap import allgather_matmul
    b32 = bias.float() if bias is not None else None
    return allgather_matmul(_model_group(ctx), xm.float().contiguous(),
                            wm.float(), bias=b32, w_sharded_out=True)


def _row_shard(x: torch.Tensor, ctx) -> torch.Tensor:
    n = ctx.mesh.shape[ctx.config.sharding.model_axis]
    me = ctx.mesh.coords[ctx.config.sharding.model_axis]
    step = x.shape[1] // n
    return x[:, me * step:(me + 1) * step]


def _halo_node(node: Node, ctx) -> Node:
    """The node as each rank runs it on its halo-extended rows: no pad in
    H (the halo and the edge ranks' zero rows are the padding)."""
    mine = ctx._halo_nodes.get(node.name)
    if mine is None:
        pw = conv_hparams(node)[5]
        mine = Node(name=node.name, op=node.op, inputs=node.inputs,
                    outputs=node.outputs, params=node.params,
                    attrs={**node.attrs, "pad_h": 0, "pad_w": pw})
        ctx._halo_nodes[node.name] = mine
    return mine


def _spatial_conv_ok(node: Node, h_local: int) -> bool:
    """A conv over rows split on the model axis runs as
    ``parallel.spatial.spatial_conv2d`` when each shard is phase-aligned
    (``h_local`` a multiple of the stride), undilated, its output H is
    H/stride (``KH - stride <= 2 pad <= KH - 1``) and its halos come from
    the neighbours alone.  Any other conv gathers H first (the port's form
    of the reference's ``_spatial_small_h_fix``)."""
    from ..parallel.spatial import halo_rows
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    lo, hi = halo_rows(kh, sh, ph)
    return (node.op == "Convolution" and dil == 1 and h_local % sh == 0
            and kh - sh <= 2 * ph <= kh - 1 and lo <= h_local
            and hi <= h_local)


def _row_local(node: Node, inputs) -> bool:
    if node.op in _ROW_LOCAL:
        return True
    if node.op in _CHANNEL_AXIS_OPS and inputs[0].dim() == 4:
        return node.attrs.get("axis", -1) % 4 == 3
    return False


def lower_sharded(node: Node, inputs, params, ctx: LoweringCtx, layouts):
    """Lower ``node`` on a rank of a mesh.  ``layouts[i]`` says what input i
    holds beside this rank's batch slice under DP: ``"rows"`` its rows of
    H (spatial mode), ``"chans"`` its K chunk of a TP node's output (only
    as the first input of a node that ``takes_ring``: the engine gathers
    such a value, ``gather_channels``, before any other reader), None the
    whole value.  Returns (outputs, their layouts).

    - A TP node (``ctx.tp``) computes its output-channel slice, ``"chans"``
      (a depthwise conv on the input channels it reads).
    - Spatial: a conv over split rows that ``_spatial_conv_ok`` admits
      exchanges halos and runs on its rows; a row-local op runs on its
      rows (a whole input of the same H sliced to them, an H of 1
      broadcast); every other node gathers H first, and each rank-4
      output whose H divides the model axis is sliced back to its rows."""
    from ..parallel.dist import all_gather
    if node.name in ctx.tp:
        reads = ctx.tp[node.name][2]
        if reads is not None:
            inputs = ([inputs[0][..., reads[0]:reads[1]].contiguous()]
                      + list(inputs[1:]))
        return lower_node(node, inputs, params, ctx), ["chans"]
    rows = [lay == "rows" for lay in layouts]
    scfg = ctx.config.sharding
    n = ctx.mesh.shape[scfg.model_axis]
    if not (scfg.shard_spatial and n > 1):
        return lower_node(node, inputs, params, ctx), [None] * len(
            node.outputs)
    if rows and rows[0] and _spatial_conv_ok(node, inputs[0].shape[1]):
        from ..parallel.spatial import halo_exchange, halo_rows
        kh, _, sh, _, ph, _, _, _ = conv_hparams(node)
        h_local = inputs[0].shape[1]
        xh = halo_exchange(inputs[0].contiguous(), _model_group(ctx),
                           *halo_rows(kh, sh, ph))
        (y,) = lower_node(_halo_node(node, ctx), [xh] + list(inputs[1:]),
                          params, ctx)
        return [y[:, :h_local // sh]], ["rows"]
    if any(rows) and _row_local(node, inputs):
        h = next(x.shape[1] for x, r in zip(inputs, rows) if r)
        aligned = []
        for x, r in zip(inputs, rows):
            if r or x.dim() != 4 or x.shape[1] == 1:
                aligned.append(x)
            elif x.shape[1] == h * n:
                aligned.append(_row_shard(x, ctx))
            else:
                break
        if len(aligned) == len(inputs):
            outs = lower_node(node, aligned, params, ctx)
            return outs, ["rows" if o.dim() == 4 else None for o in outs]
    group = _model_group(ctx)
    whole = [all_gather(x.contiguous(), 1, group) if r else x
             for x, r in zip(inputs, rows)]
    outs, out_layouts = [], []
    for y in lower_node(node, whole, params, ctx):
        split = y.dim() == 4 and y.shape[1] % n == 0
        outs.append(_row_shard(y, ctx) if split else y)
        out_layouts.append("rows" if split else None)
    return outs, out_layouts
