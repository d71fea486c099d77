"""Per-op lowering: IR node -> PyTorch ops on NHWC tensors.

Counterpart of ``feathercnn_tpu/ops/lowering.py``.  Two backends share this
module, as there:

  - "torch": every op is plain PyTorch (the float oracle; int8 weights and
    int8 edges are dequantized first, as the reference's "xla" does).
  - "cuda":  Convolution, InnerProduct, FusedBottleneck and FusedChain go
    through kernels/dispatch.py to the hand-written kernels (their plain
    versions on CPU tensors) or, for the "winograd" and "dot1x1" algos,
    to plain PyTorch as the reference's are plain jnp; the rest stays
    plain PyTorch.

An op with no lowering here raises ``NotImplementedError`` naming it
(``lower_node``): among the reference's, for example Deconvolution, the
detection ops, SpaceToDepth, the ladder ops of ``concat_dus``, and PReLU,
TanH, ELU, AbsVal, Exp, Log, BNLL, Power, MVN, Tile, Reduction and
Threshold, which no zoo builder uses.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ir import Graph, Node, conv_out_dim

__all__ = ["LoweringCtx", "lower_node", "register_lowering",
           "apply_activation", "apply_act_segments", "conv_hparams"]


class LoweringCtx:
    """Carried through lowering: config, graph, device, per-node quant
    metadata, and the device copies of per-node constants (scales, clamp
    bounds) made once and reused every forward."""

    def __init__(self, graph: Graph, config, device: torch.device):
        self.graph = graph
        self.config = config
        self.device = device
        self._consts: Dict[tuple, torch.Tensor] = {}

    @property
    def backend(self) -> str:
        return self.config.backend

    def qinfo(self, node: Node) -> Optional[Dict[str, Any]]:
        return self.graph.meta.get("quant", {}).get(node.name)

    def const(self, node: Node, key: str, make: Callable[[], Any]
              ) -> torch.Tensor:
        """Device float32 tensor for ``make()`` (an array or a number),
        built on first use for (node, key)."""
        return self.kept(node, key, lambda: torch.as_tensor(
            np.asarray(make(), np.float32), device=self.device))

    def kept(self, node: Node, key: str,
             make: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The tensor ``make()`` returns, made on first use for (node, key)
        and kept."""
        k = (node.name, key)
        t = self._consts.get(k)
        if t is None:
            t = self._consts[k] = make()
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


def apply_activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """Fused epilogue activations."""
    if act is None:
        return x
    if act == "relu":
        return torch.clamp_min(x, 0)
    if act == "relu6":
        return torch.clamp(x, 0, 6)
    raise ValueError(f"unknown activation {act!r}")


def act_segment_bounds(segments):
    """Per-output-channel (lo, hi) clamp bounds of merged sibling convs:
    relu -> [0, inf), relu6 -> [0, 6], none -> (-inf, inf)."""
    lo = np.concatenate([
        np.full(c, 0.0 if a in ("relu", "relu6") else -np.inf, np.float32)
        for a, c in segments])
    hi = np.concatenate([
        np.full(c, 6.0 if a == "relu6" else np.inf, np.float32)
        for a, c in segments])
    return lo, hi


def apply_act_segments(y: torch.Tensor, segments) -> torch.Tensor:
    """Per-output-channel activation for horizontally merged convs
    (passes.merge_sibling_convs), as one clamp.  ``y`` must be float
    (pre-requant)."""
    lo, hi = act_segment_bounds(segments)
    lo = torch.as_tensor(lo, device=y.device)
    hi = torch.as_tensor(hi, device=y.device)
    return torch.minimum(torch.maximum(y, lo), hi)


def scalar(v: float, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``: arithmetic with it rounds like
    the reference's f32 arithmetic with a Python float (CUDA replaces a
    division by a host scalar with a multiply by its reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(round_half_even(x / scale), -127, 127)`` as int8."""
    if not torch.is_tensor(scale):
        scale = scalar(scale, x.device)
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def nchw_conv(x: torch.Tensor, w: torch.Tensor, stride, padding,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC x (..., C) with HWIO w -> NHWC result of ``F.conv2d`` in the
    inputs' dtype (the NHWC storage is used as channels-last memory)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


# ----------------------------------------------------------------------
# Convolution family
# ----------------------------------------------------------------------

def _dequant_for_oracle(x, w, q, node, ctx):
    """The "torch" backend is the float oracle: int8 weights and int8 edges
    are dequantized here, as the reference's "xla" backend does."""
    if x.dtype == torch.int8:
        xs = (q.get("x_scale") or q.get("input_scale", 1.0)) if q else 1.0
        x = (x.float() * scalar(xs, x.device)).to(
            getattr(torch, ctx.config.compute_dtype))
    if w.dtype == torch.int8:
        ws = ctx.const(node, "w_scale", lambda: q["w_scale"]) \
            if q is not None else 1.0
        w = (w.float() * ws).to(x.dtype)
    else:
        w = w.to(x.dtype)
    return x, w


def conv_hparams(node: Node):
    a = node.attrs
    kh = a.get("kernel_h", a.get("kernel_size", 1))
    kw = a.get("kernel_w", a.get("kernel_size", 1))
    sh = a.get("stride_h", a.get("stride", 1))
    sw = a.get("stride_w", a.get("stride", 1))
    ph = a.get("pad_h", a.get("pad", 0))
    pw = a.get("pad_w", a.get("pad", 0))
    dil = a.get("dilation", 1)
    group = a.get("group", 1)
    return kh, kw, sh, sw, ph, pw, dil, group


@register_lowering("Convolution")
def _lower_conv(node, inputs, params, ctx):
    x = inputs[0]
    w = params[0]  # HWIO (H, W, Cin/group, Cout)
    bias = params[1] if node.attrs.get("bias_term", True) and len(params) > 1 \
        else None
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    act = node.attrs.get("activation")

    if ctx.backend == "cuda":
        from ..kernels import dispatch as kdispatch
        return [kdispatch.conv_forward(node, x, w, bias, ctx)]

    x, w = _dequant_for_oracle(x, w, ctx.qinfo(node), node, ctx)
    y = nchw_conv(x.float(), w.float(), (sh, sw), (ph, pw), dil, group)
    if bias is not None:
        y = y + bias
    segs = node.attrs.get("act_segments")
    y = apply_act_segments(y, segs) if segs else apply_activation(y, act)
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
        from ..kernels import dispatch as kdispatch
        return [kdispatch.fc_forward(node, x, w, bias, ctx)]

    x, w = _dequant_for_oracle(x, w, ctx.qinfo(node), node, ctx)
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias
    y = apply_activation(y, act)
    return [y.to(x.dtype)]


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
        s = (q["x_scale"] if x.dtype == torch.int8 else 1.0) / q["y_scale"]
        return torch.clamp(torch.round(avg_f32 * scalar(s, x.device)),
                           -127, 127).to(torch.int8)

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
        s = scalar(q["x_scale"] / q["y_scale"], x.device) / denom
        return [torch.clamp(torch.round(y.float() * s), -127, 127).to(
            torch.int8)]
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
        return [torch.where(x > 0, x, x * slope)]
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
        # first operand's product when it is one, else the second's.
        terms = []
        for x, s in zip(inputs, q["in_scales"]):
            terms.append((x.float(), scalar(s, x.device))
                         if x.dtype == torch.int8 else (x.float(), None))
        acc = _sum_terms(terms)
        acc = apply_activation(acc, node.attrs.get("activation"))
        return [quantize(acc, scalar(q["y_scale"], acc.device))]
    if op == "SUM":
        coeffs = node.attrs.get("coeffs")
        if coeffs:
            y = sum(c * x for c, x in zip(coeffs, inputs))
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


def _sum_terms(terms):
    """Left-to-right sum of ``x*s`` terms (s None: plain ``x``), fusing a
    product into the add that consumes it: ``a*s + t`` and ``t + b*s`` are
    single-rounding FMAs (torch.addcmul), preferring the left operand."""
    (x0, s0), rest = terms[0], terms[1:]
    if not rest:
        return x0 * s0 if s0 is not None else x0
    (x1, s1), rest = rest[0], rest[1:]
    if s0 is not None:
        acc = torch.addcmul(x1 * s1 if s1 is not None else x1, x0, s0)
    else:
        acc = torch.addcmul(x0, x1, s1) if s1 is not None else x0 + x1
    for x, s in rest:
        acc = torch.addcmul(acc, x, s) if s is not None else acc + x
    return acc


@register_lowering("Concat")
def _lower_concat(node, inputs, params, ctx):
    axis = node.attrs.get("axis", -1)
    q = ctx.qinfo(node)
    if q is not None and q.get("concat_int8"):
        # requantizing concat (quant/rewrite.py): each operand arrives int8
        # at its own calibrated scale (rescaled: round(x * (s / y))) or
        # float (quantized: round(x / y)); the output carries one scale
        y = q["y_scale"]
        parts = []
        for x, s in zip(inputs, q["in_scales"]):
            if x.dtype == torch.int8:
                if s is not None and s != y:
                    x = torch.clamp(torch.round(
                        x.float() * scalar(s / y, x.device)), -127, 127).to(
                            torch.int8)
                parts.append(x)
            else:
                parts.append(quantize(x, y))
        return [torch.cat(parts, dim=axis)]
    # float, or the single-scale int8 passthrough
    return [torch.cat(inputs, dim=axis)]


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
    if rq and x.dtype == torch.int8:
        xf = x.float() * scalar(q["x_scale"], x.device)
    else:
        xf = x.float()
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
    b = torch.addcmul(scalar(k, xf.device), ssum, scalar(alpha / n,
                                                         xf.device))
    if beta == 0.75:
        r = 1.0 / torch.sqrt(b)
        scl = r * torch.sqrt(r)
    elif beta == 0.5:
        scl = 1.0 / torch.sqrt(b)
    else:
        scl = torch.pow(b, -beta)
    y = xf * scl
    if rq:
        return [quantize(y, q["y_scale"])]
    return [y.to(x.dtype)]


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
        xf = (x.float() * scalar(q["x_scale"], x.device)
              if x.dtype == torch.int8 else x.float())
        if bias and len(params) > 1:
            y = torch.addcmul(params[1].float(), xf, params[0].float())
        else:
            y = xf * params[0].float()
        return [quantize(apply_activation(y, act), q["y_scale"])]
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
        xf = (x.float() * scalar(sx, x.device) if x.dtype == torch.int8
              else x.float())
        yf = (y.float() * scalar(sy, y.device) if y.dtype == torch.int8
              else y.float())
        out = torch.addcmul(yf, s, xf)
        return [quantize(apply_activation(out, act), q["y_scale"])]
    out = torch.addcmul(y.float(), s, x.float())
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
# Region fusion (passes_fusion.py): identity bottlenecks
# ----------------------------------------------------------------------

def _run_chain(node, ctx, x, w1, b1, w2, b2, w3, b3, w_scales=None,
               scales=None):
    """``fused_chain`` as the reference's lowerings call it: the int8 mode
    where ``scales`` are given (a float ``x`` quantized first, with a
    divide by ``sx[0]``), else the float mode with the weights cast to x's
    type.  The weights go in the kernel's layout, made once per node.
    Through the dispatcher on the "cuda" backend (``fused_chain`` for the
    int8 mode, ``fused_chain_float`` for the float mode: the kernel, or its
    plain version on CPU tensors); the plain version on "torch"."""
    from ..kernels.fused_chain import fused_chain_plain, kernel_layout
    if scales is not None:
        if x.dtype != torch.int8:
            x = quantize(x, scales[0][0])
        kwargs = dict(w_scales=w_scales, scales=scales)
    else:
        kwargs = {}
    wdt = torch.int8 if scales is not None else x.dtype
    w1, w2, w3 = (ctx.kept(node, f"{k}/{wdt}",
                           lambda w=w: kernel_layout(w.to(wdt)))
                  for k, w in (("w1", w1), ("w2", w2), ("w3", w3)))
    args = (x.contiguous(), w1, b1, w2, b2, w3, b3)
    if ctx.backend == "cuda":
        from ..kernels import dispatch as kdispatch
        if scales is None:
            return kdispatch.fused_chain_float(*args)
        return kdispatch.fused_chain(*args, **kwargs)
    return fused_chain_plain(*args, **kwargs)


@register_lowering("FusedBottleneck")
def _lower_fused_block(node, inputs, params, ctx):
    """One identity bottleneck: a 1-block chain (kernels/fused_chain)."""
    w1, b1, w2, b2, w3, b3 = params
    # Graph weights are HWIO; the chain function wants stacked matrices.
    c, cm = w1.shape[-2], w1.shape[-1]
    weights = (w1.reshape(1, c, cm), b1.reshape(1, -1),
               w2.reshape(1, 9 * cm, cm), b2.reshape(1, -1),
               w3.reshape(1, cm, c), b3.reshape(1, -1))
    q = ctx.qinfo(node)
    if not (node.attrs.get("quant") and q is not None):
        return [_run_chain(node, ctx, inputs[0], *weights)]
    ws = tuple(ctx.const(node, f"w{i + 1}s",
                         lambda s=s: np.asarray(s).reshape(1, -1))
               for i, s in enumerate(q["w_scales"]))
    a = node.attrs
    scales = ((a["s_x"],), (a["s_y1"],), (a["s_y2"],), a.get("s_out"))
    return [_run_chain(node, ctx, inputs[0], *weights, w_scales=ws,
                       scales=scales)]


@register_lowering("FusedChain")
def _lower_fused_chain(node, inputs, params, ctx):
    """Chained identity bottlenecks (passes_fusion.fuse_chains ->
    kernels/fused_chain)."""
    q = ctx.qinfo(node)
    if not (node.attrs.get("quant") and q is not None):
        return [_run_chain(node, ctx, inputs[0], *params)]
    ws = tuple(ctx.const(node, k, lambda k=k: q[k])
               for k in ("w1s", "w2s", "w3s"))
    a = node.attrs
    scales = (a["sx"], a["sy1"], a["sy2"], a.get("s_out"))
    return [_run_chain(node, ctx, inputs[0], *params, w_scales=ws,
                       scales=scales)]


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
