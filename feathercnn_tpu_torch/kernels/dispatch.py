"""Per-layer kernel selection — counterpart of
``feathercnn_tpu/kernels/dispatch.py`` with the same branches in the same
order:

  depthwise      group == C_in           -> kernels/depthwise.py
                                            (depthwise_conv2d)
  gemm1x1        1x1 kernel              -> kernels/matmul.py
  implicit       kxk, stride 1-2, g=1    -> kernels/conv.py
  dot1x1         1x1, g=1 (override)     -> an explicit matrix product
                                            (the reference's XLA dot:
                                            torch._int_mm on the card for
                                            int8, exact int32 sums)
  winograd       3x3 s1 (override only)  -> kernels/winograd.py (plain
                                            torch ops, as the reference's
                                            is plain jnp)
  xla            everything else: the fp convs (PyTorch's conv, as the
                 reference leaves them to XLA's), and the int8 convs the
                 reference runs through XLA's int8 conv — the merged
                 sibling convs (per-channel act_segments), the convs at
                 a non-square stride, the grouped convs that are not
                 plain depthwise (3x3: as super-groups of q whole
                 groups, each 32-wide column tile reading its own 32
                 channels, on grouped_layout's compact weight; a 1x1
                 one, or one no q fits, on a block-diagonal weight) and
                 the dilated convs (the taps spaced by the dilation),
                 which go through the two GEMM kernels, and the plain
                 int8 depthwise convs, which go to kernels/depthwise.py
                 (depthwise_conv2d_int8), with the scales folded as that
                 branch folds them.

Like the reference, the dispatcher passes ``cin * group`` to select_algo
for a grouped conv, so the "depthwise" branch is reached only through
algo_overrides (ROADMAP.md, queue C).

EngineConfig.algo_overrides forces a choice per layer name.

Every "cuda" route of the lowering starts here: ``conv_forward``,
``fc_forward``, ``eltwise_forward`` (``eltwise_int8``, kernels/eltwise.py)
and ``chain_forward`` (``fused_chain`` and ``fused_chain_float``,
kernels/fused_chain.py); the boundary probe calls ``ident``
(kernels/ident.py).  Each kernel entry point is an attribute of this
module, looked up at each call.
The float branch sends an int8-emitting stem on C_in <= 4 channels to
``stem_conv_int8`` (kernels/stem.py) where ``takes_stem_kernel`` holds.

Where ``conv_forward`` picks a grouped conv's route (the super-group
kernel, the block-diagonal weight, a depthwise kernel or PyTorch's float
conv) it tells ``utils.profiling.grouped_route``, which records it inside
``profiling.record()`` and does nothing otherwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import (act_segment_bounds, apply_act_segments,
                        apply_activation, conv_hparams, dequantize,
                        quantize, reciprocal, requantize)
from ..utils.profiling import grouped_route
from . import eltwise, stem
from .conv import conv2d_implicit_gemm
from .depthwise import depthwise_conv2d, depthwise_conv2d_int8
from .eltwise import eltwise_int8, eltwise_int8_sum, takes_kernel
from .fused_chain import (fused_chain, fused_chain_float, fused_chain_plain,
                          kernel_layout)
from .ident import ident
from .matmul import gemm_layout, grouped_layout, matmul_epilogue, supergroup
from .stem import (stem_conv_int8, stem_conv_plain, stem_layout,
                   takes_stem_kernel)
from .winograd import (transform_matrices, transform_weights,
                       winograd_conv2d_transformed)

__all__ = ["select_algo", "block_diagonal", "segment_bounds",
           "conv_forward", "fc_forward",
           "eltwise_forward", "chain_forward", "fused_chain",
           "fused_chain_float", "ident", "eltwise_int8", "stem_conv_int8"]


def select_algo(node, cin: int, quant: bool) -> str:
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    if group == cin and group > 1:
        return "depthwise"
    if group != 1 or dil != 1 or sh != sw:
        return "xla"
    if kh == 1 and kw == 1:
        return "gemm1x1" if quant else "xla"
    if quant and sh in (1, 2) and cin >= 16:
        return "implicit"
    return "xla"


def _dequant_weight(w, q, dtype, node, ctx):
    if w.dtype == torch.int8 and q is not None:
        return (w.float() * ctx.const(node, "w_scale", lambda: q["w_scale"])
                ).to(dtype)
    return w.to(dtype)


def block_diagonal(w: torch.Tensor, group: int) -> torch.Tensor:
    """A grouped conv's HWIO weight (KH, KW, C/group, Co) as the dense
    (KH, KW, C, Co) weight of the same conv: output channel o of group
    j = o // (Co/group) keeps its weights on input channels
    j*(C/group) .. (j+1)*(C/group) - 1 and is zero on every other."""
    kh, kw, cg, co = w.shape
    cog = co // group
    dense = w.new_zeros((kh, kw, cg * group, co))
    for j in range(group):
        dense[:, :, j * cg:(j + 1) * cg, j * cog:(j + 1) * cog] = \
            w[..., j * cog:(j + 1) * cog]
    return dense


def _gemm_weight(node, w, dtype, ctx, matrix: bool, group: int = 1,
                 q: int = 0):
    """The node's weight as ``dtype`` in the GEMM kernels' layout
    (``gemm_layout``): a 1x1 or FC weight as its (K, N) matrix, a kxk one
    HWIO; a grouped conv's (``group`` > 1) compacted to super-groups of
    ``q`` groups by ``grouped_layout``, or, at ``q`` 0, made dense
    by :func:`block_diagonal`; made once per node, kept under
    ``gemm_w/<dtype>/<matrix|hwio>`` (``/g<group>q<q>`` for a grouped
    conv's)."""
    def make():
        if group > 1 and q:
            return grouped_layout(w.to(dtype), group, q)
        wd = block_diagonal(w, group) if group > 1 else w
        return gemm_layout((wd.reshape(wd.shape[-2], -1) if matrix else wd)
                           .to(dtype))
    key = f"gemm_w/{dtype}/{'matrix' if matrix else 'hwio'}"
    return ctx.kept(node, key + (f"/g{group}q{q}" if group > 1 else ""),
                    make)


def _int8_product(node, x2, w2):
    """The exact int32 product of the int8 (M, K) ``x2`` and (K, N) ``w2``,
    as f32 (the reference's ``preferred_element_type=int32`` dot, then its
    f32 cast): the int8 grids in float64 on the CPU (|acc| <= 127^2 K is
    exact there), ``torch._int_mm`` on the card where its shape rules hold
    (M > 16, K and N multiples of 8); any other shape raises."""
    if x2.device.type == "cpu":
        return (x2.double() @ w2.double()).float()
    m, k = x2.shape
    n = w2.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"{node.name}: dot1x1's int8 product on the card "
                         f"needs M > 16 and K, N multiples of 8 "
                         f"(torch._int_mm), got M={m} K={k} N={n}")
    return torch._int_mm(x2, w2).float()


def _quantize_act(x, x_scale):
    """A float ``x`` quantized at the node's kept ``x_scale`` (a
    ``numerics.Scale``); an int8 edge, which its producer requantized, as
    it is."""
    if x.dtype == torch.int8:
        return x
    return quantize(x, x_scale)


def _x_scale(node, q, ctx):
    return ctx.scale(node, "x_scale", q["x_scale"])


def _out_dtype(x, q):
    """int8 when the int8-edge pass marked this node, else the float
    compute dtype."""
    if q is not None and q.get("emit_int8"):
        return torch.int8
    return torch.bfloat16 if x.dtype == torch.int8 else x.dtype


def _out_spec(node, x, q, ctx):
    """(out_dtype, out_scale) for the epilogue: :func:`_out_dtype`, and
    for int8 the node's kept ``1 / y_scale``."""
    out_dtype = _out_dtype(x, q)
    if out_dtype == torch.int8:
        return out_dtype, ctx.scale(node, "out_scale", 1.0 / q["y_scale"])
    return out_dtype, 1.0


def segment_bounds(node, segs, ctx):
    """The kept (lo, hi) clamp of merged sibling convs' ``segs``."""
    return (ctx.const(node, "seg_lo", lambda: act_segment_bounds(segs)[0]),
            ctx.const(node, "seg_hi", lambda: act_segment_bounds(segs)[1]))


def _is_depthwise(node, x, group, dil, sh, sw) -> bool:
    """The case both depthwise kernels take: group == C_in == num_output
    (channel multiplier 1), no dilation, a square stride of 1 or 2."""
    return (group == x.shape[-1] and node.attrs["num_output"] == group
            and dil == 1 and sh == sw and sh in (1, 2))


def _pointwise_input(x, sh, sw, ph, pw):
    """The (N*OH*OW, C) matrix a 1x1 conv multiplies: pad, then take every
    stride-th pixel (conv semantics), contiguous for the kernel."""
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    if sh > 1 or sw > 1:
        x = x[:, ::sh, ::sw, :]
    n, oh, ow, c = x.shape
    return x.contiguous().reshape(n * oh * ow, c), (n, oh, ow)


def conv_forward(node, x, w, bias, ctx):
    kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(node)
    act = node.attrs.get("activation")
    segs = node.attrs.get("act_segments")
    q = ctx.qinfo(node)
    cdt = getattr(torch, ctx.config.compute_dtype)
    cin = x.shape[-1]
    # ``cin * group`` for a grouped conv, as the reference's dispatcher
    # passes it (feathercnn_tpu/kernels/dispatch.py:99-100): it defeats
    # select_algo's ``group == cin`` test, so a depthwise conv takes the
    # "xla" branch unless algo_overrides names it "depthwise".  Kept so that
    # both engines route every layer alike.
    algo = ctx.config.algo_for(node.name) or select_algo(
        node, cin * group if group > 1 else cin, q is not None)
    if segs is not None and algo != "dot1x1":
        # per-channel activation segments (merged sibling convs) take the
        # "xla" branch, as in the reference
        algo = "xla"

    if x.dtype == torch.int8 and (q is None or q.get("x_scale") is None):
        # int8-transferred input into an fp-act layer (input_scale) or a
        # stray int8 edge: dequantize once so every branch sees float
        x = ctx.dequantize_edge(node, x, cdt)

    if algo == "depthwise":
        if _is_depthwise(node, x, group, dil, sh, sw):
            # As the reference: an int8 edge is dequantized to the compute
            # dtype (here by the kernel as it loads it), the weight to f32,
            # and the result stays in the compute dtype even where the node
            # is marked emit_int8 (its consumer quantizes it again).
            wd = ctx.const(node, "w_f32", lambda: _dequant_weight(
                w, q, torch.float32, node, ctx).reshape(kh, kw, -1).cpu())
            kwargs = {}
            if x.dtype == torch.int8:
                kwargs = dict(x_scale=_x_scale(node, q, ctx), out_dtype=cdt)
            grouped_route(node.name, "depthwise")
            return depthwise_conv2d(x.contiguous(), wd, bias, stride=sh,
                                    pad_h=ph, pad_w=pw, activation=act,
                                    **kwargs)
        algo = "xla"

    if algo == "gemm1x1" and kh == 1 and kw == 1:
        x2, (n, oh, ow) = _pointwise_input(x, sh, sw, ph, pw)
        kwargs = {}
        wdt = x2.dtype
        if q is not None and w.dtype == torch.int8:
            kwargs["w_scale"] = ctx.const(node, "w_scale",
                                          lambda: q["w_scale"])
            if q.get("x_scale") is not None:
                kwargs["x_scale"] = _x_scale(node, q, ctx)
                x2 = _quantize_act(x2, kwargs["x_scale"])
            wdt = torch.int8
        out_dtype, out_scale = _out_spec(node, x, q, ctx)
        y = matmul_epilogue(x2, _gemm_weight(node, w, wdt, ctx, True), bias,
                            activation=act, out_dtype=out_dtype,
                            out_scale=out_scale, **kwargs)
        return y.reshape(n, oh, ow, -1)

    if algo == "dot1x1" and kh == 1 and kw == 1 and group == 1:
        # a 1x1 conv as an explicit matrix product (the reference's XLA
        # dot), with the segments or activation in its own epilogue
        x2, (n, oh, ow) = _pointwise_input(x, sh, sw, ph, pw)
        if (q is not None and w.dtype == torch.int8
                and q.get("x_scale") is not None):
            x2 = _quantize_act(x2, _x_scale(node, q, ctx))
            acc = _int8_product(node, x2, _gemm_weight(node, w, torch.int8,
                                                       ctx, True))
            y = acc * ctx.const(node, "w_scale_x_scale",
                                lambda: np.asarray(q["w_scale"], np.float32)
                                * np.float32(q["x_scale"]))
        else:
            x2 = ctx.dequantize_edge(node, x2, cdt)
            wd = _dequant_weight(w, q, x2.dtype, node, ctx)
            y = x2.float() @ wd.reshape(x2.shape[1], -1).float()
        if bias is not None:
            y = y + bias
        y = apply_act_segments(y, *segment_bounds(node, segs, ctx)) \
            if segs is not None else apply_activation(y, act)
        out_dtype, out_scale = _out_spec(node, x, q, ctx)
        if out_dtype == torch.int8:
            y = requantize(y, out_scale)
        return y.to(out_dtype).reshape(n, oh, ow, -1)

    if algo == "winograd":
        if kh == 3 and kw == 3 and sh == sw == 1 and dil == 1 and group == 1:
            out_dtype = _out_dtype(x, q)
            if out_dtype == torch.int8:   # the winograd path keeps float edges
                out_dtype = (torch.bfloat16 if x.dtype != torch.float32
                             else torch.float32)
            if x.dtype == torch.int8:
                x = dequantize(x, _x_scale(node, q, ctx)).to(torch.bfloat16)
            # the weight transform of the dequantized weight, once per node
            v = ctx.kept(node, "winograd_v", lambda: transform_weights(
                _dequant_weight(w, q, torch.float32, node, ctx)))
            mats = ctx.kept(node, "winograd_mats",
                            lambda: transform_matrices(ctx.device))
            return winograd_conv2d_transformed(x, v, bias, pad_h=ph,
                                               pad_w=pw, activation=act,
                                               out_dtype=out_dtype, mats=mats)
        algo = "xla"

    if algo == "implicit":
        kwargs = {}
        xs = x
        if q is not None and w.dtype == torch.int8:
            kwargs["w_scale"] = ctx.const(node, "w_scale",
                                          lambda: q["w_scale"])
            if q.get("x_scale") is not None:
                kwargs["x_scale"] = _x_scale(node, q, ctx)
                xs = _quantize_act(x, kwargs["x_scale"])
            wk = _gemm_weight(node, w, torch.int8, ctx, False)
        else:
            wk = _gemm_weight(node, w, x.dtype, ctx, False)
        out_dtype, out_scale = _out_spec(node, x, q, ctx)
        return conv2d_implicit_gemm(xs.contiguous(), wk, bias, stride=sh,
                                    pad_h=ph, pad_w=pw, activation=act,
                                    out_dtype=out_dtype, out_scale=out_scale,
                                    **kwargs)

    # "xla" branch.
    if (q is not None and w.dtype == torch.int8
            and q.get("x_scale") is not None
            and (group == 1 or (ctx.config.int8_grouped and dil == 1))):
        # The reference runs XLA's int8 conv here, at any stride and any
        # feature_group_count: acc * (w_scale*x_scale) + bias, act or
        # act_segments, requant.  PyTorch has no int8 conv on CUDA, so the
        # port's kernels run it: the folded scale as w_scale with x_scale
        # 1.0 (one multiply, as the branch does), the segments as the GEMM
        # kernels' per-channel lo/hi clamp, a non-square stride as the
        # kernels' (sh, sw) (a 1x1 conv's input strided per axis).  Only
        # the plain depthwise conv (_is_depthwise) takes the depthwise
        # kernel.  Every other grouped conv (ResNeXt's cardinality-32
        # convs; a group = C conv at a channel multiplier above 1, a
        # stride above 2 or with act_segments) runs on
        # conv2d_implicit_gemm, a 3x3 one at a square stride as
        # super-groups of q whole groups (matmul.supergroup): each column
        # tile reads its own q*C/group = 32 input channels, the weight
        # compacted by grouped_layout, the zeros off each group adding
        # nothing to the int32 sums, so the result is XLA's grouped conv's.
        # Any other (a 1x1 one, C/g != Co/g, groups wider than 32
        # channels, a non-square stride) runs on its block-diagonal dense
        # weight (no zoo launch).  A dilated conv
        # (XLA's rhs_dilation: DeepLab's conv5 and fc6, PSPNet's stages 4-5)
        # is ungrouped here (the reference sends a grouped dilated one to
        # the float conv) and runs on conv2d_implicit_gemm with its taps
        # spaced by the dilation.
        depthwise = group != 1 and segs is None and _is_depthwise(
            node, x, group, dil, sh, sw)
        wg = 1 if depthwise else group
        stride = sh if sh == sw else (sh, sw)
        xq = _quantize_act(x, _x_scale(node, q, ctx))
        ws = ctx.const(node, "w_scale_x_scale",
                       lambda: np.asarray(q["w_scale"], np.float32)
                       * np.float32(q["x_scale"]))
        out_dtype, out_scale = _out_spec(node, x, q, ctx)
        if depthwise:
            grouped_route(node.name, "depthwise")
            return depthwise_conv2d_int8(
                xq.contiguous(), w.reshape(kh, kw, -1), bias, ws, stride=sh,
                pad_h=ph, pad_w=pw, activation=act, out_dtype=out_dtype,
                out_scale=out_scale)
        lo = hi = None
        if segs is not None:
            lo, hi = segment_bounds(node, segs, ctx)
            act = None
        kw_ = dict(activation=act, out_dtype=out_dtype, out_scale=out_scale,
                   lo=lo, hi=hi)
        if kh == 1 and kw == 1:
            if wg > 1:
                grouped_route(node.name, "block_diagonal")
            x2, (n, oh, ow) = _pointwise_input(xq, sh, sw, ph, pw)
            y = matmul_epilogue(x2, _gemm_weight(node, w, torch.int8, ctx,
                                                 True, wg), bias, ws, **kw_)
            return y.reshape(n, oh, ow, -1)
        q = supergroup(cin, w.shape[3], wg, (kh, kw), stride)[0] \
            if wg > 1 else 0
        if wg > 1:
            grouped_route(node.name, "supergroup" if q else "block_diagonal",
                          q)
        return conv2d_implicit_gemm(xq.contiguous(),
                                    _gemm_weight(node, w, torch.int8, ctx,
                                                 False, wg, q), bias, ws,
                                    stride=stride, pad_h=ph, pad_w=pw,
                                    dilation=dil, groups=wg, **kw_)

    # float conv (as the reference leaves it to XLA's): f32 accumulation
    # of compute-dtype operands, + bias, act, requant.  A stem on C_in <= 4
    # channels that emits int8 takes stem_conv_int8 (its weight dequantized
    # and laid out once per node); every other float conv PyTorch's
    # (stem_conv_plain), counted in stem_conv_int8.fallbacks where it is
    # such a stem that the kernel does not take.
    if group > 1:
        grouped_route(node.name, "float")
    x = ctx.dequantize_edge(node, x, cdt)
    out_dtype, out_scale = _out_spec(node, x, q, ctx)
    if out_dtype == torch.int8 and cin <= 4:
        wd = ctx.kept(node, "stem_w", lambda: _dequant_weight(
            w, q, x.dtype, node, ctx))
        if takes_stem_kernel(x, wd, (sh, sw), (ph, pw), group, dil,
                             out_dtype, segs):
            wk = ctx.kept(node, "stem_layout", lambda: stem_layout(wd))
            return stem_conv_int8(x, wd, bias, (sh, sw), (ph, pw), act,
                                  out_scale, wk)
        stem.stem_conv_int8.fallbacks += 1
    else:
        wd = _dequant_weight(w, q, x.dtype, node, ctx)
    return stem_conv_plain(x, wd, bias, (sh, sw), (ph, pw), act, out_scale,
                           dilation=dil, groups=group,
                           bounds=(None if segs is None else
                                   segment_bounds(node, segs, ctx)),
                           out_dtype=out_dtype)


def fc_forward(node, x, w, bias, ctx):
    act = node.attrs.get("activation")
    q = ctx.qinfo(node)
    if x.dtype == torch.int8 and (q is None or q.get("x_scale") is None):
        x = ctx.dequantize_edge(node, x,
                                getattr(torch, ctx.config.compute_dtype))
    kwargs = {}
    wdt = x.dtype
    if q is not None and w.dtype == torch.int8:
        kwargs["w_scale"] = ctx.const(node, "w_scale", lambda: q["w_scale"])
        if q.get("x_scale") is not None:
            kwargs["x_scale"] = _x_scale(node, q, ctx)
            x = _quantize_act(x, kwargs["x_scale"])
        wdt = torch.int8
    out_dtype = x.dtype if x.dtype != torch.int8 else torch.bfloat16
    return matmul_epilogue(x.contiguous(), _gemm_weight(node, w, wdt, ctx,
                                                        True), bias,
                           activation=act, out_dtype=out_dtype, **kwargs)


def eltwise_forward(node, inputs, ctx):
    """The int8-edge Eltwise: on the "cuda" backend two int8 operands of
    one shape (``takes_kernel``) are one ``eltwise_int8`` call, in any
    layout; any other form (three operands, a float one) takes the PyTorch
    ops, ``eltwise_int8_sum``, counted in ``eltwise_int8.fallbacks``.  The
    "torch" backend always takes them, uncounted.  Either takes the node's
    kept scales and the f32 reciprocal of its output scale."""
    q = ctx.qinfo(node)
    act = node.attrs.get("activation")
    scales = [None if s is None else ctx.scale(node, f"in_scale{i}", s)
              for i, s in enumerate(q["in_scales"])]
    inv = ctx.scale(node, "y_inv", reciprocal(q["y_scale"]))
    if ctx.backend == "cuda":
        if takes_kernel(inputs):
            return eltwise_int8(*inputs, *scales, inv, act)
        eltwise.eltwise_int8.fallbacks += 1
    return eltwise_int8_sum(inputs, scales, inv, act)


def chain_forward(node, x, weights, ctx, w_scales=None, scales=None):
    """A FusedBottleneck or FusedChain node's chain, as the reference's
    lowerings call it, on ``weights`` (w1, b1, w2, b2, w3, b3) stacked per
    block: the int8 mode where ``scales`` are given (a float ``x``
    quantized first, with a divide by ``sx[0]``), else the float mode with
    the weights cast to x's type; the weights in the kernel's layout, made
    once per node.  On the "cuda" backend ``fused_chain`` (int8) or
    ``fused_chain_float`` (the kernel, or its plain version on CPU
    tensors); on "torch" the plain version."""
    if scales is not None:
        x = _quantize_act(x, ctx.scale(node, "x_scale", scales[0][0]))
    wdt = torch.int8 if scales is not None else x.dtype
    w1, b1, w2, b2, w3, b3 = weights
    w1, w2, w3 = (ctx.kept(node, f"{k}/{wdt}",
                           lambda w=w: kernel_layout(w.to(wdt)))
                  for k, w in (("w1", w1), ("w2", w2), ("w3", w3)))
    args = (x.contiguous(), w1, b1, w2, b2, w3, b3)
    if ctx.backend != "cuda":
        return fused_chain_plain(*args, w_scales=w_scales, scales=scales)
    if scales is None:
        return fused_chain_float(*args)
    return fused_chain(*args, w_scales=w_scales, scales=scales)
