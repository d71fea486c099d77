"""Graph rewrite — a copy of ``feathercnn_tpu/quant/rewrite.py``: swap f32
conv/FC weights for int8 + epilogue scales and mark the int8 edges, with
the reference's rules, so both engines quantize one graph identically.

Runs inside Engine.__init__ after the fusion passes (so BN/Scale folds are
already baked into the weights being quantized — matching the reference's
order of fuse-then-transform at Init, [pub] src/net.cpp).  Activation
scales (for the full-int8 "w8a8" mode) come from quant/calibrate.py via
``graph.meta["act_scales"]``; a layer without a calibrated scale degrades
to weight-only for that layer.
"""

from __future__ import annotations

import numpy as np

from .qscheme import quantize_weight_per_channel

__all__ = ["quantize_graph"]

_QUANT_OPS = ("Convolution", "InnerProduct")


def quantize_graph(graph, mode: str, int8_grouped: bool = False,
                   requant_ops: bool = True, int8_axpy: bool = True,
                   fp_act_layers=(), quant_overrides=None) -> None:
    """``int8_grouped``: let grouped (cardinality) convs take int8 edges
    (EngineConfig.int8_grouped).
    ``requant_ops``: enable the requantizing edge types (concat_int8
    fallback, Scale/LRN requant_int8).  ``int8_axpy``: let Axpy's two
    big inputs (x, y) arrive int8 at their calibrated scales (the SE
    gate stays float).  ``quant_overrides``: per-layer mode map
    (EngineConfig.quant_overrides): "fp_act" keeps a layer's input
    float; "fp" additionally blocks every int8-edge role for the layer
    (emit, Eltwise/Axpy/Concat/Scale/LRN/pool marks)."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"unknown quant mode {mode!r}")
    qov = dict(quant_overrides or {})
    act_scales = graph.meta.get("act_scales", {})
    value_scales = graph.meta.get("value_scales", {})
    qmeta = graph.meta.setdefault("quant", {})
    for n in graph.nodes:
        if n.op not in _QUANT_OPS or not n.params:
            continue
        w = graph.params[n.params[0]]
        if w.dtype == np.int8:
            continue  # pre-quantized artifact
        # First conv from 3-channel images: tiny-C layers run on the float
        # path anyway (dispatch), but int8 storage still shrinks the
        # artifact; keep quantizing uniformly.
        wq, scale = quantize_weight_per_channel(np.asarray(w))
        graph.params[n.params[0]] = wq
        info = {"w_scale": scale}
        # Stems stay on float activations (the reference's rule; also the
        # standard int8-accuracy practice: first layer fp).
        fp_auto = (n.op == "Convolution" and n.inputs[0] in graph.inputs
                   and w.ndim == 4
                   and w.shape[-2] * n.attrs.get("group", 1) <= 8)
        if mode == "w8a8":
            xs = value_scales.get(n.inputs[0], act_scales.get(n.name))
            if xs is None:
                pass
            elif (n.name in fp_act_layers or fp_auto
                  or qov.get(n.name) in ("fp_act", "fp")):
                # keep the scale so serving can still TRANSFER int8
                # inputs (dispatch dequantizes via input_scale)
                info["input_scale"] = float(xs)
            else:
                info["x_scale"] = float(xs)
        qmeta[n.name] = info

    if mode != "w8a8":
        return
    consumers = graph.consumers()

    # ------------------------------------------------------------------
    # int8-edge propagation, one reverse-topological pass.
    #
    # A value becomes an int8 edge when EVERY consumer accepts int8 on it
    # at one agreed scale:
    #   - a quantized conv/FC accepts int8 on its data input at x_scale;
    #   - an int8 Eltwise SUM accepts each operand at its calibrated
    #     value scale (dequant-accumulate in registers);
    #   - a *scale-transparent* op (MAX pooling, Concat, Slice, Split,
    #     Flatten, Reshape, Dropout, ShuffleChannel) accepts int8 at whatever scale its
    #     own output edge carries — max/concat/reshape commute with the
    #     (monotone, elementwise) quantization, so int8 rides through;
    #   - a *requantizing* Concat (concat_int8) — fallback when the
    #     passthrough's single-scale requirement fails (DenseNet chains,
    #     mixed branches): each input arrives int8 at its own calibrated
    #     scale (or float) and is rescaled/quantized to the output scale
    #     in the concat lowering;
    #   - an int8 Scale or LRN (requant_int8): the elementwise/windowed
    #     op runs dequant -> op -> fused act -> requant in registers —
    #     this is what lets DenseNet's pre-activation Concat->BN->ReLU->
    #     Conv chains and GoogLeNet/AlexNet's stem->LRN->conv chains stay
    #     int8 end-to-end.
    # The producer then requantizes in its epilogue (emit_int8/y_scale,
    # kernels/matmul.py out_scale) — no standalone quantize op, half the
    # HBM traffic on the edge.  The reference has no analog (fp32-only);
    # this is the BASELINE.json:10 capability.
    # ------------------------------------------------------------------

    def _transparent(n) -> bool:
        if n.op in ("Concat", "Slice", "Split", "Flatten", "Reshape",
                    "Dropout", "ShuffleChannel"):
            return True
        if n.op == "Pooling":
            return n.attrs.get("pool", "MAX") == "MAX"
        return False

    producers = graph.producers()
    edge_scale = {}     # value name -> int8 scale it will carry
    denied = set()      # transparent nodes proven un-markable (fixpoint)

    def _accepts(c, value):
        """Scale at which consumer c takes int8 on `value`, else None."""
        info = qmeta.get(c.name)
        if c.op in ("Convolution", "InnerProduct"):
            # grouped/depthwise convs run the int8 path only when opted
            # in (kernels/dispatch.py) — otherwise they take float input.
            # Mirror dispatch's dil==1 guard: a dilated grouped conv
            # would dequantize the edge anyway, so marking it int8 only
            # adds a lossy round trip.
            if c.attrs.get("group", 1) != 1 and not (
                    int8_grouped and c.attrs.get("dilation", 1) == 1):
                return None
            if info and info.get("x_scale") is not None \
                    and c.inputs[0] == value:
                return float(info["x_scale"])
            return None
        if c.op == "Eltwise":
            if info and info.get("eltwise_int8"):
                s = value_scales.get(value)
                return float(s) if s is not None else None
            return None
        if c.op == "Axpy":
            # int8 accepted on the two big operands (x, y) only; the
            # SE gate (inputs[0]) always arrives float.
            if info and info.get("axpy_int8") and value in c.inputs[1:]:
                s = value_scales.get(value)
                return float(s) if s is not None else None
            return None
        cinfo = qmeta.get(c.name) or {}
        if c.op == "Concat" and cinfo.get("concat_int8"):
            # requantizing concat: takes each operand at its own
            # calibrated scale (rescaled in the lowering)
            s = value_scales.get(value)
            return float(s) if s is not None else None
        if c.op in ("Scale", "LRN") and cinfo.get("requant_int8") \
                and c.inputs[0] == value:
            return float(cinfo["x_scale"])
        if c.op == "Pooling" and cinfo.get("requant_int8") \
                and c.inputs[0] == value:
            # requantizing AVE pool: dequant-average-requant in registers
            return float(cinfo["x_scale"])
        if _transparent(c) and c.name not in denied:
            s = edge_scale.get(c.outputs[0])
            if s is not None and all(
                    edge_scale.get(o) == s for o in c.outputs):
                return s
            return None
        return None

    def _edge_scale_for(out):
        cons = consumers.get(out, [])
        if not cons or out in graph.outputs:
            return None
        scales = [_accepts(c, out) for c in cons]
        if any(s is None for s in scales):
            return None
        if len(set(scales)) != 1:
            return None
        return scales[0]

    def _try_concat_int8(n):
        if not requant_ops:
            return
        y_scale = _edge_scale_for(n.outputs[0])
        if y_scale is not None:
            qmeta[n.name] = {
                "concat_int8": True,
                "y_scale": float(y_scale),
                "in_scales": [
                    (float(value_scales[v]) if v in value_scales else None)
                    for v in n.inputs],
            }

    def _mark_pass():
        """One reverse-topological marking pass (honors ``denied``)."""
        edge_scale.clear()
        for n in graph.nodes:
            info = qmeta.get(n.name)
            if info is None:
                continue
            if (info.get("eltwise_int8") or info.get("passthrough_int8")
                    or info.get("concat_int8") or info.get("requant_int8")
                    or info.get("axpy_int8")):
                del qmeta[n.name]       # entries this pass owns
            else:
                info.pop("emit_int8", None)
                info.pop("y_scale", None)
        for n in reversed(graph.nodes):
            if qov.get(n.name) == "fp":
                # full per-layer opt-out: no int8-edge role of any kind
                # (emit, accept, transparent/requant/eltwise marks)
                continue
            if (n.op == "Eltwise"
                    and n.attrs.get("operation", "SUM") == "SUM"
                    and not n.attrs.get("coeffs")):
                out = n.outputs[0]
                y_scale = _edge_scale_for(out)
                if (y_scale is not None
                        and all(v in value_scales for v in n.inputs)):
                    qmeta[n.name] = {
                        "eltwise_int8": True,
                        "in_scales": [float(value_scales[v])
                                      for v in n.inputs],
                        "y_scale": float(y_scale),
                    }
            elif n.op == "Axpy" and int8_axpy:
                y_scale = _edge_scale_for(n.outputs[0])
                if (y_scale is not None
                        and all(v in value_scales for v in n.inputs[1:])):
                    qmeta[n.name] = {
                        "axpy_int8": True,
                        "in_scales": [float(value_scales[v])
                                      for v in n.inputs[1:]],
                        "y_scale": float(y_scale),
                    }
            elif _transparent(n) and n.name not in denied:
                ss = [_edge_scale_for(o) for o in n.outputs]
                if all(s is not None for s in ss) and len(set(ss)) == 1:
                    for o in n.outputs:
                        edge_scale[o] = ss[0]
                    qmeta[n.name] = {"passthrough_int8": True,
                                     "y_scale": float(ss[0])}
                elif n.op == "Concat":
                    _try_concat_int8(n)
            elif n.op == "Concat" and n.name in denied:
                # passthrough proven impossible — fall back to the
                # requantizing concat (each input at its own scale)
                _try_concat_int8(n)
            elif (n.op == "Pooling"
                  and n.attrs.get("pool", "MAX") == "AVE"
                  and not n.attrs.get("global_pooling", False)
                  and requant_ops):
                # AVE pooling doesn't commute with the int8 round (MAX
                # does), but it CAN requantize: avg(s*q) = s*avg(q), so
                # the lowering averages the raw grid values and folds
                # x_scale/y_scale into one multiply — int8 in, int8 out,
                # everything XLA-fused.  Covers ShuffleNet-v1 shortcut
                # pools, DenseNet transitions, Inception pool branches.
                # GLOBAL pools stay float: their 1x1 outputs carry no
                # bytes worth saving, and SE squeeze gates measurably
                # lose accuracy when their pooled input requantizes.
                xs = value_scales.get(n.inputs[0])
                y_scale = _edge_scale_for(n.outputs[0])
                if xs is not None and y_scale is not None:
                    qmeta[n.name] = {"requant_int8": True,
                                     "x_scale": float(xs),
                                     "y_scale": float(y_scale)}
            elif n.op in ("Scale", "LRN") and requant_ops \
                    and len(n.inputs) == 1:
                # two-bottom Scale (runtime scaler, SE-style) stays float
                xs = value_scales.get(n.inputs[0])
                y_scale = _edge_scale_for(n.outputs[0])
                if xs is not None and y_scale is not None:
                    qmeta[n.name] = {"requant_int8": True,
                                     "x_scale": float(xs),
                                     "y_scale": float(y_scale)}
            info = qmeta.get(n.name)
            # a quantized conv/FC can emit int8 even when its own INPUT
            # stays float (fp_act_layers: the float compute path requants
            # in its epilogue via _out_spec)
            if info is not None and "w_scale" in info:
                y_scale = _edge_scale_for(n.outputs[0])
                if y_scale is not None:
                    info["emit_int8"] = True
                    info["y_scale"] = float(y_scale)

    def _int8_source_scale(v):
        p = producers.get(v)
        info = qmeta.get(p.name) if p is not None else None
        if info and (info.get("emit_int8") or info.get("eltwise_int8")
                     or info.get("passthrough_int8")
                     or info.get("concat_int8")
                     or info.get("requant_int8")
                     or info.get("axpy_int8")):
            return info.get("y_scale")
        return None

    # Fixpoint: a marked MULTI-input transparent op (Concat) whose inputs
    # won't all actually arrive as int8 at the marked scale (e.g. one
    # branch's producer has a second, float-only consumer) would
    # concatenate raw int8 grid values with real-scale floats — demote it
    # and re-mark; demotion can cascade to the branch producers' emit
    # decisions, hence the loop.  Single-input transparent ops degrade
    # gracefully (dtype follows the input; consumers quantize on the
    # fly), so they need no validation.
    while True:
        _mark_pass()
        new_denials = set()
        for n in graph.nodes:
            info = qmeta.get(n.name)
            if (info and info.get("passthrough_int8")
                    and len(n.inputs) > 1):
                s = info["y_scale"]
                if any(_int8_source_scale(v) != s for v in n.inputs):
                    new_denials.add(n.name)
        if not new_denials:
            break
        denied |= new_denials
