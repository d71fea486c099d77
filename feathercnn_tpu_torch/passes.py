"""Graph optimization passes — a copy of ``feathercnn_tpu/passes.py``.

Plain numpy on the graph, run in the reference's order so both engines see
the same graph.  ``fuse_psroi_ave`` (R-FCN's vote average folded into
its PSROIPooling) runs after ``optimize`` where ``psroi_fuse_ave`` is set,
as in the reference's engine.


The reference runs a single in-place fusion walk in ``Net::InitFromBuffer``:
for each adjacent layer pair, ``prev->TryFuse(next)`` folds
Conv <- BatchNorm <- Scale <- ReLU chains and erases the fused layers
([pub] src/net.cpp, [pub] src/layers/conv_layer.cpp).  Here the same
transformations are explicit IR->IR passes that run *before* tracing; XLA's
HLO fusion then handles everything elementwise that remains.

Pass order (``optimize``):
  1. drop_identities     -- Dropout / Split vanish (inference is identity)
  2. fold_batchnorm      -- BN folds into preceding Conv/InnerProduct,
                            otherwise canonicalizes to a Scale node
  3. fold_scale          -- Scale folds into preceding Conv/InnerProduct
  4. fuse_activation     -- ReLU/ReLU6/LeakyReLU folds into the producer's
                            epilogue (Conv/InnerProduct/Eltwise/Scale)
  5. merge_sibling_convs -- horizontal fusion: convs sharing one input and
                            identical geometry become ONE wider conv + Slice
  6. dce                 -- drop nodes whose outputs are never used
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .ir import Graph, Node, topo_sort

__all__ = [
    "optimize",
    "drop_identities",
    "fold_batchnorm",
    "fold_scale",
    "fuse_activation",
    "merge_concat_siblings",
    "merge_sibling_convs",
    "dce",
]

# Ops whose weight layout ends in an output-channel axis, making
# per-output-channel affine folds (BN/Scale) possible.
_FOLDABLE = {"Convolution", "InnerProduct"}
# Ops that support a fused activation epilogue attr.
_EPILOGUE_OPS = {"Convolution", "InnerProduct", "Eltwise", "Scale", "Axpy"}


def optimize(graph: Graph, merge_siblings: bool = True,
             merge_concats: bool = False,
             fold_scale_chains: bool = True,
             nested_pools: bool = False) -> Graph:
    drop_identities(graph)
    fold_batchnorm(graph)
    fold_scale(graph)
    if fold_scale_chains:
        fold_scale_chain(graph)
    if nested_pools:
        derive_nested_pools(graph)
    fuse_activation(graph)
    if merge_concats:
        # before merge_sibling_convs: concat-feeding sibling groups get
        # the stronger transform (no Slice, Concat deleted)
        merge_concat_siblings(graph)
    if merge_siblings:
        merge_sibling_convs(graph)
    dce(graph)
    topo_sort(graph)
    graph.validate()
    return graph


# ----------------------------------------------------------------------
def _rename_uses(graph: Graph, old: str, new: str) -> None:
    """Replace every read of value ``old`` with ``new`` (SSA rewire)."""
    for n in graph.nodes:
        n.inputs = [new if i == old else i for i in n.inputs]
    graph.outputs = [new if o == old else o for o in graph.outputs]


def _sole_consumer(graph: Graph, value: str) -> bool:
    if value in graph.outputs:
        return False
    return len(graph.consumers().get(value, [])) == 1


def drop_identities(graph: Graph) -> None:
    """Dropout is identity at inference ([pub] src/layers/dropout_layer.h);
    Split fan-out is implicit in SSA."""
    keep: List[Node] = []
    for n in graph.nodes:
        if n.op == "Dropout":
            _rename_uses(graph, n.outputs[0], n.inputs[0])
        elif n.op == "Split":
            for o in n.outputs:
                _rename_uses(graph, o, n.inputs[0])
        else:
            keep.append(n)
    graph.nodes = keep


# ----------------------------------------------------------------------
def _bn_affine(graph: Graph, node: Node):
    """BatchNorm -> per-channel (gamma, beta): y = gamma*x + beta."""
    mean = graph.params[node.params[0]].astype(np.float64)
    var = graph.params[node.params[1]].astype(np.float64)
    eps = node.attrs.get("eps", 1e-5)
    inv_std = 1.0 / np.sqrt(var + eps)
    return inv_std, -mean * inv_std


def _scale_affine(graph: Graph, node: Node):
    gamma = graph.params[node.params[0]].astype(np.float64)
    if node.attrs.get("bias_term", False) and len(node.params) > 1:
        beta = graph.params[node.params[1]].astype(np.float64)
    else:
        beta = np.zeros_like(gamma)
    return gamma, beta


def _fold_affine_into(graph: Graph, prod: Node, gamma, beta) -> None:
    """Fold y -> gamma*y + beta into a Conv/InnerProduct's weights+bias.

    Conv weights are HWIO (or HWI'O for grouped), InnerProduct weights are
    (in, out): output channels are the trailing axis for both, so the fold
    is a broadcast multiply on the last axis — the math FeatherCNN's
    ConvLayer::Fuse does on its NCHW weights ([pub] src/layers/conv_layer.cpp),
    restated for TPU layout.
    """
    w = graph.params[prod.params[0]]
    dtype = w.dtype
    graph.params[prod.params[0]] = (w.astype(np.float64) * gamma).astype(dtype)
    if prod.attrs.get("bias_term", True) and len(prod.params) > 1:
        b = graph.params[prod.params[1]].astype(np.float64)
        graph.params[prod.params[1]] = (b * gamma + beta).astype(dtype)
    else:
        bias_name = prod.name + "/folded_bias"
        graph.params[bias_name] = beta.astype(dtype)
        prod.params.append(bias_name)
        prod.attrs["bias_term"] = True


def fold_batchnorm(graph: Graph) -> None:
    producers = graph.producers()
    keep: List[Node] = []
    for n in graph.nodes:
        if n.op != "BatchNorm":
            keep.append(n)
            continue
        gamma, beta = _bn_affine(graph, n)
        prod = producers.get(n.inputs[0])
        if (prod is not None and prod.op in _FOLDABLE
                and not prod.attrs.get("activation")
                and _sole_consumer(graph, n.inputs[0])):
            _fold_affine_into(graph, prod, gamma, beta)
            _rename_uses(graph, n.outputs[0], prod.outputs[0])
            # prod's output takes over BN's role; keep producers map fresh
            producers[prod.outputs[0]] = prod
        else:
            # Canonicalize standalone BN to a Scale node (precomputed affine)
            gname, bname = n.name + "/bn_gamma", n.name + "/bn_beta"
            graph.params[gname] = gamma.astype(np.float32)
            graph.params[bname] = beta.astype(np.float32)
            keep.append(Node(
                name=n.name, op="Scale", inputs=list(n.inputs),
                outputs=list(n.outputs),
                attrs={"bias_term": True}, params=[gname, bname]))
    graph.nodes = keep


def fold_scale_chain(graph: Graph) -> None:
    """Collapse back-to-back per-channel affines into ONE Scale:
    ``Scale_a (no act) -> Scale_b``  ==>  ``Scale(ga*gb, ba*gb + bb)``
    keeping Scale_b's name/outputs/activation.

    DenseNet-style deploys emit a BatchNorm (canonicalized to a Scale by
    fold_batchnorm — it cannot fold back through a Concat) immediately
    followed by the Caffe Scale layer, after EVERY concat: folding the
    pair halves the head's elementwise passes, and under w8a8 removes
    one requant_int8 round trip per pair (one fewer int8 grid hop, so
    numerics only improve).  Exact to f32 rounding (composed in f64).
    Iterates to fixpoint so longer affine chains collapse too."""
    changed = True
    while changed:
        changed = False
        producers = graph.producers()
        keep: List[Node] = []
        dropped = set()
        for n in graph.nodes:
            if n.name in dropped:
                continue  # folded-away producer — remove even if it
                # appears after its consumer in graph.nodes
            if n.op != "Scale" or not n.params or len(n.inputs) > 1:
                keep.append(n)
                continue
            prod = producers.get(n.inputs[0])
            if (prod is not None and prod.op == "Scale" and prod.params
                    and len(prod.inputs) == 1
                    and not prod.attrs.get("activation")
                    and _sole_consumer(graph, n.inputs[0])):
                ga, ba = _scale_affine(graph, prod)
                gb, bb = _scale_affine(graph, n)
                gname = n.name + "/chain_gamma"
                bname = n.name + "/chain_beta"
                graph.params[gname] = (ga * gb).astype(np.float32)
                graph.params[bname] = (ba * gb + bb).astype(np.float32)
                n.inputs = list(prod.inputs)
                n.params = [gname, bname]
                n.attrs["bias_term"] = True
                keep = [k for k in keep if k.name != prod.name]
                dropped.add(prod.name)
                changed = True
            keep.append(n)
        graph.nodes = keep


def fuse_psroi_ave(graph: Graph) -> None:
    """R-FCN head: PSROIPooling -> global AVE Pooling (the k x k vote
    average, [pub] rfcn deploys' ave_cls_score_rois/ave_bbox_pred_rois)
    collapses into the PSROI mask contraction itself: per-bin counts are
    SEPARABLE (count[r,i,j] = ch[r,i]*cw[r,j]), so normalizing the two
    axis masks row-wise folds the per-bin average, and the k^2 vote mean
    contracts the bin axes away — one einsum emits (R, 1, 1, C) directly
    with no (R, k, k, C) intermediate.  Exact to f32 rounding (division
    moves from k^2*C elements to 2k mask rows).  Gated by
    EngineConfig.psroi_fuse_ave; applied when the pool is the sole
    consumer."""
    producers = graph.producers()
    keep: List[Node] = []
    for n in graph.nodes:
        if (n.op == "Pooling" and n.attrs.get("global_pooling")
                and n.attrs.get("pool") == "AVE"):
            prod = producers.get(n.inputs[0])
            if (prod is not None and prod.op == "PSROIPooling"
                    and not prod.attrs.get("fuse_ave")
                    and _sole_consumer(graph, n.inputs[0])):
                prod.attrs["fuse_ave"] = True
                # keep the POOL's public blob name (graph outputs /
                # extract() consumers see the same names as unfused)
                prod.outputs = [n.outputs[0]]
                continue
        keep.append(n)
    graph.nodes = keep


def derive_nested_pools(graph: Graph) -> int:
    """Sibling non-overlapping AVE pools over one input collapse to ONE
    read of it: with square windows, stride == kernel, no padding, and
    every k_j a multiple of the smallest k_base dividing the spatial
    dims, each coarser bin is EXACTLY the average of the finest bin's
    grid (equal-size blocks — average of averages is the average), so
    pools j re-point at the base pool's output with kernel k_j/k_base.

    PSPNet's pyramid pooling: the four bins {60,30,20,10} re-read the
    stage-5 map; after this pass only the k=10 bin touches it.  fp path
    exact to f32
    rounding; under w8a8 the derived bins average the base bin's
    REQUANTIZED grid (one extra +-0.5 LSB rounding on 36/9/4-cell
    means — gated per model, accuracy-gate checked).  Returns the
    number of rewritten pools."""
    from collections import defaultdict
    from .ir import infer_shapes
    infer_shapes(graph)

    def geom(n):
        k = n.attrs.get("kernel_size")
        kh = n.attrs.get("kernel_h", k)
        kw = n.attrs.get("kernel_w", k)
        sh = n.attrs.get("stride_h", n.attrs.get("stride", 1))
        sw = n.attrs.get("stride_w", n.attrs.get("stride", 1))
        ph = n.attrs.get("pad_h", n.attrs.get("pad", 0))
        pw = n.attrs.get("pad_w", n.attrs.get("pad", 0))
        return kh, kw, sh, sw, ph, pw

    groups = defaultdict(list)
    for n in graph.nodes:
        if n.op != "Pooling" or n.attrs.get("pool", "MAX") != "AVE":
            continue
        if n.attrs.get("global_pooling", False):
            continue
        kh, kw, sh, sw, ph, pw = geom(n)
        if kh is None or kh != kw or sh != kh or sw != kw or ph or pw:
            continue
        groups[n.inputs[0]].append((kh, n))
    changed = 0
    for src, pools in groups.items():
        if len(pools) < 2:
            continue
        h, w = graph.specs[src].shape[1], graph.specs[src].shape[2]
        pools.sort(key=lambda t: t[0])
        kb, base = pools[0]
        if h % kb or w % kb:
            continue
        for k, n in pools[1:]:
            if k % kb:
                continue
            n.inputs[0] = base.outputs[0]
            for a in ("kernel_h", "kernel_w", "stride_h", "stride_w",
                      "pad_h", "pad_w"):
                n.attrs.pop(a, None)
            n.attrs["kernel_size"] = k // kb
            n.attrs["stride"] = k // kb
            n.attrs["pad"] = 0
            changed += 1
    if changed:
        topo_sort(graph)
        infer_shapes(graph)
    return changed


def fold_scale(graph: Graph) -> None:
    producers = graph.producers()
    keep: List[Node] = []
    for n in graph.nodes:
        if n.op != "Scale" or not n.params or len(n.inputs) > 1:
            # two-bottom Scale (runtime scaler, SE gates) can't fold —
            # its params slot holds the BIAS, not a foldable gamma
            keep.append(n)
            continue
        prod = producers.get(n.inputs[0])
        if (prod is not None and prod.op in _FOLDABLE
                and not prod.attrs.get("activation")
                and _sole_consumer(graph, n.inputs[0])):
            gamma, beta = _scale_affine(graph, n)
            _fold_affine_into(graph, prod, gamma, beta)
            _rename_uses(graph, n.outputs[0], prod.outputs[0])
            producers[prod.outputs[0]] = prod
        else:
            keep.append(n)
    graph.nodes = keep


# ----------------------------------------------------------------------
_ACT_OPS = {"ReLU": "relu", "ReLU6": "relu6"}


def fuse_activation(graph: Graph) -> None:
    """Fold ReLU-family nodes into the producing op's epilogue — the analog
    of the reference's fused bias/ReLU GEMM store-back
    ([pub] src/booster/arm/sgemm.cpp epilogues, WinogradOutType variants)."""
    producers = graph.producers()
    keep: List[Node] = []
    for n in graph.nodes:
        act = _ACT_OPS.get(n.op)
        if act == "relu" and n.attrs.get("negative_slope", 0) != 0:
            act = None  # leaky relu stays standalone
        if act is None:
            keep.append(n)
            continue
        prod = producers.get(n.inputs[0])
        if (prod is not None and prod.op in _EPILOGUE_OPS
                and not prod.attrs.get("activation")
                and _sole_consumer(graph, n.inputs[0])):
            prod.attrs["activation"] = act
            _rename_uses(graph, n.outputs[0], prod.outputs[0])
            producers[prod.outputs[0]] = prod
        else:
            keep.append(n)
    graph.nodes = keep


# ----------------------------------------------------------------------
def _conv_geom(n: Node):
    a = n.attrs
    return (a.get("kernel_h", a.get("kernel_size", 1)),
            a.get("kernel_w", a.get("kernel_size", 1)),
            a.get("stride_h", a.get("stride", 1)),
            a.get("stride_w", a.get("stride", 1)),
            a.get("pad_h", a.get("pad", 0)),
            a.get("pad_w", a.get("pad", 0)),
            a.get("dilation", 1))


def _aligned_sibling_order(sibs: List[Node], lane_align: int
                           ) -> Optional[List[Node]]:
    """Largest subset (ties: first in node order) of ``sibs`` that can be
    ordered so every internal concat boundary is a multiple of
    ``lane_align`` (the reference's rule, kept so both engines build the
    same graph)."""
    import itertools
    idx = range(len(sibs))
    for r in range(len(sibs), 1, -1):
        for combo in itertools.combinations(idx, r):
            for perm in itertools.permutations(combo):
                cs = [sibs[i].attrs["num_output"] for i in perm]
                if all(p % lane_align == 0 for p in np.cumsum(cs)[:-1]):
                    return [sibs[i] for i in perm]
    return None


def merge_concat_siblings(graph: Graph, max_kernel: int = 3) -> int:
    """Horizontal fusion, Concat-consumer form: convs that read the SAME
    input and whose outputs feed ONE channel Concat (each with no other
    consumer) merge into a single conv producing the concatenated channels
    directly — the Concat node is DELETED, not replaced by a Slice.

    Unlike ``merge_sibling_convs`` the kernels may differ: a smaller
    kernel is promoted to the group's max by zero-padding the weight
    (1x1 -> center tap of a 3x3) and growing the conv pad to keep the
    output grid identical — exact, since the extra taps carry zero
    weights.  The MXU makes the added multiplies free wherever the layer
    is bandwidth-bound; ``max_kernel`` bounds the promotion (default 3,
    the SqueezeNet fire expand1x1+expand3x3 case — 5x5 promotions grow
    FLOPs 25x on the 1x1 branch, unmeasured).

    The reference has no analog (vertical fusion only, [pub] src/net.cpp
    TryFuse).  Exactness: output == concat(conv_i(x)) bit-for-bit in f32;
    under w8a8 the merged output carries the concat's calibrated scale —
    the same scale the consumers already saw.  Returns merges performed.
    """
    consumers = graph.consumers()
    producers = graph.producers()

    def _geom_ok(sibs: List[Node]):
        """Target (Kh, Kw, Ph, Pw) if the group can promote, else None."""
        kh = max(s.attrs.get("kernel_h", s.attrs.get("kernel_size", 1))
                 for s in sibs)
        kw = max(s.attrs.get("kernel_w", s.attrs.get("kernel_size", 1))
                 for s in sibs)
        if kh > max_kernel or kw > max_kernel:
            return None
        target_pad = None
        for s in sibs:
            skh, skw, _, _, sph, spw, dil = _conv_geom(s)
            if (kh - skh) % 2 or (kw - skw) % 2:
                return None
            p = (sph + dil * (kh - skh) // 2, spw + dil * (kw - skw) // 2)
            if target_pad is None:
                target_pad = p
            elif target_pad != p:
                return None
        return (kh, kw) + target_pad

    n_merged = 0
    remove: set = set()
    replace: Dict[str, Node] = {}   # concat name -> merged conv node
    for cat in graph.nodes:
        if cat.op != "Concat" or cat.attrs.get("axis", -1) not in (-1, 3):
            continue
        if len(set(cat.inputs)) != len(cat.inputs):
            continue
        sibs = [producers.get(v) for v in cat.inputs]
        if any(s is None or s.op != "Convolution"
               or s.attrs.get("group", 1) != 1
               or not s.params
               or graph.params[s.params[0]].dtype != np.float32
               or s.attrs.get("activation") not in (None, "relu", "relu6")
               or s.outputs[0] in graph.outputs
               or len(consumers.get(s.outputs[0], [])) != 1
               or s.name in remove
               for s in sibs):
            continue
        inp = sibs[0].inputs[0]
        if any(s.inputs[0] != inp for s in sibs):
            continue
        strides = {(_conv_geom(s)[2], _conv_geom(s)[3]) for s in sibs}
        dils = {_conv_geom(s)[6] for s in sibs}
        if len(strides) != 1 or len(dils) != 1:
            continue
        geom = _geom_ok(sibs)
        if geom is None:
            continue
        kh, kw, ph, pw = geom

        co = [s.attrs["num_output"] for s in sibs]
        ws = []
        for s in sibs:
            w = graph.params[s.params[0]]
            skh, skw = w.shape[0], w.shape[1]
            wp = np.zeros((kh, kw) + w.shape[2:], w.dtype)
            oh, ow = (kh - skh) // 2, (kw - skw) // 2
            wp[oh:oh + skh, ow:ow + skw] = w
            ws.append(wp)
        w_m = np.concatenate(ws, axis=-1)

        sh, sw = next(iter(strides))
        attrs = {"num_output": int(sum(co)), "kernel_h": kh, "kernel_w": kw,
                 "stride_h": sh, "stride_w": sw, "pad_h": ph, "pad_w": pw,
                 "dilation": next(iter(dils)), "group": 1}
        acts = [s.attrs.get("activation") for s in sibs]
        if len(set(acts)) == 1:
            if acts[0] is not None:
                attrs["activation"] = acts[0]
        else:
            attrs["act_segments"] = tuple(zip(acts, co))

        mname = "+".join(s.name for s in sibs)
        params = [mname + "/w"]
        graph.params[mname + "/w"] = w_m
        has_bias = any(s.attrs.get("bias_term", True) and len(s.params) > 1
                       for s in sibs)
        attrs["bias_term"] = has_bias
        if has_bias:
            biases = [graph.params[s.params[1]].astype(np.float32)
                      if s.attrs.get("bias_term", True) and len(s.params) > 1
                      else np.zeros(s.attrs["num_output"], np.float32)
                      for s in sibs]
            graph.params[mname + "/b"] = np.concatenate(biases)
            params.append(mname + "/b")

        replace[cat.name] = Node(name=mname, op="Convolution",
                                 inputs=[inp], outputs=list(cat.outputs),
                                 attrs=attrs, params=params)
        remove.update(s.name for s in sibs)
        remove.add(cat.name)
        n_merged += 1

    if not n_merged:
        return 0
    out_nodes: List[Node] = []
    for n in graph.nodes:
        if n.name in replace:
            out_nodes.append(replace[n.name])
        elif n.name not in remove:
            out_nodes.append(n)
    graph.nodes = out_nodes
    return n_merged


def merge_sibling_convs(graph: Graph, lane_align: int = 128) -> int:
    """Horizontal fusion: convs that read the SAME input with identical
    kernel/stride/pad/dilation merge into ONE conv with concatenated output
    channels, followed by a channel ``Slice`` that re-exposes the original
    value names.  The input feature map is read from HBM once instead of
    once per sibling, and the merged GEMM presents a wider N to the MXU.

    The reference has no analog (its fusion is vertical only,
    [pub] src/net.cpp TryFuse); the pass targets ResNet
    projection blocks (branch1 + branch2a share the block input) and
    GoogLeNet inception reduce convs (1x1 / 3x3_reduce / 5x5_reduce share
    the module input).

    Mixed per-branch activations (branch1 has none, branch2a has ReLU) are
    kept exact via an ``act_segments`` attr — a per-output-channel clamp
    applied in the epilogue (numerics.apply_act_segments).

    Full-int8 interplay: the merged output physically carries ONE int8
    scale, so when ``graph.meta['value_scales']`` is already calibrated the
    pass (a) only merges siblings whose consumers are scale-declaring ops
    (conv/FC/Eltwise-SUM — ops that accept any declared per-tensor scale,
    unlike Concat whose agreed scale would cascade), and (b) overrides the
    slice outputs' value scales to the max over siblings so quant/rewrite's
    int8-edge marking sees one consistent scale.  Returns the number of
    merges performed.
    """
    consumers = graph.consumers()
    value_scales = graph.meta.get("value_scales") or {}
    quant_aware = bool(value_scales)

    def mergeable(n: Node) -> bool:
        return (n.op == "Convolution"
                and n.attrs.get("group", 1) == 1
                and bool(n.params)
                and graph.params[n.params[0]].dtype == np.float32
                and n.attrs.get("activation") in (None, "relu", "relu6")
                and n.outputs[0] not in graph.outputs)

    def consumers_ok(out: str) -> bool:
        """Quant mode: every consumer must accept an int8 edge at a scale
        WE declare (conv/FC data input, Eltwise-SUM operand)."""
        for c in consumers.get(out, []):
            if c.op in ("Convolution", "InnerProduct"):
                if c.op == "Convolution" and c.attrs.get("group", 1) != 1:
                    return False
                if c.inputs[0] != out:
                    return False
            elif (c.op == "Eltwise"
                  and c.attrs.get("operation", "SUM") == "SUM"
                  and not c.attrs.get("coeffs")):
                continue
            else:
                return False
        return True

    groups: Dict[tuple, List[Node]] = {}
    for n in graph.nodes:
        if mergeable(n):
            groups.setdefault((n.inputs[0], _conv_geom(n)), []).append(n)

    merges: Dict[str, List[Node]] = {}  # first-sibling name -> replacement
    removed = set()
    n_merged = 0
    for (inp, _geom), sibs in groups.items():
        if quant_aware:
            sibs = [s for s in sibs
                    if consumers_ok(s.outputs[0])
                    and value_scales.get(s.outputs[0]) is not None]
        if len(sibs) < 2:
            continue
        if len(sibs) > 5:       # bound the permutation search
            sibs = sibs[:5]
        sibs = _aligned_sibling_order(sibs, lane_align)
        if sibs is None:
            continue
        co = [s.attrs["num_output"] for s in sibs]
        w_m = np.concatenate([graph.params[s.params[0]] for s in sibs],
                             axis=-1)
        has_bias = any(s.attrs.get("bias_term", True) and len(s.params) > 1
                       for s in sibs)
        mname = "+".join(s.name for s in sibs)
        attrs = dict(sibs[0].attrs)
        attrs["num_output"] = int(sum(co))
        attrs["bias_term"] = has_bias
        acts = [s.attrs.get("activation") for s in sibs]
        if len(set(acts)) == 1:
            if acts[0] is None:
                attrs.pop("activation", None)
            else:
                attrs["activation"] = acts[0]
        else:
            attrs.pop("activation", None)
            attrs["act_segments"] = tuple(zip(acts, co))

        params = [mname + "/w"]
        graph.params[mname + "/w"] = w_m
        if has_bias:
            biases = []
            for s in sibs:
                if s.attrs.get("bias_term", True) and len(s.params) > 1:
                    biases.append(
                        graph.params[s.params[1]].astype(np.float32))
                else:
                    biases.append(
                        np.zeros(s.attrs["num_output"], np.float32))
            graph.params[mname + "/b"] = np.concatenate(biases)
            params.append(mname + "/b")

        merged = Node(name=mname, op="Convolution", inputs=[inp],
                      outputs=[mname], attrs=attrs, params=params)
        points = list(np.cumsum(co)[:-1].astype(int))
        slc = Node(name=mname + "/slice", op="Slice", inputs=[mname],
                   outputs=[s.outputs[0] for s in sibs],
                   attrs={"axis": -1,
                          "slice_points": [int(p) for p in points]})
        merges[sibs[0].name] = [merged, slc]
        removed.update(s.name for s in sibs)
        n_merged += 1
        if quant_aware:
            s_shared = max(float(value_scales[s.outputs[0]]) for s in sibs)
            for s in sibs:
                value_scales[s.outputs[0]] = s_shared

    if not merges:
        return 0
    out_nodes: List[Node] = []
    for n in graph.nodes:
        if n.name in merges:
            out_nodes.extend(merges[n.name])
        elif n.name not in removed:
            out_nodes.append(n)
    graph.nodes = out_nodes
    return n_merged


# ----------------------------------------------------------------------
def dce(graph: Graph) -> None:
    live = set(graph.outputs)
    keep_rev: List[Node] = []
    for n in reversed(graph.nodes):
        if any(o in live for o in n.outputs):
            keep_rev.append(n)
            live.update(n.inputs)
    graph.nodes = list(reversed(keep_rev))
    # Drop orphaned params
    used = {p for n in graph.nodes for p in n.params}
    graph.params = {k: v for k, v in graph.params.items() if k in used}
