"""Region fusion — a copy of ``feathercnn_tpu/passes_fusion.py``.

Replaces identity-shortcut bottlenecks with one fused node.  Runs AFTER
passes.optimize and quant.rewrite (so conv/BN/ReLU folds and int8
metadata are already in place).  Pattern:

    a = Conv1x1(x, act=relu)          s1, single consumer
    b = Conv3x3(a, act=relu)          s1 p1, single consumer
    c = Conv1x1(b)                    no act, single consumer
    y = Eltwise SUM (x, c) act=relu   identity shortcut

-> one ``FusedBottleneck`` node (``EngineConfig.fuse_blocks``), and runs of
same-shape ones -> one ``FusedChain`` node (``fuse_chains``), both lowered
to ``kernels/fused_chain.py``.

The region gate below (``region_worth_fusing``, ``chain_plan``,
``chain_vmem_bytes``, ``_use_im2col``) is copied as it is from the
reference's ``kernels/fused_chain.py``: it decides which blocks fuse and
where a run of blocks splits, so it decides the graph, and both engines
must build the same graph from one graph.  Its arithmetic is the TPU
kernel's VMEM budget, kept here as a graph rule; it is not the CUDA
kernel's tiling, which plans its own tiles (``kernels/fused_chain.py``,
``tile_plan``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .ir import Graph, Node

__all__ = ["fuse_bottlenecks", "fuse_chains", "chain_plan",
           "region_worth_fusing"]


# ----------------------------------------------------------------------
# The region gate, copied from feathercnn_tpu/kernels/fused_chain.py
# (:197-257).
# ----------------------------------------------------------------------

def region_worth_fusing(H, W, C, Cm, quant: bool) -> bool:
    """Default region-fusion policy: OFF (the reference measured XLA's
    per-layer int8 path ahead of its chain kernel in context).  Enable per
    signature via ``graph.meta['chain_regions']``."""
    return False


def chain_plan(N, H, W, C, Cm, nb, act_item, w_item,
               budget=13 * 1024 * 1024 + 512 * 1024, out_item=None):
    """(chunk, slab_rows) such that the TPU kernel fits ``budget`` VMEM,
    or None if even (1, min_slab) overflows."""
    wbytes = (C * Cm + 9 * Cm * Cm + Cm * C) * w_item * nb
    # keep the unrolled slab count bounded (compile size) — at most 8
    # slabs per image
    divisors = [d for d in range(1, H + 1)
                if H % d == 0 and H // d <= 8]

    def fits(chunk, R):
        return chain_vmem_bytes(chunk, H, W, C, Cm, act_item, wbytes,
                                R, out_item=out_item) <= budget

    # chunk must divide N exactly; walk N's divisors from largest to
    # smallest
    for chunk in sorted((d for d in range(1, N + 1) if N % d == 0),
                        reverse=True):
        for R in reversed(divisors):          # prefer big slabs
            if fits(chunk, R):
                return (chunk, R)
    return None


def _use_im2col(Cm: int) -> bool:
    """One big K=9*Cm GEMM for conv2 when Cm is narrow."""
    return Cm <= 128


def chain_vmem_bytes(chunk, H, W, C, Cm, act_item, wbytes_total,
                     slab_rows=None, out_item=None):
    """Rough per-grid-step VMEM footprint of the TPU kernel: slab f32
    temporaries (x1.5 safety), int8 act + y1 (+ conv2 im2col) scratches,
    in/out chunk double buffers, resident weights."""
    R = slab_rows or H
    Ms = chunk * R * W
    M = chunk * H * W
    f32_tmp = Ms * (2 * Cm + C) * 6
    pad_slab = chunk * (R + 2) * (W + 2) * Cm * act_item
    scratch = M * (C + Cm) * act_item
    if _use_im2col(Cm):
        scratch += Ms * 9 * Cm * act_item
    io = 2 * M * C * (act_item + (out_item or act_item))
    return f32_tmp + pad_slab + scratch + io + wbytes_total


# ----------------------------------------------------------------------
# The passes
# ----------------------------------------------------------------------

def _conv_is(n: Node, k: int, act, stride=1) -> bool:
    if n is None or n.op != "Convolution":
        return False
    a = n.attrs
    kh = a.get("kernel_h", a.get("kernel_size", 1))
    kw = a.get("kernel_w", a.get("kernel_size", 1))
    sh = a.get("stride_h", a.get("stride", 1))
    if (kh, kw) != (k, k) or sh != stride or a.get("group", 1) != 1 \
            or a.get("dilation", 1) != 1:
        return False
    if k == 3 and a.get("pad_h", a.get("pad", 0)) != 1:
        return False
    return a.get("activation") == act


def fuse_bottlenecks(graph: Graph, act_itemsize: int = 2) -> int:
    """Returns the number of blocks fused.  ``act_itemsize`` is the float
    activation byte width (2 bf16 / 4 f32) used by the VMEM gate for
    non-quantized blocks."""
    producers = graph.producers()
    consumers = graph.consumers()
    qmeta = graph.meta.get("quant", {})

    def sole(v):
        return len(consumers.get(v, [])) == 1 and v not in graph.outputs

    fused = 0
    remove: set = set()
    new_nodes: List[Node] = []
    for n in graph.nodes:
        if n.name in remove:
            continue
        if (n.op == "Eltwise" and n.attrs.get("operation", "SUM") == "SUM"
                and n.attrs.get("activation") == "relu"
                and not n.attrs.get("coeffs") and len(n.inputs) == 2):
            for x_val, c_val in (n.inputs, n.inputs[::-1]):
                c = producers.get(c_val)
                if not (_conv_is(c, 1, None) and sole(c_val)):
                    continue
                b = producers.get(c.inputs[0])
                if not (_conv_is(b, 3, "relu") and sole(c.inputs[0])):
                    continue
                a = producers.get(b.inputs[0])
                if not (_conv_is(a, 1, "relu") and sole(b.inputs[0])):
                    continue
                if a.inputs[0] != x_val:
                    continue
                # channel constraints: C == Co, all biases present
                if not all(len(m.params) > 1 for m in (a, b, c)):
                    continue
                spec = graph.specs.get(x_val)
                if spec is None or spec.rank != 4:
                    continue
                _, H, W, C = spec.shape
                Cm = a.attrs["num_output"]
                quant = all(m.name in qmeta
                            and qmeta[m.name].get("x_scale") is not None
                            for m in (a, b, c)) if qmeta else False
                # Region policy: the model's region table, else the
                # default; then a single-image min-slab plan must exist.
                regions = graph.meta.get("chain_regions", {})
                key = f"{H}x{W}x{C}x{Cm}"
                worth = regions.get(key, regions.get(
                    "*", region_worth_fusing(H, W, C, Cm, quant)))
                if not worth:
                    continue
                # fp weights are cast to the compute dtype at lowering,
                # so they share the activation byte width; a quantized
                # block's output may still be bf16 (s_out is decided
                # later) — size for the worst case
                a_item = w_item = 1 if quant else act_itemsize
                o_item = 2 if quant else act_itemsize
                if chain_plan(1, H, W, C, Cm, 1, a_item, w_item,
                              out_item=o_item) is None:
                    continue
                meta = {}
                if quant:
                    meta = {
                        "s_x": qmeta[a.name]["x_scale"],
                        "s_y1": qmeta[b.name]["x_scale"],
                        "s_y2": qmeta[c.name]["x_scale"],
                        # int8 out is decided by
                        # _propagate_int8_through_blocks below
                        "s_out": None,
                    }
                elif any(m.name in qmeta for m in (a, b, c)):
                    # mixed/weight-only: stay on the per-layer path
                    continue

                node = Node(
                    name=n.name + "/fused", op="FusedBottleneck",
                    inputs=[x_val], outputs=list(n.outputs),
                    attrs={"quant": quant, **meta},
                    params=[a.params[0], a.params[1], b.params[0],
                            b.params[1], c.params[0], c.params[1]])
                if quant:
                    graph.meta.setdefault("quant", {})[node.name] = {
                        "w_scales": [qmeta[a.name]["w_scale"],
                                     qmeta[b.name]["w_scale"],
                                     qmeta[c.name]["w_scale"]],
                        "x_scale": qmeta[a.name]["x_scale"],
                    }
                remove.update((a.name, b.name, c.name, n.name))
                new_nodes.append(node)
                fused += 1
                break

    if fused:
        out = []
        for n in graph.nodes:
            if n.name in remove:
                # insert the fused node where the Eltwise was
                for fnode in new_nodes:
                    if fnode.name == n.name + "/fused":
                        out.append(fnode)
                        break
            else:
                out.append(n)
        graph.nodes = out
        graph.validate()
        _propagate_int8_through_blocks(graph)
    return fused


def fuse_chains(graph: Graph, act_itemsize: int = 2) -> int:
    """Merge runs of same-shape FusedBottleneck nodes into FusedChain nodes
    (a ResNet stage's 2-5 identity blocks share one (H, W, C, Cm)
    signature).  Runs after fuse_bottlenecks.  Returns the number of
    chains formed."""
    consumers = graph.consumers()
    qmeta = graph.meta.get("quant", {})

    # Collect maximal runs of chainable neighbours, in node order.
    runs: List[List[Node]] = []
    cur: List[Node] = []

    def flush():
        if len(cur) >= 2:
            runs.append(list(cur))
        cur.clear()

    def chainable(prev: Node, n: Node) -> bool:
        if prev.outputs[0] != n.inputs[0]:
            return False
        if prev.outputs[0] in graph.outputs:
            return False
        cons = consumers.get(prev.outputs[0], [])
        if len(cons) != 1 or cons[0] is not n:
            return False
        if prev.attrs.get("quant") != n.attrs.get("quant"):
            return False
        w1p, w1n = graph.params[prev.params[0]], graph.params[n.params[0]]
        return w1p.shape == w1n.shape

    for n in graph.nodes:
        if n.op != "FusedBottleneck":
            flush()
            continue
        if cur and chainable(cur[-1], n):
            cur.append(n)
        else:
            flush()
            cur.append(n)
    flush()

    if not runs:
        return 0

    # Split runs that the gate's VMEM budget refuses (e.g. ResNet stage 5:
    # 2 blocks x 4.5 MB int8 weights).
    def fits(blocks):
        x_val = blocks[0].inputs[0]
        _, H, W, C = graph.specs[x_val].shape
        w2 = graph.params[blocks[0].params[2]]
        Cm = w2.shape[-1]
        quant = w2.dtype == np.int8
        a_item = w_item = 1 if quant else act_itemsize
        o_item = act_itemsize
        if quant:
            o_item = 1 if blocks[-1].attrs.get("s_out") else 2
        return chain_plan(1, H, W, C, Cm, len(blocks), a_item,
                          w_item, out_item=o_item) is not None

    split_runs: List[List[Node]] = []
    for blocks in runs:
        start = 0
        while start < len(blocks):
            end = len(blocks)
            while end > start + 1 and not fits(blocks[start:end]):
                end -= 1
            if end - start >= 2:
                split_runs.append(blocks[start:end])
            start = end
    runs = split_runs
    if not runs:
        return 0

    replaced = {}          # first-node name -> chain node
    remove: set = set()
    for blocks in runs:
        nb = len(blocks)
        w1 = np.stack([np.asarray(graph.params[b.params[0]]).reshape(
            graph.params[b.params[0]].shape[-2],
            graph.params[b.params[0]].shape[-1]) for b in blocks])
        b1 = np.stack([np.asarray(graph.params[b.params[1]],
                                  dtype=np.float32) for b in blocks])
        w2 = np.stack([np.asarray(graph.params[b.params[2]]).reshape(
            -1, graph.params[b.params[2]].shape[-1]) for b in blocks])
        b2 = np.stack([np.asarray(graph.params[b.params[3]],
                                  dtype=np.float32) for b in blocks])
        w3 = np.stack([np.asarray(graph.params[b.params[4]]).reshape(
            graph.params[b.params[4]].shape[-2],
            graph.params[b.params[4]].shape[-1]) for b in blocks])
        b3 = np.stack([np.asarray(graph.params[b.params[5]],
                                  dtype=np.float32) for b in blocks])

        name = blocks[0].name + f"/chain{nb}"
        pnames = [f"{name}/{p}" for p in
                  ("w1", "b1", "w2", "b2", "w3", "b3")]
        for pn, arr in zip(pnames, (w1, b1, w2, b2, w3, b3)):
            graph.params[pn] = arr

        quant = bool(blocks[0].attrs.get("quant"))
        attrs = {"quant": quant, "nb": nb}
        if quant:
            attrs["sx"] = tuple(float(b.attrs["s_x"]) for b in blocks)
            attrs["sy1"] = tuple(float(b.attrs["s_y1"]) for b in blocks)
            attrs["sy2"] = tuple(float(b.attrs["s_y2"]) for b in blocks)
            s_out = blocks[-1].attrs.get("s_out")
            attrs["s_out"] = float(s_out) if s_out else None
            graph.meta.setdefault("quant", {})[name] = {
                "w1s": np.stack([np.asarray(qmeta[b.name]["w_scales"][0],
                                            np.float32) for b in blocks]),
                "w2s": np.stack([np.asarray(qmeta[b.name]["w_scales"][1],
                                            np.float32) for b in blocks]),
                "w3s": np.stack([np.asarray(qmeta[b.name]["w_scales"][2],
                                            np.float32) for b in blocks]),
                "x_scale": float(blocks[0].attrs["s_x"]),
            }
        node = Node(name=name, op="FusedChain",
                    inputs=list(blocks[0].inputs),
                    outputs=list(blocks[-1].outputs),
                    attrs=attrs, params=pnames)
        replaced[blocks[0].name] = node
        remove.update(b.name for b in blocks)

    out = []
    merged_params = set()
    for n in graph.nodes:
        if n.name in replaced:
            out.append(replaced[n.name])
        if n.name in remove:
            merged_params.update(n.params)
        else:
            out.append(n)
    graph.nodes = out
    # drop the per-block originals the stacked copies replaced: the engine
    # moves every graph.params entry to the device
    still_used = {p for n in graph.nodes for p in n.params}
    for p in merged_params - still_used:
        graph.params.pop(p, None)
    graph.validate()
    return len(runs)


def _propagate_int8_through_blocks(graph: Graph) -> None:
    """Second pass: a quantized FusedBottleneck emits int8 directly when
    every consumer reads int8 at the same (calibrated) scale."""
    qmeta = graph.meta.get("quant", {})
    vscales = graph.meta.get("value_scales", {})
    consumers = graph.consumers()
    fused_by_name = {n.name: n for n in graph.nodes
                     if n.op == "FusedBottleneck"}
    for n in fused_by_name.values():
        if not n.attrs.get("quant"):
            continue
        out = n.outputs[0]
        scale = vscales.get(out)
        if scale is None or out in graph.outputs:
            continue
        ok = True
        for c in consumers.get(out, []):
            if c.op == "FusedBottleneck":
                if not c.attrs.get("quant") or c.attrs.get("s_x") != scale:
                    ok = False
            elif c.op in ("Convolution", "InnerProduct"):
                info = qmeta.get(c.name)
                if not info or info.get("x_scale") != scale \
                        or c.inputs[0] != out:
                    ok = False
            else:
                ok = False
        if ok and consumers.get(out):
            n.attrs["s_out"] = float(scale)
