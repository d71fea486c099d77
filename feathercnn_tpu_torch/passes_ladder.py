"""Concat-ladder -> in-place buffer rewrite — a copy of
``feathercnn_tpu/passes_ladder.py`` (``EngineConfig.concat_dus``).

DenseNet-style blocks grow a feature map by one Concat per layer:

    c_i = Concat(c_{i-1}, y_i)          # channels C_i = C_{i-1} + k

Each c_i materializes: the running prefix is written C_i channels wide
and re-read C_i wide by the next concat, so a block of L layers moves
O(L^2 * k) bytes of pure copy traffic.  This pass replaces every maximal
ladder with ONE buffer at the final width:

    buf_1 = LadderInit(base, y_1)       # zero-padded to C_L
    buf_i = LadderAppend(buf_{i-1}, y_i, offset=C_{i-1})
    c_i   = LadderView(buf_i, channels=C_i)   # prefix slice, offset 0

The port's LadderAppend writes its k channels into the buffer in place
(``ops/lowering.py``), so every ``__buf`` value of a ladder is the same
storage, and a LadderView is a view of its channel prefix.  That is sound
because a ``__buf`` value has no reader but the next append and its own
view (checked at the end of the pass), and a view's prefix is never
written again.

int8 interplay: a quantized ladder must hold ONE scale, so the chain is
rewritten only when every chain Concat is int8-marked
(passthrough_int8 / concat_int8, quant/rewrite.py); the buffer adopts
the LAST concat's y_scale and every non-chain consumer's x_scale is
patched to match.  Values are still quantized exactly once (each y_i
lands on the buffer grid directly); the only numeric change is that
early-chain consumers read the s_L grid instead of their own s_i.
Skipped (chain left as plain Concats) when a consumer's quant role
cannot be patched.
"""

from __future__ import annotations

from typing import List

from .ir import Graph, Node, infer_shapes

__all__ = ["dus_concat_ladders"]

_PATCHABLE_X_SCALE = ("Convolution", "InnerProduct", "Scale", "LRN")


def _chain_axis_ok(node: Node, rank: int) -> bool:
    axis = node.attrs.get("axis", -1)
    return axis % rank == rank - 1


def _check_buffer_readers(graph: Graph) -> None:
    """Each ``__buf`` value is read by at most one LadderAppend (as its
    buffer) and by LadderViews only: the in-place appends rely on it."""
    consumers = graph.consumers()
    for n in graph.nodes:
        if n.op not in ("LadderInit", "LadderAppend"):
            continue
        v = n.outputs[0]
        users = consumers.get(v, [])
        appends = [u for u in users if u.op == "LadderAppend"]
        assert (v not in graph.outputs and len(appends) <= 1
                and all(u.inputs.index(v) == 0 and u.inputs.count(v) == 1
                        and (u.op == "LadderView" or u in appends)
                        for u in users)), \
            f"ladder buffer {v!r} read by {[u.name for u in users]}"


def dus_concat_ladders(graph: Graph, min_len: int = 3) -> int:
    """Rewrite concat ladders of length >= ``min_len``.  Returns the
    number of ladders rewritten.  Requires specs (runs infer_shapes)."""
    infer_shapes(graph)
    consumers = graph.consumers()
    qmeta = graph.meta.get("quant", {})
    value_scales = graph.meta.get("value_scales", {})

    def _is_chain_concat(n: Node) -> bool:
        return (n.op == "Concat" and len(n.inputs) >= 2
                and _chain_axis_ok(n, graph.specs[n.inputs[0]].rank))

    # ---- find maximal ladders -----------------------------------------
    # link a -> b when b is the UNIQUE chain-concat reading a's output as
    # its running prefix (inputs[0]); heads are link-less chain concats.
    link = {}
    linked_to = set()
    for n in graph.nodes:
        if not _is_chain_concat(n):
            continue
        nxt = [c for c in consumers.get(n.outputs[0], [])
               if _is_chain_concat(c) and c.inputs[0] == n.outputs[0]]
        if len(nxt) == 1:
            link[n.name] = nxt[0]
            linked_to.add(nxt[0].name)
    chains: List[List[Node]] = []
    for n in graph.nodes:
        if not _is_chain_concat(n) or n.name in linked_to:
            continue
        chain = [n]
        while chain[-1].name in link:
            chain.append(link[chain[-1].name])
        if len(chain) >= min_len:
            chains.append(chain)

    rewritten = 0
    for chain in chains:
        # ---- quant eligibility ----------------------------------------
        infos = [qmeta.get(c.name) for c in chain]
        quantized = all(
            i is not None and (i.get("passthrough_int8")
                               or i.get("concat_int8"))
            for i in infos)
        unquantized = all(i is None for i in infos)
        if not (quantized or unquantized):
            continue                    # mixed int8/float chain: keep
        if quantized:
            s_buf = infos[-1].get("y_scale")
            if s_buf is None:
                continue
            # every non-chain consumer must be scale-patchable: an op
            # whose qmeta carries an x_scale for this exact input (conv/
            # FC data input, requant_int8 Scale/LRN).  Transparent
            # passthrough consumers would cascade scale changes — bail.
            chain_names = {c.name for c in chain}
            patchable = all(
                u.name in chain_names
                or (u.op in _PATCHABLE_X_SCALE
                    and (qmeta.get(u.name) or {}).get("x_scale")
                    is not None
                    and u.inputs[0] == c.outputs[0])
                for c in chain
                for u in consumers.get(c.outputs[0], []))
            if not patchable:
                continue

        # ---- channel bookkeeping --------------------------------------
        widths = [graph.specs[c.outputs[0]].shape[-1] for c in chain]
        total = widths[-1]

        # ---- emit replacement nodes -----------------------------------
        replace = {}                    # old node name -> new node list
        prev_buf = None
        for idx, c in enumerate(chain):
            buf_name = c.outputs[0] + "__buf"
            if idx == 0:
                mark = Node(c.name + "__init", "LadderInit",
                            list(c.inputs), [buf_name],
                            {"total": total})
            else:
                mark = Node(c.name + "__append", "LadderAppend",
                            [prev_buf] + list(c.inputs[1:]), [buf_name],
                            {"offset": widths[idx - 1], "total": total})
            new_nodes = [mark]
            if quantized:
                info = infos[idx]
                in_vals = c.inputs if idx == 0 else c.inputs[1:]
                # Arrival grid per part: a concat_int8 member takes each
                # part at its own calibrated value scale, but a
                # passthrough_int8 member's parts arrive on the member's
                # SHARED edge grid (its y_scale) — the fixpoint in
                # quant/rewrite.py guarantees every producer emits at that
                # scale, which may differ from the part's calibrated one.
                if info.get("concat_int8"):
                    in_sc = [(float(value_scales[v])
                              if v in value_scales else None)
                             for v in in_vals]
                else:       # passthrough_int8
                    ms = float(info["y_scale"])
                    in_sc = [ms for _ in in_vals]
                qmeta[mark.name] = {
                    "ladder_int8": True,
                    "y_scale": float(s_buf),
                    "in_scales": in_sc,
                }
            # view: only when someone outside the chain reads c's output
            ext = [u for u in consumers.get(c.outputs[0], [])
                   if u.name not in {cc.name for cc in chain}]
            if ext or c.outputs[0] in graph.outputs:
                new_nodes.append(Node(
                    c.name + "__view", "LadderView", [buf_name],
                    [c.outputs[0]], {"channels": widths[idx]}))
            replace[c.name] = new_nodes
            prev_buf = buf_name

        out_nodes: List[Node] = []
        for n in graph.nodes:
            out_nodes.extend(replace.get(n.name, [n]))
        graph.nodes = out_nodes

        if quantized:
            # patch every external consumer's accepted scale + the
            # recorded value scale (serving/debug consistency)
            for idx, c in enumerate(chain):
                v = c.outputs[0]
                value_scales[v] = float(s_buf)
                for u in consumers.get(v, []):
                    uinfo = qmeta.get(u.name)
                    if uinfo is not None and u.op in _PATCHABLE_X_SCALE \
                            and uinfo.get("x_scale") is not None \
                            and u.inputs[0] == v:
                        uinfo["x_scale"] = float(s_buf)
        rewritten += 1

    if rewritten:
        infer_shapes(graph)
        graph.validate()
        _check_buffer_readers(graph)
    return rewritten
