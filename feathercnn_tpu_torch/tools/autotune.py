"""Measurement-driven choices baked into a model — the port's counterpart
of ``tools/autotune.py``, on the GPU unless ``--device cpu`` is given:

- ``tune``: each conv's candidate algorithms (the reference's: ``xla``,
  ``gemm1x1`` or ``implicit``, ``winograd`` on float runs) timed in
  isolation through ``kernels/dispatch.conv_forward`` with
  ``utils.timing.device_bench``, once per shape signature; the fastest wins
  and lands in ``algo_overrides`` where it is not ``xla``.  On the int8
  path ``xla`` and ``gemm1x1``/``implicit`` reach the same hand-written
  kernel (B1 for a 1x1 conv, B2 for a kxk one: the dispatcher's int8
  "xla" branch runs PyTorch's missing int8 conv there), so each row records
  the kernel each candidate launched (on the card) beside its time;
- ``tune_regions``: for each bottleneck-chain signature, the fused-chain
  kernel (B4, a ``FusedChain``/``FusedBottleneck`` node) against the same
  blocks on the per-layer path, each node's lowering timed on the value a
  forward gives it; the winner per signature lands in
  ``meta["chain_regions"]``;
- ``tune_flags``: the paired round-robin A/B of the boolean EngineConfig
  flags whose flip changes what the port runs, with the reference's
  numerics gate; winners land in ``meta["config_overrides"]``.  The TPU
  formulation flags (``nms_blocked``, ``roipool_table``, ``lrn_band``,
  ``shuffle_matmul``, ``topk_radix``) pick among exact forms on the TPU
  that the port computes one way (``config.py``): flipping them would rank
  noise, so they are left out and the tool says so.

``--ftpu`` bakes the results into the file's meta; ``Engine.from_path``
(and so the serving CLI) applies them:

    python -m feathercnn_tpu_torch.tools.autotune --model resnet50 \\
        --batch 128 --quant w8a8 [--regions | --flags] [--ftpu m.ftpu]

Each row also carries the layer's shapes, GOP, MB and its bound on an H100
SXM (the larger of its bytes over 3.35 TB/s and its operations over the
dense peak of its type: 1,979 int8 TOP/s, 989 bf16).  A candidate that
fails raises: nothing falls back.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np

__all__ = ["layer_table", "measure_algos", "tune", "tune_regions",
           "tune_flags", "main"]

# Published dense peaks of one H100 SXM and its memory rate.
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# The reference's flags (tools/autotune.py) whose flip changes the graph
# or the lowering the port runs, and those that pick a TPU formulation the
# port ignores.
_TUNABLE_FLAGS = ("merge_siblings", "merge_concats", "int8_grouped",
                  "int8_requant_ops", "concat_dus", "fold_scale_chains")
_IGNORED_FLAGS = ("nms_blocked", "roipool_table", "lrn_band",
                  "shuffle_matmul", "topk_radix")
# Flags whose flip moves values onto other quant grids: gated on numerics
# too (the flipped engine's cosine against the float oracle may not trail
# the baseline's by more than _NUMERIC_MARGIN).
_NUMERIC_FLAGS = ("concat_dus", "int8_requant_ops", "int8_grouped",
                  "merge_concats", "fold_scale_chains")
_NUMERIC_MARGIN = 0.01


def _kernel_hw(n):
    return (n.attrs.get("kernel_h", n.attrs.get("kernel_size", 1)),
            n.attrs.get("kernel_w", n.attrs.get("kernel_size", 1)))


def layer_table(graph, quant):
    """One row per conv/FC layer of ``graph`` (shapes inferred): its
    shapes, GOP, MB moved (int8 edges at 1 byte under w8a8, else 2; int8
    weights under any quant), operations per byte, and the bound on an
    H100 SXM in ms and as TOP/s."""
    rows = []
    for n in graph.nodes:
        if n.op not in ("Convolution", "InnerProduct"):
            continue
        in_spec = graph.specs[n.inputs[0]]
        out_spec = graph.specs[n.outputs[0]]
        w = graph.params[n.params[0]]
        if n.op == "Convolution":
            kh, kw = _kernel_hw(n)
            nb, oh, ow, co = out_spec.shape
            cin = in_spec.shape[-1]
            ops = 2.0 * nb * oh * ow * co * kh * kw * (
                cin / n.attrs.get("group", 1))
        else:
            ops = 2.0 * out_spec.shape[0] * int(np.prod(w.shape))
        act_bytes = 1 if quant == "w8a8" else 2
        nbytes = (in_spec.size * act_bytes + out_spec.size * act_bytes
                  + w.size * (1 if quant else 2))
        peak = PEAK_OPS["int8" if quant == "w8a8" else "bfloat16"]
        bound_s = max(ops / peak, nbytes / PEAK_BYTES)
        rows.append({
            "layer": n.name, "op": n.op,
            "in": list(in_spec.shape), "out": list(out_spec.shape),
            "kernel": list(_kernel_hw(n)) if n.op == "Convolution"
            else None,
            "gflops": ops / 1e9, "mbytes": nbytes / 1e6,
            "intensity": ops / nbytes,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("operations" if ops / peak >= nbytes / PEAK_BYTES
                         else "bytes"),
            "roofline_tflops": ops / bound_s / 1e12,
        })
    return rows


def _counts():
    from ..kernels import dispatch
    return {k: getattr(dispatch, k).launches
            for k in ("matmul_epilogue", "conv2d_implicit_gemm",
                      "depthwise_conv2d", "depthwise_conv2d_int8")}


def measure_algos(graph, rows, dtype, quant, iters=20, only_algos=None,
                  device=None):
    """Time each conv layer's candidate algorithms in isolation (on a
    seeded input of its shape in ``dtype``), once per shape signature
    (input shape, kernel, stride, group, outputs, int8 input), and record
    per row ``measured_ms``, ``kernels`` (the hand-written kernel each
    candidate launched on the card, "library" for none, "plain" on the
    CPU), ``best_algo``, ``achieved_tflops`` and ``sol_fraction``."""
    import functools

    import torch

    from ..config import EngineConfig
    from ..engine import resolve_device
    from ..kernels import dispatch
    from ..ops.lowering import LoweringCtx
    from ..utils.timing import device_bench

    dev = resolve_device(device)
    node_map = {n.name: n for n in graph.nodes}
    rng = np.random.default_rng(0)
    sig_cache = {}
    for row in rows:
        n = node_map[row["layer"]]
        if n.op != "Convolution":
            continue
        in_spec = graph.specs[n.inputs[0]]
        sig = (in_spec.shape, _kernel_hw(n)[0], n.attrs.get("stride", 1),
               n.attrs.get("group", 1), n.attrs["num_output"],
               graph.meta.get("quant", {}).get(n.name, {}).get("x_scale")
               is not None)
        if sig in sig_cache:
            cached = sig_cache[sig]
            row.update({k: cached[k] for k in
                        ("measured_ms", "kernels", "best_algo",
                         "achieved_tflops") if k in cached})
            if "measured_ms" in row:
                row["sol_fraction"] = round(
                    row["achieved_tflops"] / row["roofline_tflops"], 3)
            continue
        x = torch.from_numpy(rng.normal(size=in_spec.shape).astype(
            np.float32)).to(getattr(torch, dtype)).to(dev)
        w = torch.from_numpy(np.asarray(graph.params[n.params[0]])).to(dev)
        bias = (torch.from_numpy(np.asarray(
            graph.params[n.params[1]], np.float32)).to(dev)
            if len(n.params) > 1 else None)
        kh = _kernel_hw(n)[0]
        candidates = ["xla"]
        if n.attrs.get("group", 1) == 1:
            if kh == 1:
                candidates.append("gemm1x1")
            else:
                candidates.append("implicit")
                # winograd dequantizes: it competes on float runs only
                if kh == 3 and n.attrs.get("stride", 1) == 1 and not quant:
                    candidates.append("winograd")
        if only_algos:
            candidates = [c for c in candidates if c in only_algos]
        row["measured_ms"], row["kernels"] = {}, {}
        for algo in candidates:
            cfg = EngineConfig(compute_dtype=dtype, backend="cuda",
                               quant=quant, algo_overrides=((n.name, algo),))
            ctx = LoweringCtx(graph, cfg, dev)
            fn = functools.partial(dispatch.conv_forward, n, ctx=ctx)
            before = _counts()
            with torch.inference_mode():
                fn(x, w, bias)
            launched = [k for k, v in _counts().items() if v > before[k]]
            row["kernels"][algo] = ("+".join(launched) if launched else
                                    "plain" if dev.type == "cpu"
                                    else "library")
            t = device_bench(lambda a: fn(a, w, bias), [x], iters=iters)
            # a fast layer: time enough calls for a 50 ms slope
            if t * iters < 0.03:
                it2 = min(int(0.05 / max(t, 1e-7)), 5000)
                if it2 > iters:
                    t = device_bench(lambda a: fn(a, w, bias), [x],
                                     iters=it2)
            row["measured_ms"][algo] = round(max(t, 1e-7) * 1e3, 5)
        ok = [(v, k) for k, v in row["measured_ms"].items()]
        if not ok:
            continue
        best = min(ok)
        row["best_algo"] = best[1]
        row["achieved_tflops"] = round(row["gflops"] / best[0], 1)
        row["sol_fraction"] = round(
            row["achieved_tflops"] / row["roofline_tflops"], 3)
        sig_cache[sig] = row
    return rows


def tune(graph, dtype: str, quant, iters: int = 15, device=None):
    """(algo_overrides as {layer: algo} where the winner is not "xla",
    the rows) of ``graph`` (an engine's optimized graph)."""
    rows = layer_table(graph, quant)
    rows = measure_algos(graph, rows, dtype, quant, iters=iters,
                         device=device)
    overrides = {}
    for r in rows:
        best = r.get("best_algo")
        if best and best != "xla":
            overrides[r["layer"]] = best
    return overrides, rows


def _region(graph, x_val, out_val):
    """The nodes of ``graph``, in order, that compute ``out_val`` from
    ``x_val`` (a fused chain's blocks on the unchained graph)."""
    producer = {v: n for n in graph.nodes for v in n.outputs}
    names, todo = set(), [out_val]
    while todo:
        v = todo.pop()
        n = producer.get(v)
        if v == x_val or n is None or n.name in names:
            continue
        names.add(n.name)
        todo += n.inputs
    return [n for n in graph.nodes if n.name in names]


def tune_regions(graph, dtype: str, quant, iters: int = 15, device=None,
                 x=None):
    """{chain signature "HxWxCxCm": fuse} for every fusable
    bottleneck-chain signature of ``graph``: the chain node's lowering (the
    fused-chain kernel) against its blocks' nodes on the per-layer path
    (B1, B2 and the int8 Eltwise), each on the value that one forward of
    ``x`` (seeded where None) gives its input, timed by ``device_bench``;
    the chain wins where it is faster.  Written to ``meta["chain_regions"]``
    it is what ``passes_fusion`` reads."""
    import torch

    from ..config import EngineConfig
    from ..engine import Engine, resolve_device
    from ..ops.lowering import lower_node
    from ..utils.timing import default_extra_inputs, device_bench

    dev = resolve_device(device)
    cfg = EngineConfig(compute_dtype=dtype, backend="cuda", quant=quant)
    g = copy.deepcopy(graph)
    g.meta["chain_regions"] = {"*": True}     # force the candidates
    chained = Engine(g, cfg.replace(fuse_chains=True), device=dev)
    g.meta.pop("chain_regions")
    unchained = Engine(g, cfg, device=dev)
    names = list(g.inputs)
    spec0 = g.inputs[names[0]]
    if x is None:
        x = np.random.default_rng(0).normal(
            size=spec0.shape).astype(np.float32)
    feed = {names[0]: x, **default_extra_inputs(g)}
    chains = [n for n in chained.graph.nodes
              if n.op in ("FusedChain", "FusedBottleneck")]
    inputs = sorted({n.inputs[0] for n in chains})
    at_chain = chained.run(feed, extract=inputs)
    at_layers = unchained.run(feed, extract=inputs)
    cp, up = chained._prepare_params(), unchained._prepare_params()

    decisions = {}
    for n in chains:
        _, H, W, C = chained.graph.specs[n.inputs[0]].shape
        Cm = chained.graph.params[n.params[2]].shape[-1]
        nb = n.attrs.get("nb", 1)
        key = f"{H}x{W}x{C}x{Cm}"
        if key in decisions:
            continue
        region = _region(unchained.graph, n.inputs[0], n.outputs[0])

        def chain(a, n=n):
            return lower_node(n, [a], [cp[p] for p in n.params],
                              chained._ctx)[0]

        def layers(a, n=n, region=region):
            env = {n.inputs[0]: a}
            for m in region:
                outs = lower_node(m, [env[i] for i in m.inputs],
                                  [up[p] for p in m.params], unchained._ctx)
                env.update(zip(m.outputs, outs))
            return env[n.outputs[0]]

        with torch.inference_mode():
            t_chain = device_bench(chain, [at_chain[n.inputs[0]]],
                                   iters=iters)
            t_layers = device_bench(layers, [at_layers[n.inputs[0]]],
                                    iters=iters)
        use_chain = t_chain < t_layers
        decisions[key] = bool(use_chain)
        print(f"{key} nb={nb}: chain {t_chain*1e3:.3f} ms vs layers "
              f"{t_layers*1e3:.3f} ms ({len(region)} nodes) -> "
              f"{'chain' if use_chain else 'layers'}")
    return decisions


def tune_flags(graph, dtype: str, quant, rounds: int = 5, iters: int = 20,
               threshold: float = 0.01, device=None):
    """Whole-model paired A/B of the boolean EngineConfig flags (the
    reference's ``tune_flags``): the baseline config and one engine per
    flipped flag, slope-timed round-robin; a flip lands in the returned
    ``config_overrides`` when the median of its per-round paired ratios
    beats the baseline by more than ``threshold`` and, for a grid-moving
    flag on a quantized single-input graph without NMS heads, its cosine
    against the float oracle trails the baseline's by at most
    ``_NUMERIC_MARGIN``.  Each flip is measured against the all-defaults
    baseline: interactions are not explored."""
    import dataclasses as dc

    from ..config import EngineConfig
    from ..engine import Engine, resolve_device
    from ..utils.timing import engine_loop, slope_time

    dev = resolve_device(device)
    defaults = {f.name: f.default for f in dc.fields(EngineConfig)}
    base_cfg = EngineConfig(compute_dtype=dtype, backend="cuda",
                            quant=quant)
    print(f"left out (TPU formulations the port computes one way): "
          f"{', '.join(_IGNORED_FLAGS)}", file=sys.stderr, flush=True)
    ops = {n.op for n in graph.nodes}
    relevant = {"concat_dus": {"Concat"}}
    variants = [("base", base_cfg)]
    for flag in _TUNABLE_FLAGS:
        need = relevant.get(flag)
        if need is not None and not (ops & need):
            continue
        variants.append((flag, base_cfg.replace(
            **{flag: not defaults[flag]})))

    gate_numerics = (quant is not None and len(graph.inputs) == 1
                     and not ({"Proposal", "DetectionOutput"} & ops))
    x_gate = ref_out = None
    if gate_numerics:
        spec0 = next(iter(graph.inputs.values()))
        x_gate = np.random.default_rng(0).normal(
            size=spec0.shape).astype(np.float32)
        g0 = copy.deepcopy(graph)
        g0.meta.pop("config_overrides", None)
        ref_out = Engine(g0, EngineConfig(compute_dtype=dtype),
                         device=dev)(x_gate).float().cpu().numpy().ravel()

    def _cos_vs_ref(eng):
        out = eng(x_gate).double().cpu().numpy().ravel()
        r = ref_out.astype(np.float64)
        return float(r @ out / (np.linalg.norm(r) * np.linalg.norm(out)
                                + 1e-12))

    loops, cosines = {}, {}
    for name, cfg in variants:
        g = copy.deepcopy(graph)
        g.meta.pop("config_overrides", None)   # measure from scratch
        eng = Engine(g, cfg, device=dev)
        if gate_numerics and (name == "base" or name in _NUMERIC_FLAGS):
            cosines[name] = _cos_vs_ref(eng)
        loop, params, xd = engine_loop(eng)
        float(loop(params, xd, 1))              # weights and constants made
        loops[name] = (loop, params, xd)
        print(f"built {name}"
              + (f" (cosine {cosines[name]:.5f})"
                 if name in cosines else ""),
              file=sys.stderr, flush=True)

    times = {name: [] for name, _ in variants}
    for _ in range(rounds):
        for name, _ in variants:
            loop, params, xd = loops[name]
            times[name].append(slope_time(loop, params, xd, iters=iters))

    overrides = {}
    base_t = np.asarray(times["base"])
    for flag in _TUNABLE_FLAGS:
        if flag not in times:
            continue
        ratios = base_t / np.asarray(times[flag])  # > 1: the flip wins
        gain = float(np.median(ratios)) - 1.0
        flipped = not defaults[flag]
        print(f"{flag}={flipped}: {gain*100:+.1f}% vs default",
              file=sys.stderr, flush=True)
        if gain > threshold:
            if flag in cosines and \
                    cosines[flag] < cosines["base"] - _NUMERIC_MARGIN:
                print(f"{flag}={flipped}: REJECTED by numerics gate "
                      f"(cosine {cosines[flag]:.5f} vs base "
                      f"{cosines['base']:.5f})", file=sys.stderr,
                      flush=True)
                continue
            overrides[flag] = flipped
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--ftpu", default=None,
                    help="tune a converted model instead of a zoo model")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--regions", action="store_true",
                    help="also tune region fusion (chain vs per-layer "
                         "path per bottleneck signature)")
    ap.add_argument("--flags", action="store_true",
                    help="paired A/B of the boolean EngineConfig flags; "
                         "winners land in meta['config_overrides']")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    from ..config import EngineConfig
    from ..engine import Engine
    from ..model_format import load_ftpu, save_ftpu
    from ..models import MODEL_BUILDERS

    if args.ftpu:
        graph = load_ftpu(args.ftpu, mmap_weights=False)
    else:
        graph = MODEL_BUILDERS[args.model](batch=args.batch,
                                           with_softmax=False)
    if args.flags:
        if args.quant == "w8a8" and "act_scales" not in graph.meta:
            if args.ftpu:
                print(f"warning: {args.ftpu} has no baked act_scales; "
                      "layers degrade to weight-only during the flag A/B: "
                      "calibrate and re-save the artifact first",
                      file=sys.stderr)
            else:
                from ..quant import calibrate
                g_cal = MODEL_BUILDERS[args.model](batch=8,
                                                   with_softmax=False)
                spec0 = next(iter(g_cal.inputs.values()))
                cal = [np.random.default_rng(1).normal(
                    size=spec0.shape).astype(np.float32)]
                calibrate(g_cal, cal, method="max",
                          config=EngineConfig(compute_dtype=args.dtype),
                          device=args.device)
                graph.meta.update({k: g_cal.meta[k]
                                   for k in ("act_scales", "value_scales")})
        flag_overrides = tune_flags(graph, args.dtype, args.quant,
                                    iters=args.iters, device=args.device)
        print(f"\nflag decisions: {json.dumps(flag_overrides)}")
        graph.meta["config_overrides"] = flag_overrides
        if args.ftpu:
            save_ftpu(graph, args.ftpu)
            print(f"baked config_overrides into {args.ftpu} meta")
        return 0
    if args.regions:
        regions = tune_regions(graph, args.dtype, args.quant, args.iters,
                               device=args.device)
        print(f"\nregion decisions: {json.dumps(regions)}")
        graph.meta["chain_regions"] = regions
        if args.ftpu:
            save_ftpu(graph, args.ftpu)
            print(f"baked chain_regions into {args.ftpu} meta")
    eng = Engine(graph, EngineConfig(compute_dtype=args.dtype,
                                     quant=args.quant, backend="cuda"),
                 device=args.device)
    overrides, rows = tune(eng.graph, args.dtype, args.quant, args.iters,
                           device=args.device)
    for r in rows:
        if "measured_ms" in r:
            print(f"{r['layer']:28s} {r['measured_ms']} {r['kernels']} "
                  f"bound {r['bound_ms']:.4f} ms -> {r.get('best_algo')}")
    print(f"\n{len(overrides)} non-default choices")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(overrides, f, indent=1)
        print(f"wrote {args.out}  (pass to EngineConfig via "
              f"algo_overrides=tuple(json.load(f).items()))")
    if args.ftpu:
        graph.meta["algo_overrides"] = overrides
        save_ftpu(graph, args.ftpu)
        print(f"baked into {args.ftpu} meta")
    return 0


if __name__ == "__main__":
    sys.exit(main())
