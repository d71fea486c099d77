"""Per-layer blob diff between two engine configurations — the port's
counterpart of ``tools/diff_blobs.py`` (the Caffe-parity workflow of the
reference: dump blobs, diff them layer by layer), in one command:

    python -m feathercnn_tpu_torch.tools.diff_blobs --model squeezenet_v11 \\
        --a quant=none --b quant=w8a8 [--batch 2] [--threshold 0.999]
    python -m feathercnn_tpu_torch.tools.diff_blobs --ftpu model.ftpu \\
        --a backend=torch --b backend=cuda --device cpu

Runs both engines on one seeded input, extracts every layer output that
survives fusion in both, and prints per-layer cosine and max |diff| in
topological order: the first layer under the threshold is where the
configs part.  Exits 1 if the final output is under it.

A config spec is comma-separated EngineConfig fields (``quant=w8a8``,
``backend=cuda``, ``compute_dtype=float32``); ``quant=none`` clears
quantization.  The backend defaults to ``cuda`` (the hand-written kernels;
``torch`` is the plain oracle).  A w8a8 config triggers one shared
max-calibration on the probe input.  The engines run on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["parse_cfg", "cosine", "diff", "main"]


def parse_cfg(spec: str):
    out = {}
    for kv in filter(None, (spec or "").split(",")):
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.lower() == "none":
            v = None
        out[k] = v
    return out


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom == 0:
        return 1.0 if not (a.any() or b.any()) else 0.0
    return float(a @ b / denom)


def diff(fresh, cfg_a: dict, cfg_b: dict, batch=None, seed: int = 0,
         device=None):
    """(rows, output name): one row (value, cosine, max |diff|) per value
    both engines keep, in topological order, of the two configs (dicts of
    EngineConfig fields, ``backend`` defaulting to "cuda") on one seeded
    input of ``batch`` images (the graph's batch where None); ``fresh()``
    builds the graph anew."""
    from ..config import EngineConfig
    from ..engine import Engine, resolve_device
    from ..quant import calibrate
    from ..utils.timing import default_extra_inputs

    dev = resolve_device(device)
    g = fresh()
    names = list(g.inputs)
    spec = g.inputs[names[0]]
    batch = batch or spec.shape[0]
    x = {names[0]: np.random.default_rng(seed).normal(
        size=(batch,) + tuple(spec.shape[1:])).astype(np.float32)}
    x.update({k: np.repeat(v[:1], batch, 0)
              for k, v in default_extra_inputs(g).items()})
    if "w8a8" in (cfg_a.get("quant"), cfg_b.get("quant")):
        calibrate(g, [x], method="max", device=dev)

    engines = {}
    for tag, ckw in (("a", cfg_a), ("b", cfg_b)):
        gg = fresh()
        gg.meta.update({k: v for k, v in g.meta.items()
                        if k in ("act_scales", "value_scales")})
        engines[tag] = Engine(gg, EngineConfig(**{"backend": "cuda",
                                                  **ckw}), device=dev)

    def live_values(eng):
        return [o for n in eng.graph.nodes for o in n.outputs]

    in_b = set(live_values(engines["b"]))
    common = [v for v in live_values(engines["a"]) if v in in_b]
    ra = engines["a"].run(x, extract=common)
    rb = engines["b"].run(x, extract=common)
    rows = []
    for v in common:
        a = ra[v].float().cpu().numpy()
        b = rb[v].float().cpu().numpy()
        md = float(np.abs(a - b).max()) if a.shape == b.shape else np.nan
        rows.append((v, cosine(a, b), md))
    return rows, engines["a"].graph.outputs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="zoo model name")
    src.add_argument("--ftpu", help="path to a .ftpu artifact")
    ap.add_argument("--a", default="quant=none", help="config A spec")
    ap.add_argument("--b", default="quant=w8a8", help="config B spec")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=0.999)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    if args.model:
        import inspect

        from ..models import MODEL_BUILDERS
        builder = MODEL_BUILDERS[args.model]
        kw = ({"with_softmax": False}
              if "with_softmax" in inspect.signature(builder).parameters
              else {})

        def fresh():
            return builder(batch=args.batch, **kw)
    else:
        from ..model_format import load_ftpu

        def fresh():
            return load_ftpu(args.ftpu)

    rows, out_name = diff(fresh, parse_cfg(args.a), parse_cfg(args.b),
                          args.batch if args.model else None, args.seed,
                          args.device)
    worst, first_bad = (1.0, None), None
    for v, c, md in rows:
        flag = " <-- DIVERGES" if c < args.threshold else ""
        if flag and first_bad is None:
            first_bad = v
        if c < worst[0]:
            worst = (c, v)
        print(f"{v:48s} cos={c:.6f} max|d|={md:10.4g}{flag}")
    final = next(c for v, c, _ in rows if v == out_name)
    print(f"\nfinal output {out_name!r}: cosine={final:.6f} "
          f"(worst layer {worst[1]!r}: {worst[0]:.6f}; "
          f"first divergence: {first_bad or 'none'})")
    return 0 if final >= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
