"""Print a model's per-layer summary table (shapes, params, FLOPs, bytes)
— the port's counterpart of ``tools/summarize.py``:

    python -m feathercnn_tpu_torch.tools.summarize --model resnet50 \\
        [--batch 1] [--raw]
    python -m feathercnn_tpu_torch.tools.summarize --ftpu out.ftpu --top 20

The optimized graph's table comes from ``Engine.summary`` (the engine's
passes; no forward runs), on the GPU unless ``--device cpu`` is given;
``--raw`` summarizes the graph as built or converted.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="zoo model name")
    src.add_argument("--ftpu", help="path to a .ftpu artifact")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--top", type=int, default=None,
                    help="only the N most FLOP-heavy layers")
    ap.add_argument("--raw", action="store_true",
                    help="summarize the unfused graph (as converted)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to build the engine on the CPU (default: "
                         "the GPU)")
    args = ap.parse_args(argv)

    from ..engine import Engine
    from ..utils.summary import summarize

    if args.model:
        from ..models import MODEL_BUILDERS
        g = MODEL_BUILDERS[args.model](batch=args.batch)
    else:
        from ..model_format import load_ftpu
        g = load_ftpu(args.ftpu)

    if args.raw:
        print(summarize(g, top=args.top))
    else:
        print(Engine(g, optimize_graph=True, device=args.device).summary(
            top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
