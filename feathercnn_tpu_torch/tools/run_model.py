"""Run a model and time it — the port's counterpart of
``tools/run_model.py`` (the feather_test analog).

Loads a model (a ``.ftpu`` file or a zoo name), runs one forward (the
reference's compile step: the weights go to the device and each node's
constants are made), then times ``--loops`` forwards two ways: each one
synchronized on the host, and ``utils.timing``'s loop (``engine_loop`` +
``slope_time``: the slope between two loop lengths, CUDA events on the
card).  Prints ms per batch, images/s and the top-5 of the first images,
and optionally dumps named blobs for a parity check against another
runtime:

    python -m feathercnn_tpu_torch.tools.run_model resnet50 --batch 128 \\
        --quant w8a8 --dtype bfloat16
    python -m feathercnn_tpu_torch.tools.run_model model.ftpu \\
        --dump conv1 --dump-dir blobs --device cpu

``--quant w8a8`` on a zoo model calibrates it first (``method="max"``, on
the input).  The engine runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model", help=".ftpu path or zoo model name")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--loops", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--input", default=None,
                    help=".npy NHWC input (random if omitted)")
    ap.add_argument("--dump", action="append", default=[],
                    help="blob name to dump (repeatable)")
    ap.add_argument("--dump-dir", default=".")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    ap.add_argument("--config", default=None,
                    help="EngineConfig JSON file (overrides "
                         "--dtype/--quant/--backend)")
    args = ap.parse_args(argv)

    import torch

    from ..config import EngineConfig
    from ..engine import Engine, resolve_device
    from ..utils.timing import default_extra_inputs, engine_loop, slope_time

    device = resolve_device(args.device)
    if args.config:
        cfg = EngineConfig.from_json(args.config)
    else:
        cfg = EngineConfig(compute_dtype=args.dtype, quant=args.quant,
                           backend=args.backend)
    if os.path.exists(args.model):
        from ..model_format import load_ftpu
        graph = load_ftpu(args.model)
    else:
        from ..models import MODEL_BUILDERS
        graph = MODEL_BUILDERS[args.model](batch=args.batch)
    in_name = next(iter(graph.inputs))
    spec = graph.inputs[in_name]
    shape = (args.batch,) + tuple(spec.shape[1:])
    if args.input:
        x = np.load(args.input).astype(np.float32)
    else:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    extras = {k: np.repeat(v[:1], len(x), 0)
              for k, v in default_extra_inputs(graph).items()}
    if cfg.quant == "w8a8" and "act_scales" not in graph.meta:
        from ..quant import calibrate
        calibrate(graph, [{in_name: x, **extras}], method="max",
                  device=device)
    eng = Engine(graph, cfg, device=device)
    print(f"{eng.graph.name}: {len(eng.graph.nodes)} layers, input "
          f"{x.shape}, on {eng.device}")

    feed = {in_name: torch.from_numpy(x).to(device),
            **{k: torch.from_numpy(v).to(device) for k, v in extras.items()}}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = eng.run(feed, extract=args.dump)
    first = out[eng.output_names[0]].float().cpu().numpy()
    print(f"first forward (weights to the device, constants made): "
          f"{time.perf_counter() - t0:.2f} s")

    times = []
    for _ in range(args.loops):
        sync()
        t0 = time.perf_counter()
        eng.run(feed)
        sync()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"{args.loops} loops: median {med * 1e3:.2f} ms, min "
          f"{min(times) * 1e3:.2f} ms, {args.batch / med:.1f} images/s")
    loop, params, xd = engine_loop(eng, x, extras)
    float(loop(params, xd, 1))
    slope = slope_time(loop, params, xd, warm=2, iters=args.loops)
    print(f"timing loop (engine_loop + slope_time, {args.loops} "
          f"iterations): {slope * 1e3:.2f} ms per batch, "
          f"{args.batch / slope:.1f} images/s")

    top = first.reshape(len(first), -1)
    for i in range(min(len(top), 3)):
        idx = np.argsort(top[i])[::-1][:5]
        print(f"image {i} top-5: " +
              ", ".join(f"{j}:{top[i][j]:.4f}" for j in idx))

    for name in args.dump:
        path = os.path.join(args.dump_dir, name.replace("/", "_") + ".npy")
        np.save(path, out[name].float().cpu().numpy())
        print(f"dumped {name} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
