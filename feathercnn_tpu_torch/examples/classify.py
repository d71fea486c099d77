"""Classify one image end to end: preprocess -> Engine -> top-5 — the
reference's ``examples/classify.py`` on the port:

    python -m feathercnn_tpu_torch.examples.classify --model resnet50 \\
        --quant w8a8
    python -m feathercnn_tpu_torch.examples.classify --ftpu out.ftpu \\
        --image img.npy --device cpu

``--image`` takes a .npy HWC uint8/float array; without it a seeded
synthetic image is used, so the example runs anywhere.  The engine runs
the "cuda" backend on the GPU unless ``--device cpu`` is given (the
kernels' plain versions there); the kernels build into
``utils.cache.enable_persistent_cache``'s directory.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="zoo model name")
    src.add_argument("--ftpu", help="converted model artifact")
    ap.add_argument("--image", help=".npy HWC image")
    ap.add_argument("--quant", default=None, help="w8|w8a8")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    from ..config import EngineConfig
    from ..engine import Engine
    from ..serve import preprocess
    from ..utils.cache import enable_persistent_cache

    enable_persistent_cache()
    cfg = EngineConfig(compute_dtype=args.dtype, backend="cuda",
                       quant=args.quant or None)
    if args.ftpu:
        from ..model_format import load_ftpu
        graph = load_ftpu(args.ftpu)
    else:
        from ..models import MODEL_BUILDERS
        graph = MODEL_BUILDERS[args.model](batch=1)

    in_spec = next(iter(graph.inputs.values()))
    _, h, w, _ = in_spec.shape
    if args.image:
        raw = np.load(args.image)
        if raw.dtype != np.uint8:   # pre-scaled float images
            raw = np.clip(raw, 0, 255).astype(np.uint8)
    else:
        raw = np.random.default_rng(0).integers(
            0, 256, size=(h + 32, w + 32, 3)).astype(np.uint8)
    img = preprocess(raw, (h, w), mean=(0.485, 0.456, 0.406),
                     std=(0.229, 0.224, 0.225))

    # Calibrate before building the quantized engine: its quantize pass
    # reads the activation scales.
    if args.quant == "w8a8" and "act_scales" not in graph.meta:
        from ..quant import calibrate
        calibrate(graph, [img[None]], method="max", device=args.device)
    eng = Engine(graph, cfg, device=args.device)

    probs = eng(img[None]).float().cpu().numpy()[0].ravel()
    for i in np.argsort(-probs)[:5]:
        print(f"class {i:4d}: {probs[i]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
