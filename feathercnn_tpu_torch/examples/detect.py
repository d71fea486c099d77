"""Two-stage detection end to end: Faster R-CNN / R-FCN on the device, the
test.py-style final decode on the host — the reference's
``examples/detect.py`` on the port:

    python -m feathercnn_tpu_torch.examples.detect \\
        --model faster_rcnn_vgg16 [--image img.npy]
    python -m feathercnn_tpu_torch.examples.detect --model rfcn_resnet101 \\
        --quant w8a8 --size 224 288 --device cpu

The engine runs the "cuda" backend on the GPU unless ``--device cpu`` is
given; ``--size`` builds the model at a smaller input than its deploy's
600x800 (for the CPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="faster_rcnn_vgg16",
                    choices=["faster_rcnn_vgg16", "rfcn_resnet101"])
    ap.add_argument("--image", help=".npy HWC image (uint8 or float)")
    ap.add_argument("--quant", default=None, help="w8|w8a8")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--score-thresh", type=float, default=0.05)
    ap.add_argument("--size", type=int, nargs=2, default=None,
                    help="input height and width (default: the deploy's)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    from ..config import EngineConfig
    from ..engine import Engine
    from ..models import MODEL_BUILDERS
    from ..serve import decode_detections, preprocess
    from ..utils.cache import enable_persistent_cache

    enable_persistent_cache()
    kw = {"size": tuple(args.size)} if args.size else {}
    graph = MODEL_BUILDERS[args.model](**kw)
    (h, w) = next(iter(graph.inputs.values())).shape[1:3]

    if args.image:
        raw = np.load(args.image)
        if raw.dtype != np.uint8:
            raw = np.clip(raw, 0, 255).astype(np.uint8)
    else:
        raw = np.random.default_rng(0).integers(
            0, 256, size=(h, w, 3)).astype(np.uint8)
    img = preprocess(raw, (h, w), mean=(0.485, 0.456, 0.406),
                     std=(0.229, 0.224, 0.225))
    inputs = {"data": img[None],
              "im_info": np.asarray([[h, w, 1.0]], np.float32)}

    if args.quant == "w8a8":
        from ..quant import calibrate
        calibrate(graph, [inputs], method="max", device=args.device)
    eng = Engine(graph, EngineConfig(compute_dtype=args.dtype,
                                     backend="cuda",
                                     quant=args.quant or None),
                 device=args.device)
    res = eng.run(inputs)
    cls_prob, bbox_pred, rois = (res[name].float().cpu().numpy()
                                 for name in graph.outputs[:3])
    dets = decode_detections(
        cls_prob, bbox_pred, rois, (h, w),
        score_thresh=args.score_thresh,
        class_agnostic=(args.model == "rfcn_resnet101"))
    total = sum(len(d) for d in dets.values())
    print(f"{total} detections across {len(dets)} classes")
    for c, d in sorted(dets.items()):
        for row in d[:3]:
            print(f"  class {c:3d} score {row[4]:.3f} "
                  f"box [{row[0]:.0f}, {row[1]:.0f}, "
                  f"{row[2]:.0f}, {row[3]:.0f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
