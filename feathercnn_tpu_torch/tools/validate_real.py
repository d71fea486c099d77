"""Real-weights end-to-end validation — the port's counterpart of
``tools/validate_real.py``.

One command: a deploy prototxt + ``.caffemodel`` + an image directory ->
convert (the port's converter) -> fp top-1 -> int8 calibration -> int8
top-1 -> the top-1 drop against the gate (0.5% by default), on the GPU
unless ``--device cpu`` is given:

    python -m feathercnn_tpu_torch.tools.validate_real \\
        tools/deploys/resnet50_deploy.prototxt ResNet-50-model.caffemodel \\
        --images val_dir --labels val.txt [--dtype bfloat16] [--batch 128]

Both legs run the "cuda" backend (the hand-written kernels; their plain
versions on the CPU).  A float32 leg turns TF32 off, so its convs compute
in f32.  Images: ``.npy`` files are taken as preprocessed (H, W, C) float32
BGR; anything PIL opens is resized (shorter side -> ``--resize``),
center-cropped to the deploy's input size, RGB -> BGR, mean-subtracted
(``--mean``, Caffe's ImageNet BGR default).  PIL is imported only to decode
such an image.  Labels file: ``<filename> <int>`` per line.  The CLI prints
the result as JSON and exits 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["load_image", "top1", "validate", "main"]


def load_image(path: str, size: int, resize: int,
               mean: np.ndarray, scale: float) -> np.ndarray:
    """One preprocessed (size, size, 3) float32 BGR image."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.shape[:2] != (size, size):
            raise ValueError(f"{path}: expected ({size},{size},3), "
                             f"got {arr.shape}")
        return arr
    from PIL import Image
    im = Image.open(path).convert("RGB")
    w, h = im.size
    r = resize / min(w, h)
    im = im.resize((max(size, int(round(w * r))),
                    max(size, int(round(h * r)))), Image.BILINEAR)
    w, h = im.size
    left, top = (w - size) // 2, (h - size) // 2
    im = im.crop((left, top, left + size, top + size))
    arr = np.asarray(im, np.float32)[:, :, ::-1]      # RGB -> BGR
    return (arr - mean) * scale


def top1(engine, images: np.ndarray, batch: int) -> np.ndarray:
    """Class predictions for (M, H, W, 3) preprocessed images, in batches
    of ``batch`` (the last one padded with zeros)."""
    preds = []
    for i in range(0, len(images), batch):
        chunk = images[i:i + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros_like(chunk[:1])
                                    .repeat(pad, 0)])
        out = engine(chunk).float().cpu().numpy()
        out = out.reshape(out.shape[0], -1)
        preds.append(out.argmax(-1)[:len(images[i:i + batch])])
    return np.concatenate(preds)


def validate(deploy: str, caffemodel: str, image_paths, labels=None,
             batch: int = 8, calib_n: int = 8, resize: int = 256,
             mean=(104.0, 117.0, 123.0), scale: float = 1.0,
             dtype: str = "float32", gate: float = 0.005,
             quant: str = "w8a8", device=None) -> dict:
    """Convert, then fp and int8 top-1 on ``image_paths``, with the
    reference's result fields: ``deploy``, ``images``, ``fp_top1_pred``,
    and with ``quant`` ``int8_top1_pred`` and ``fp_vs_int8_agree``; with
    ``labels`` (file name -> class) ``fp_top1`` and, with ``quant``,
    ``int8_top1``, ``top1_drop``, ``gate`` and ``gate_pass``.  ``device``:
    as for ``Engine`` (the first CUDA device unless "cpu" is given)."""
    import torch

    from ..config import EngineConfig
    from ..engine import Engine, resolve_device
    from ..quant import calibrate
    from .convert_caffe import convert

    dev = resolve_device(device)
    if dev.type == "cuda" and dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    g = convert(deploy, caffemodel, batch=batch)
    spec = next(iter(g.inputs.values()))
    size = spec.shape[1]
    mean = np.asarray(mean, np.float32)
    images = np.stack([load_image(p, size, resize, mean, scale)
                       for p in image_paths])

    fp_eng = Engine(g, EngineConfig(compute_dtype=dtype, backend="cuda"),
                    device=dev)
    fp_pred = top1(fp_eng, images, batch)
    del fp_eng

    result = {"deploy": os.path.basename(deploy),
              "images": len(images), "fp_top1_pred": fp_pred.tolist()}
    if quant:
        calib = images[:calib_n]
        pad = batch - len(calib) % batch if len(calib) % batch else 0
        if pad:
            calib = np.concatenate([calib, calib[:1].repeat(pad, 0)])
        calibrate(g, [calib[i:i + batch]
                      for i in range(0, len(calib), batch)],
                  method="max", config=EngineConfig(compute_dtype=dtype),
                  device=dev)
        q_eng = Engine(g, EngineConfig(compute_dtype=dtype, quant=quant,
                                       backend="cuda"), device=dev)
        q_pred = top1(q_eng, images, batch)
        result["int8_top1_pred"] = q_pred.tolist()
        result["fp_vs_int8_agree"] = float((fp_pred == q_pred).mean())

    if labels is not None:
        y = np.asarray([labels[os.path.basename(p)] for p in image_paths])
        result["fp_top1"] = float((fp_pred == y).mean())
        if quant:
            result["int8_top1"] = float((q_pred == y).mean())
            result["top1_drop"] = result["fp_top1"] - result["int8_top1"]
            result["gate"] = gate
            result["gate_pass"] = bool(result["top1_drop"] <= gate)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a Caffe model and validate fp/int8 top-1 on "
                    "images")
    ap.add_argument("deploy")
    ap.add_argument("caffemodel")
    ap.add_argument("--images", required=True,
                    help="directory of images (or .npy preprocessed)")
    ap.add_argument("--labels", default=None,
                    help="file of '<filename> <int label>' lines")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calib-n", type=int, default=8,
                    help="images used for int8 calibration")
    ap.add_argument("--resize", type=int, default=256)
    ap.add_argument("--mean", default="104,117,123",
                    help="BGR channel means")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--quant", default="w8a8",
                    help="'none' skips the int8 leg")
    ap.add_argument("--gate", type=float, default=0.005)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    exts = (".npy", ".jpg", ".jpeg", ".png", ".bmp")
    paths = sorted(
        os.path.join(args.images, f) for f in os.listdir(args.images)
        if f.lower().endswith(exts))[:args.limit]
    if not paths:
        print(f"no images under {args.images}", file=sys.stderr)
        return 2
    labels = None
    if args.labels:
        labels = {}
        with open(args.labels) as f:
            for line in f:
                if line.strip():
                    k, v = line.split()
                    labels[k] = int(v)
    res = validate(
        args.deploy, args.caffemodel, paths, labels=labels,
        batch=args.batch, calib_n=args.calib_n, resize=args.resize,
        mean=tuple(float(v) for v in args.mean.split(",")),
        scale=args.scale, dtype=args.dtype, gate=args.gate,
        quant=None if args.quant in ("none", "None") else args.quant,
        device=args.device)
    print(json.dumps(res, indent=1))
    return 1 if "gate_pass" in res and not res["gate_pass"] else 0


if __name__ == "__main__":
    sys.exit(main())
