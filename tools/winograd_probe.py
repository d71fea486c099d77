#!/usr/bin/env python3
"""The Winograd route's formulations on VGG-16 b128 w8, on one GPU.

    python3 tools/winograd_probe.py [--batch 128]

Runs VGG-16 under weight-only int8 with every ``conv*_*`` named
"winograd" (``BASELINE.json:9``, the path of ``chip_smoke.py``) in four
formulations of ``kernels/winograd.py``: the input transform summed in
f32 (the port's, as the reference's ``jnp.einsum``) or in f64 and rounded
once to f32, each with the weight transform made on the card (the
port's) or on the CPU.  For each it prints the median device ms of one
forward (CUDA events, median of 5), images 0-1 of that forward against
the port on the CPU in the same formulation (top-1, the cosines of the
probabilities and of the logits), and the errors of the 13 Winograd convs
against ``F.conv2d`` (``chip_smoke.py``'s gates).  Reports; does not fail
on a gate.  Imports neither JAX nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from feathercnn_tpu_torch import Engine, EngineConfig  # noqa: E402
from feathercnn_tpu_torch.kernels import dispatch, winograd  # noqa: E402
from feathercnn_tpu_torch.models import vgg16  # noqa: E402

PORT_TILES = winograd._tiles
PORT_TRANSFORM = dispatch.transform_weights


def tiles_f64(x, pad_h, pad_w):
    """The same tiles, the input transform summed in f64 and rounded once
    to f32 (exact or nearly so for a bf16 x: the same on every device)."""
    n, h, wd, c = x.shape
    oh, ow = h + 2 * pad_h - 2, wd + 2 * pad_w - 2
    nth, ntw = -(-oh // 6), -(-ow // 6)
    xp = F.pad(x.double(), (0, 0, pad_w, ntw * 6 + 2 - wd - pad_w, pad_h,
                            nth * 6 + 2 - h - pad_h))
    bt = torch.as_tensor(winograd.BT, dtype=torch.float64, device=x.device)
    d = xp.unfold(1, 8, 6).unfold(2, 8, 6)
    t = torch.einsum("ai,ntwcib->antwcb", bt, d)
    u = torch.einsum("bj,antwcj->abntwc", bt, t).float()
    return u.reshape(64, n * nth * ntw, c), (oh, ow, nth, ntw)


def transform_on_cpu(w):
    return PORT_TRANSFORM(w.cpu()).to(w.device)


def cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def logits_and_probs(eng, x):
    """Images 0-1's logits and probabilities from one forward of ``x``."""
    (blob,) = (n.inputs[0] for n in eng.graph.nodes if n.op == "Softmax")
    out = eng.run(x, extract=[blob])
    return [out[k][:2].double().cpu().numpy().reshape(2, -1)
            for k in (blob, eng.graph.outputs[0])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("winograd_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    g = vgg16(batch=args.batch, seed=cs.SEED)
    x = cs.images(g, args.batch, np.random.default_rng(cs.SEED))
    xd = torch.from_numpy(x).cuda()
    cfg_kw = dict(backend="cuda", compute_dtype="bfloat16", quant="w8",
                  algo_overrides=tuple((n.name, "winograd") for n in g.nodes
                                       if n.op == "Convolution"))
    cpu = Engine(g, EngineConfig(**cfg_kw), device="cpu")
    for tiles, tname in ((PORT_TILES, "f32"), (tiles_f64, "f64")):
        winograd._tiles = tiles
        ref_l, ref_p = logits_and_probs(cpu, x[:2])
        for transform, where in ((PORT_TRANSFORM, "card"),
                                 (transform_on_cpu, "CPU")):
            label = (f"input transform {tname}, weight transform on the "
                     f"{where}")
            dispatch.transform_weights = transform
            eng = Engine(g, EngineConfig(**cfg_kw))
            got_l, got_p = logits_and_probs(eng, xd)  # v made here
            dispatch.transform_weights = PORT_TRANSFORM
            ms = cs.median_ms(lambda: eng(xd), reps=5, warmup=1)
            for i in range(2):
                print(f"[{label}] image {i}: top-1 {int(got_p[i].argmax())} "
                      f"card, {int(ref_p[i].argmax())} CPU; prob cosine "
                      f"{cosine(got_p[i], ref_p[i]):.6f}, logit cosine "
                      f"{cosine(got_l[i], ref_l[i]):.6f}", flush=True)
            try:
                cs.winograd_check(label, eng, xd)
            except cs.CheckFailed as e:
                print(f"[{label}] {e}", flush=True)
            print(f"[{label}] {ms:.3f} ms per b{args.batch} forward "
                  f"(device, median of 5; {smi})", flush=True)
            del eng
            torch.cuda.empty_cache()
    winograd._tiles = PORT_TILES
    return 0


if __name__ == "__main__":
    sys.exit(main())
