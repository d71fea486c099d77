#!/usr/bin/env python3
"""The launches the split-K plans and "wgmma_bf16" were made for, and the
path they run on, timed through one tree's package on one GPU.

    python3 tools/split_gemm_probe.py [--root DIR]

- ResNet-50's bf16 FC, (128, 2048, 1000) bf16 x bf16, through
  ``matmul_epilogue``, within the float gate of the split-order plain
  version (``matmul_epilogue_split_plain``) at its plan's split;
- R-FCN ResNet-101's stage-5 conv at batch 1, (1, 38, 50, 512) x 3x3x512
  at dilation 2, int8 out, through ``conv2d_implicit_gemm``, equal to the
  plain version;
- R-FCN ResNet-101 b1 w8a8 at 600x800 with ``im_info`` (seeded weights,
  calibrated on 3 seeded images, as ``chip_smoke.py`` builds the path).

Each launch: the main loop it took, its split, the device ms (CUDA
events, median of 20 behind a spin kernel) and the host's µs per call
(200 calls queued, no sync between them).  The path: the median ms per
batch over 20 synchronized forwards, the host's ms to queue one forward,
and one profiled forward's busy ms (``chip_smoke.device_spans``: the
union of the kernels' spans) and the card's idle share of the median.

``--root DIR`` times the package of another tree (an earlier commit
unpacked by ``git archive``): its wrappers take the same calls, so two
trees compare in one run (parent, change, change, parent).  Imports
neither JAX nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def host_us(fn, n=200):
    """The host's µs per call of ``fn`` over ``n`` calls queued back to
    back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def launch(what, kernel, a, want, gate):
    before = dict(kernel.variants)
    out = kernel(**a)
    took = "+".join(v for v, c in kernel.variants.items() if c != before[v])
    err, ok, _ = cs.compare(out, want, gate)
    cs.check(ok, f"{what}: differs from plain, max err {err}")
    print(f"{what}: {took}: {cs.median_ms(lambda: kernel(**a)):.4f} ms, "
          f"host {host_us(lambda: kernel(**a)):.1f} us a call", flush=True)


def rfcn_path():
    from feathercnn_tpu_torch.models import build_model
    from feathercnn_tpu_torch.quant import calibrate
    from feathercnn_tpu_torch import Engine
    rng = np.random.default_rng(cs.SEED)
    g = build_model("rfcn_resnet101", batch=1, seed=cs.SEED)
    calibrate(g, [cs.images(g, 1, rng) for _ in range(3)], method="max")
    eng = Engine(g, cs.engine_config())
    xd = cs.to_card(cs.images(g, 1, rng))
    times, queued = [], []
    for _ in range(22):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng(xd)
        queued.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times[2:])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng(xd)
        torch.cuda.synchronize()
    spans = cs.device_spans(prof)
    busy = sum(us for _, us in spans) / 1e3
    passes = sum("splitk_reduce" in k for k, _ in spans)
    print(f"rfcn_resnet101 b1 w8a8 600x800: median {ms:.2f} ms per batch "
          f"(min {min(times[2:]):.2f}, max {max(times[2:]):.2f}), host "
          f"{statistics.median(queued[2:]):.2f} ms to queue a forward; "
          f"profiled forward: {len(spans)} kernels ({passes} split-K "
          f"passes), busy {busy:.3f} ms, idle {100 * (1 - busy / ms):.1f}% "
          f"of the median", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose feathercnn_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_gemm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.conv import (
        conv2d_implicit_gemm, conv2d_implicit_gemm_plain)
    from feathercnn_tpu_torch.kernels.matmul import (
        gemm_layout, gemm_plan, matmul_epilogue, matmul_epilogue_split_plain)
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    print(f"tree: {os.path.abspath(args.root)}", flush=True)
    load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def f32(*s):
        return torch.rand(*s, device="cuda", generator=gen) + 0.5

    m, k, n = 128, 2048, 1000
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = gemm_layout((torch.randn(k, n, device="cuda", generator=gen)
                     * k ** -0.5).to(torch.bfloat16))
    a = dict(x=x, w=w, bias=f32(n), activation=None,
             out_dtype=torch.bfloat16)
    split = gemm_plan(m, k, n, x.dtype, w.dtype, x.dtype).split
    launch(f"bf16 FC {(m, k, n)} split {split}", matmul_epilogue, a,
           matmul_epilogue_split_plain(split=split, **a), "float")

    xi = torch.randint(-127, 128, (1, 38, 50, 512), dtype=torch.int8,
                       device="cuda", generator=gen)
    wi = gemm_layout(torch.randint(-127, 128, (3, 3, 512, 512),
                                   dtype=torch.int8, device="cuda",
                                   generator=gen))
    a = dict(x=xi, w=wi, bias=f32(512), w_scale=f32(512) * 1e-3, stride=1,
             pad_h=2, pad_w=2, activation="relu", out_dtype=torch.int8,
             x_scale=0.02, out_scale=5.0, dilation=2)
    split = gemm_plan(1900, 4608, 512, torch.int8, torch.int8, torch.int8,
                      conv_c=512).split
    launch(f"R-FCN stage-5 conv (1, 38, 50, 512) 3x3 d=2 split {split}",
           conv2d_implicit_gemm, a, conv2d_implicit_gemm_plain(**a),
           "exact")
    rfcn_path()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.CheckFailed as e:
        print(f"split_gemm_probe: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
