#!/usr/bin/env python3
"""The int8 GEMM kernels at the launches whose rows are not whole 16-byte
pieces, a few dense 1x1 launches beside them, and where a small-K launch's
time goes, on one GPU.

    python3 tools/int8_gemm_probe.py [--root DIR] [--parts]

Each shape (seeded int8 x and weight; the epilogue of the zoo's int8 1x1
convs: bias, w_scale, x_scale 0.02, ReLU, int8 out) runs through the
public wrappers (``matmul_epilogue``, ``conv2d_implicit_gemm`` on
``gemm_layout``'s weight), its output held equal to the plain version, and
is timed (CUDA events, median of 20 behind a spin kernel) beside its byte
bound; the line names the variant the launch took.  The shapes: the
ragged launches of ShuffleNet v2 b128 (K = 24, 58, 116, 232), MobileNet-v2
b128 (K = 24) and GoogLeNet b256 (5x5 on C = 24), and dense 1x1 launches
of ResNet-50 b128 and MobileNet-v1 b256.

``--root DIR`` times the package of another tree (an earlier commit
unpacked by ``git archive``): its wrappers take the same calls, so two
trees compare in one run (parent, change, change, parent).  ``--parts``
(this tree only) also times the plan of each matrix shape on builds of its
own that skip a part of the "wgmma" / "wgmma_ragged" consumer, their
results wrong and not checked: ``FCNN_WG_PROBE_NO_STORE`` (the tile's
stores), with ``FCNN_WG_PROBE_NO_STAGE`` (the epilogue's arithmetic too),
``FCNN_WG_PROBE_NO_MMA`` (the wgmma), and all three (the producer, the
ring and the launch alone).
Imports neither JAX nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (M, K, N, path) of int8 1x1 launches of the zoo's paths
MATRICES = [(100352, 24, 58, "ShuffleNet v2 b128"),
            (401408, 24, 58, "ShuffleNet v2 b128"),
            (100352, 58, 58, "ShuffleNet v2 b128"),
            (100352, 116, 116, "ShuffleNet v2 b128"),
            (25088, 116, 116, "ShuffleNet v2 b128"),
            (25088, 232, 232, "ShuffleNet v2 b128"),
            (6272, 232, 232, "ShuffleNet v2 b128"),
            (401408, 24, 144, "MobileNet-v2 b128"),
            (401408, 64, 256, "ResNet-50 b128"),
            (100352, 128, 512, "ResNet-50 b128"),
            (802816, 64, 128, "MobileNet-v1 b256"),
            (200704, 256, 256, "MobileNet-v1 b256")]
# (images, H = W, C, Co, KH = KW, path) of the ragged conv
CONVS = [(256, 14, 24, 64, 5, "GoogLeNet b256")]
PARTS = {"no stores": ("FCNN_WG_PROBE_NO_STORE",),
         "no epilogue": ("FCNN_WG_PROBE_NO_STAGE", "FCNN_WG_PROBE_NO_STORE"),
         "no wgmma": ("FCNN_WG_PROBE_NO_MMA",),
         "none of the three": ("FCNN_WG_PROBE_NO_MMA",
                               "FCNN_WG_PROBE_NO_STAGE",
                               "FCNN_WG_PROBE_NO_STORE")}


def epilogue(n, gen):
    return dict(bias=torch.rand(n, device="cuda", generator=gen) - 0.5,
                w_scale=(torch.rand(n, device="cuda", generator=gen) + 0.5)
                * 1e-3, activation="relu", out_dtype=torch.int8,
                x_scale=0.02, out_scale=20.0)


def timed(kernel, plain, a, what):
    """The wrapper's ms at ``a`` and the variant it took, its output held
    equal to the plain version's."""
    before = dict(kernel.variants)
    out = kernel(**a)
    took = "+".join(v for v, c in kernel.variants.items() if c != before[v])
    err, ok, _ = cs.compare(out, plain(**a))
    cs.check(ok, f"{what}: differs from plain, max err {err}")
    return cs.median_ms(lambda: kernel(**a)), took


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose feathercnn_tpu_torch is timed")
    ap.add_argument("--parts", action="store_true",
                    help="also time builds that skip parts of the consumer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_gemm_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.conv import (
        conv2d_implicit_gemm, conv2d_implicit_gemm_plain)
    from feathercnn_tpu_torch.kernels.matmul import (
        gemm_layout, matmul_epilogue, matmul_epilogue_plain)
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    print(f"tree: {os.path.abspath(args.root)}", flush=True)
    builds = [()] + (list(PARTS.values()) if args.parts else [])
    threads = [threading.Thread(target=load_library, args=(d,))
               for d in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (m, k, n, path) in MATRICES:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device="cuda", generator=gen)
        w = gemm_layout(torch.randint(-127, 128, (k, n), dtype=torch.int8,
                                      device="cuda", generator=gen))
        a = dict(x=x, w=w, **epilogue(n, gen))
        what = f"{path} matmul M={m} K={k} N={n}"
        ms, took = timed(matmul_epilogue, matmul_epilogue_plain, a, what)
        bound = (m * k + k * n + m * n) / cs.PEAK_BYTES * 1e3
        line = f"{what}: {took} {ms:.4f} ms, byte bound {bound:.4f} ms " \
               f"({100 * bound / ms:.1f}%)"
        if args.parts:
            from feathercnn_tpu_torch.kernels.matmul import (launch_args,
                                                             plan_for)
            out = torch.empty(m, n, dtype=torch.int8, device="cuda")
            vecs = {v: a.get(v) for v in ("bias", "w_scale", "lo", "hi")}
            ptrs, codes, _ = launch_args(x, w, out, vecs, "relu", torch.int8)
            plan = plan_for(m, k, n, x, w, torch.int8)
            for name, defines in PARTS.items():
                lib = load_library(defines)

                def run(lib=lib):
                    rc = lib.fcnn_matmul_epilogue(
                        *ptrs, m, k, n, *codes, 0.02, 20.0, *plan.args(),
                        None, torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"{what} {name}: CUDA error {rc}")
                line += f"; {name} {cs.median_ms(run):.4f}"
        print(line, flush=True)
    for (nb, hw, c, co, kk, path) in CONVS:
        x = torch.randint(-127, 128, (nb, hw, hw, c), dtype=torch.int8,
                          device="cuda", generator=gen)
        w = gemm_layout(torch.randint(-127, 128, (kk, kk, c, co),
                                      dtype=torch.int8, device="cuda",
                                      generator=gen))
        a = dict(x=x, w=w, stride=1, pad_h=kk // 2, pad_w=kk // 2,
                 **epilogue(co, gen))
        what = f"{path} conv x{(nb, hw, hw, c)} {kk}x{kk} Co={co}"
        ms, took = timed(conv2d_implicit_gemm, conv2d_implicit_gemm_plain,
                         a, what)
        print(f"{what}: {took} {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.CheckFailed as e:
        print(f"int8_gemm_probe: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
