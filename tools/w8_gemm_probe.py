#!/usr/bin/env python3
"""Where the weight-only int8 conv kernel ("wgmma_w8" of
``conv2d_implicit_gemm``, bf16 x, int8 w) spends its time, on one GPU.

    python3 tools/w8_gemm_probe.py

At each distinct 3x3 conv of VGG-16 b128 under ``quant="w8"`` (seeded
random x, weight and epilogue; bf16 out, ReLU) it times the launch on the
plan ``gemm_plan`` gives it and on plans it did not take, each through the
C entry point and held within the float gate of the plain version: the A
tile gathered by the producer's cp.async in place of TMA, fewer ring
stages, and the 64-wide tile where the plan takes 128.  It then times the
plan on two builds of its own that skip a part of the work (their results
are wrong and not checked): ``FCNN_W8_PROBE_NO_CONVERT`` (the weight
tile's int8-to-bf16 conversion) and ``FCNN_W8_PROBE_NO_MMA`` (the
``wgmma``).  Last, the sum over one forward's 12 launches of each variant
that every shape has.
Imports neither JAX nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import os
import sys
import threading

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from feathercnn_tpu_torch.kernels.build import load_library  # noqa: E402
from feathercnn_tpu_torch.kernels.conv import (  # noqa: E402
    conv2d_implicit_gemm_plain)
from feathercnn_tpu_torch.kernels.matmul import (  # noqa: E402
    MAX_STAGES, SMEM_LIMIT, gemm_layout, gemm_plan, launch_args, w8_smem)

# (C, Co, H = W, launches in one forward) of VGG-16's convs after the stem
CONVS = [(64, 64, 224, 1), (64, 128, 112, 1), (128, 128, 112, 1),
         (128, 256, 56, 1), (256, 256, 56, 2), (256, 512, 28, 1),
         (512, 512, 28, 2), (512, 512, 14, 3)]
BATCH = 128
ABLATIONS = {"no conversion": ("FCNN_W8_PROBE_NO_CONVERT",),
             "no wgmma": ("FCNN_W8_PROBE_NO_MMA",)}


def alternatives(plan, co):
    """name -> plan: the plan, its A gathered, fewer stages, 64 wide."""
    alts = {"plan": plan, "gathered A": plan._replace(th=0, tw=0)}
    for st in range(3, plan.stages):
        alts[f"{st} stages"] = plan._replace(
            stages=st, smem=w8_smem(plan.bn, st, True))
    if plan.bn == 128:
        stages = min(MAX_STAGES,
                     (SMEM_LIMIT - w8_smem(64, 0, True)) // (
                         w8_smem(64, 1, True) - w8_smem(64, 0, True)))
        n_tiles = -(-co // 64)
        alts["64 wide"] = plan._replace(
            bn=64, stages=stages, smem=w8_smem(64, stages, True),
            grid=max(132 // n_tiles, 1) * n_tiles)
    return alts


def main() -> int:
    if not torch.cuda.is_available():
        print("w8_gemm_probe: no CUDA device is available", file=sys.stderr)
        return 1
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    builds = [()] + list(ABLATIONS.values())
    threads = [threading.Thread(target=load_library, args=(d,))
               for d in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {}
    for (c, co, hw, count) in CONVS:
        x = torch.randn(BATCH, hw, hw, c, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = gemm_layout(torch.randint(-127, 128, (3, 3, c, co),
                                      dtype=torch.int8, device="cuda",
                                      generator=gen))
        bias = torch.rand(co, device="cuda", generator=gen)
        wsc = (torch.rand(co, device="cuda", generator=gen) + 0.5) * (
            1e-2 / (9 * c) ** 0.5)
        want = conv2d_implicit_gemm_plain(x, w, bias, wsc, 1, 1, 1, "relu",
                                          torch.bfloat16)
        out = torch.empty_like(want)
        ptrs, codes, _ = launch_args(x, w, out, {"bias": bias,
                                                 "w_scale": wsc, "lo": None,
                                                 "hi": None},
                                     "relu", torch.bfloat16)
        m, k = BATCH * hw * hw, 9 * c
        plan = gemm_plan(m, k, co, x.dtype, w.dtype, torch.bfloat16,
                         conv_c=c, conv_out=(BATCH, hw, hw), stride=1,
                         x_ptr=x.data_ptr(), w_ptr=w.data_ptr())
        flops = 2.0 * m * k * co
        runs = [(name, p, ()) for name, p in alternatives(plan, co).items()]
        runs += [(name, plan, d) for name, d in ABLATIONS.items()]
        line = []
        for name, p, defines in runs:
            lib = load_library(defines)

            def run(p=p, lib=lib):
                rc = lib.fcnn_conv_implicit_gemm(
                    *ptrs, BATCH, hw, hw, c, 3, 3, co, 1, 1, 1, 1, *codes,
                    1.0, 1.0, *p.args(), None,
                    torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"{name} {p}: CUDA error {rc}")
            run()
            if not defines:
                err, ok, _ = cs.compare(out, want, "float")
                cs.check(ok, f"conv C={c} Co={co} {hw}^2 on {name}: max err "
                         f"{err}")
            ms = cs.median_ms(run)
            total, shapes = sums.get(name, (0.0, 0))
            sums[name] = (total + count * ms, shapes + 1)
            line.append(f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                        f"TFLOP/s)")
        print(f"conv C={c} Co={co} {hw}x{hw} b{BATCH} (x{count}), plan "
              f"{plan.bn} wide, {plan.stages} stages, A "
              + (f"by TMA over {plan.th}x{plan.tw} pixels" if plan.th
                 else "gathered") + ": " + "; ".join(line), flush=True)
        del x, w, want, out
    print("one forward's 12 launches: " + "; ".join(
        f"{name} {total:.4f} ms" for name, (total, shapes) in sums.items()
        if shapes == len(CONVS)), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.CheckFailed as e:
        print(f"w8_gemm_probe: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
