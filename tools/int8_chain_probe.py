#!/usr/bin/env python3
"""The int8 fused-chain kernel (``fused_chain`` of ``feathercnn_tpu_torch``,
int8 mode) one block at a time, on one GPU.

    python3 tools/int8_chain_probe.py [--sass]

Builds the kernels, prints ptxas's registers and spills for each build of
the "wgmma" variant (``fused_block_kernel_wg<columns, per-tap sums>``) and
any warning that ptxas serializes its ``wgmma``s; then, on a seeded random
int8 block (nb = 1, int8 out) at each of ResNet-50's four stage shapes at
b128, the median time of one launch on the plan ``chain_plan`` gives it,
on "wgmma" with one and with two tiles per thread block, and on
"mma_sync" (the first body), each held bit-equal to the plan's output and
that to ``fused_chain_plain`` on a few images.  ``--sass`` also counts
local-memory loads and stores (spills) and ``wgmma`` waits per build in
the library's SASS (``cuobjdump``, beside ``nvcc``).  Imports neither JAX
nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from feathercnn_tpu_torch.kernels import build  # noqa: E402
from feathercnn_tpu_torch.kernels import fused_chain as fc  # noqa: E402

STAGES = ((56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512))
BATCH = 128


def block(n, h, w, c, cm, gen, rng):
    """One seeded int8 block (nb = 1, int8 out) in the kernel's layout."""
    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def f32(*s, lo, hi):
        return torch.rand(*s, device="cuda", generator=gen) * (hi - lo) + lo
    scales = tuple((float(rng.uniform(lo, hi)),)
                   for lo, hi in ((0.02, 0.05), (5e-4, 2e-3), (5e-4, 2e-3)))
    return dict(
        x=i8(n, h, w, c), w1=fc.kernel_layout(i8(1, c, cm)),
        b1=f32(1, cm, lo=-1.0, hi=1.0),
        w2=fc.kernel_layout(i8(1, 9 * cm, cm)),
        b2=f32(1, cm, lo=-1.0, hi=1.0), w3=fc.kernel_layout(i8(1, cm, c)),
        b3=f32(1, c, lo=-1.0, hi=1.0),
        w_scales=tuple(f32(1, cols, lo=0.5e-3 / k ** 0.5, hi=1.5e-3 / k ** 0.5)
                       for k, cols in ((c, cm), (9 * cm, cm), (cm, c))),
        scales=(*scales, 0.05), out_dtype=torch.int8)


def plans_of(n, h, w, c, cm):
    """name -> plan: the chain_plan's own, "wgmma" at one and two tiles per
    block (where they fit) and "mma_sync"."""
    out = {"plan": fc.chain_plan(n, h, w, c, cm, 1)}
    for k in (1, 2):
        try:
            out[f"wgmma {k} a block"] = fc.chain_plan(n, h, w, c, cm, 1,
                                                      per_cta=k)
        except ValueError:
            pass
    th, tw = fc.tile_plan(h, w, cm, 1)
    out["mma_sync"] = fc.ChainPlan(
        "mma_sync", th, tw, 1, 3, 0, False, fc.smem_bytes(th, tw, cm, 1),
        n * -(-h // th) * -(-w // tw), "timed beside wgmma")
    return out


def ptxas_lines():
    log = build.build_log().splitlines()
    for i, line in enumerate(log):
        if "C751" in line and "fused_block_kernel_wg" in line:
            print("ptxas warning:", line.split(":", 1)[-1].strip()[:160])
        if "Compiling entry function" in line and \
                "fused_block_kernel_wg" in line:
            inst = line.split("fused_block_kernel_wgILi")[1]
            name = (f"fused_block_kernel_wg<{inst.split('ELb')[0]}, "
                    f"{'true' if inst.split('ELb')[1][0] == '1' else 'false'}>")
            print(f"{name}: " + "; ".join(
                l.split(":", 1)[-1].strip() for l in log[i + 1:i + 4]
                if "spill" in l or "registers" in l))


def sass_counts():
    so = next(build._BUILD_ROOT.glob(f"{build._source_hash()}/*.so"))
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                       text=True, check=True)
    name, body = None, []
    for line in r.stdout.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name and "fused_block_kernel_wg" in name:
                text = "\n".join(body)
                print(f"SASS {name[-64:]}: " + ", ".join(
                    f"{k} {text.count(k)}" for k in (
                        "LDL", "STL", "IGMMA", "WARPGROUP.DEPBAR", "LDSM")))
            name, body = line.split("Function :")[1].strip(), []
        else:
            body.append(line)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_chain_probe: no CUDA device", file=sys.stderr)
        return 1
    build.load_library()
    smi = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    print(f"gpu: {smi}")
    ptxas_lines()
    if args.sass:
        sass_counts()
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(4)
    for h, c, cm in STAGES:
        a = block(BATCH, h, h, c, cm, gen, rng)
        small = {**a, "x": a["x"][:2]}
        want = fc.fused_chain(**a)
        cs.check(torch.equal(fc.fused_chain(**small),
                             fc.fused_chain_plain(**small)),
                 f"stage {h}: kernel differs from plain")
        res = []
        for name, plan in plans_of(BATCH, h, h, c, cm).items():
            def run(plan=plan):
                return fc._launch_blocks(
                    a["x"], a["w1"], a["b1"], a["w2"], a["b2"], a["w3"],
                    a["b3"], a["w_scales"], a["scales"], torch.int8,
                    lambda *_: plan, False)
            cs.check(torch.equal(run(), want), f"stage {h} {name}: differs")
            res.append(f"{name} ({plan.variant}, {plan.tiles_per_cta} a "
                       f"block, {plan.stages} stages) "
                       f"{cs.median_ms(run):.4f}")
        print(f"b{BATCH} {h}x{h} C={c} Cm={cm}, ms per launch: "
              + "; ".join(res))
    print(f"every launch equal to the plan's output ({smi})")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.CheckFailed as e:
        print(f"int8_chain_probe: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
