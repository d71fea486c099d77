#!/usr/bin/env python3
"""ResNeXt-50's grouped convs on the super-group route and beside it,
timed through one tree's package on one GPU.

    python3 tools/grouped_conv_probe.py [--root DIR] [--parts]

ResNeXt-50 b128's seven grouped 3x3 conv shapes (cardinality 32, C = Co
= 128 to 1024, stride 1 and 2; seeded int8 x and weight, the zoo's int8
epilogue: bias, w_scale, ReLU, int8 out) run through the public wrapper
(``conv2d_implicit_gemm(..., groups=32)`` on ``grouped_layout``'s
weight), its output held equal to the plain version, and are timed (CUDA
events, median of 20 behind a spin kernel, ``chip_smoke.median_ms``) on
the plan it takes and, as an ungrouped conv, on the block-diagonal dense
weight (the plan these launches took before the route), equal to plain
too.  On a tree whose ``supergroup_plan`` still takes ``halo=`` (the
route's first design, in which a super-group's A was gathered tap by tap
with cp.async on "wgmma", since removed), each is also timed on that
gather at both K steps ("gather BK 64", "gather BK 128") and on
super-groups twice as wide ("q x2", its own compact weight), each forced
through the grouped C entry and held equal to plain.  ``--parts`` adds
builds of the library that skip a part of the consumer, their results
wrong and not checked: "no stores" (``FCNN_WG_PROBE_NO_STORE``), "no
epilogue" (with ``FCNN_WG_PROBE_NO_STAGE``: the arithmetic into the
staged tile too) and "no wgmma" (``FCNN_WG_PROBE_NO_MMA``).  The last line
sums each column over a forward (each shape times its launches in
ResNeXt-50).

``--root DIR`` times the package of another tree (unpacked by ``git
archive``), so that two trees compare in one run (parent, change, change,
parent).  Imports neither JAX nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys
import threading

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (H = W of x, stride, C = Co, launches in a ResNeXt-50 forward)
SHAPES = [(56, 1, 128, 3), (56, 2, 256, 1), (28, 1, 256, 3),
          (28, 2, 512, 1), (14, 1, 512, 5), (14, 2, 1024, 1),
          (7, 1, 1024, 2)]
PARTS = {"no stores": ("FCNN_WG_PROBE_NO_STORE",),
         "no epilogue": ("FCNN_WG_PROBE_NO_STAGE", "FCNN_WG_PROBE_NO_STORE"),
         "no wgmma": ("FCNN_WG_PROBE_NO_MMA",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose package is timed (default: this)")
    ap.add_argument("--parts", action="store_true",
                    help="also time builds that skip a part of the consumer")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("grouped_conv_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    from feathercnn_tpu_torch.kernels import matmul
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.conv import (
        conv2d_implicit_gemm, conv2d_implicit_gemm_plain)
    from feathercnn_tpu_torch.kernels.dispatch import block_diagonal
    print(f"tree: {os.path.abspath(args.root)}", flush=True)
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    gather = "halo" in inspect.signature(
        matmul.supergroup_plan).parameters
    parts = PARTS if args.parts else {}
    threads = [threading.Thread(target=load_library, args=(d,))
               for d in [()] + list(parts.values())]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = matmul._sm_count(0)
    stream = torch.cuda.current_stream().cuda_stream
    per_fwd = {}
    for hw, st, c, n in SHAPES:
        cg = c // 32
        q = 32 // cg
        oh = (hw - 1) // st + 1
        m = 128 * oh * oh
        x = torch.randint(-127, 128, (128, hw, hw, c), dtype=torch.int8,
                          device="cuda", generator=gen)
        wg = torch.randint(-127, 128, (3, 3, cg, c), dtype=torch.int8,
                           device="cuda", generator=gen)
        w = matmul.grouped_layout(wg, 32, q)
        a = dict(bias=torch.rand(c, device="cuda", generator=gen) - 0.5,
                 w_scale=(torch.rand(c, device="cuda", generator=gen) + 0.5)
                 * 1e-4, stride=st, pad_h=1, pad_w=1, activation="relu",
                 out_dtype=torch.int8, x_scale=1.0, out_scale=20.0)
        want = conv2d_implicit_gemm_plain(x, w, groups=32, **a)
        line = f"C={c} {hw}x{hw} s{st} x{n}:"

        def timed(name, fn, check):
            nonlocal line
            if check:
                out = fn()
                err, ok, _ = cs.compare(out, want)
                cs.check(ok, f"C={c} {hw}x{hw} s{st} {name}: max err {err}")
            ms = cs.median_ms(fn)
            per_fwd[name] = per_fwd.get(name, 0.0) + n * ms
            line += f" {name} {ms:.4f};"

        before = dict(conv2d_implicit_gemm.variants)
        timed("plan", lambda: conv2d_implicit_gemm(x, w, groups=32, **a),
              True)
        took = [v for v, k in conv2d_implicit_gemm.variants.items()
                if k != before[v]]
        dense = matmul.gemm_layout(block_diagonal(wg, 32))
        timed("block-diagonal", lambda: conv2d_implicit_gemm(x, dense, **a),
              True)
        # (contiguous NHWC: the plain output is a permuted view)
        out = torch.empty(want.shape, dtype=want.dtype, device="cuda")
        vecs = {"bias": a["bias"], "w_scale": a["w_scale"], "lo": None,
                "hi": None}

        def entry(wk, s, p, defines=()):
            ptrs, codes, _ = matmul.launch_args(x, wk, out, vecs, "relu",
                                                torch.int8)
            geo = (128, hw, hw, c, 3, 3, c, st, st, 1, 1, s)
            lib = load_library(defines)

            def run():
                rc = lib.fcnn_conv_implicit_gemm_grouped(
                    *ptrs, *geo, *codes, 1.0, 20.0, *p.args(), None, stream)
                cs.check(rc == 0, f"C={c} {p}: CUDA error {rc}")
                return out
            return run
        if gather:   # the route's first design, on a tree that has it
            for bk in (64, 128):
                p = matmul.supergroup_plan(
                    m, c, 32, c, (3, 3), 1, sms, x.data_ptr(), w.data_ptr(),
                    288, bk=bk, halo=False)
                timed(f"gather BK {bk}", entry(w, 32, p), True)
            w2 = matmul.grouped_layout(wg, 32, 2 * q)
            p = matmul.supergroup_plan(
                m, c, 64, c, (3, 3), 1, sms, x.data_ptr(), w2.data_ptr(),
                conv_out=(128, oh, oh), stride=st)
            timed("q x2", entry(w2, 64, p), True)
        if parts:
            p0 = matmul.plan_for(m, 9 * 32, c, x, w, torch.int8, conv_c=c,
                                 conv_out=(128, oh, oh), stride=st,
                                 group=32)
            for name, defines in parts.items():
                timed(name, entry(w, 32, p0, defines), False)
        print(f"{line} took {took}", flush=True)
    print("per forward (each shape times its launches): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in per_fwd.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
