#!/usr/bin/env python3
"""How far the float fused-chain kernel (``fused_chain_float`` of
``feathercnn_tpu_torch``) lands from its plain version, on one GPU, for
each rounded-add step.

    python3 tools/float_chain_probe.py

The "wgmma" variant sums each slice of K in the tensor cores and adds it
into the f32 running sum with one rounded add: 128 products a slice, or
32 with each add's rounding error carried into the next slice where Cm
exceeds 256 (``FLOAT_ADD_STEPS``).  The library builds those two; this
probe builds one of its own (``FCNN_FLOAT_PROBE``) that takes steps of 32,
64 and 128 with and without the carry, and all of K in the tensor cores.
On seeded random blocks at ResNet-50's four stage shapes and at the
stage-5 shape of ``chip_smoke.py``'s ragged cases (seeds 5, 6 and 7 each),
and on the bf16 ResNet-50 b128 path's own chain calls, it prints per block (one launch, on the kernel's own input) the share of bf16
outputs more than 1 ulp from the plain version (which rounds each sum once
from f64), beside the same share for an f32 version that sums in PyTorch's
order (``x.float() @ w.float()``: another correct order); then the median
time of each path chain call per step, and per step the worst share of any
launch per stage against the float gate's 0.1%.
Imports neither JAX nor the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from feathercnn_tpu_torch import Engine, EngineConfig  # noqa: E402
from feathercnn_tpu_torch.kernels.build import load_library  # noqa: E402
from feathercnn_tpu_torch.kernels.fused_chain import (  # noqa: E402
    _DTYPE_CODES, chain_plan, fused_chain_float,
    fused_chain_plain, kernel_layout)
from feathercnn_tpu_torch.models import resnet50  # noqa: E402

BF = torch.bfloat16
_W = ("w1", "b1", "w2", "b2", "w3", "b3")
# (products per rounded add, carried); (0, False): all of K in the tensor
# cores
STEPS = ((32, True), (64, True), (128, True), (32, False), (64, False),
         (128, False), (0, False))
GATE = 0.1                   # per cent of a launch's elements over 1 ulp
SEEDS = (5, 6, 7)
STAGES = [(2, 56, 56, 256, 64, 2), (8, 28, 28, 512, 128, 3),
          (8, 14, 14, 1024, 256, 5), (2, 7, 7, 2048, 512, 1),
          (3, 7, 7, 2048, 512, 2)]


def name(step):
    kadd, carry = step
    return ("all K" if kadd == 0 else
            f"{kadd}" if carry else f"{kadd} uncarried")


def plain_f32(x, w1, b1, w2, b2, w3, b3, out_dtype=None):
    """The chain with every sum in f32 in PyTorch's order."""
    n, h, w, c = x.shape
    nb, _, cm = w1.shape
    act = x
    for j in range(nb):
        xm = act.reshape(-1, c)
        y1 = torch.clamp_min(xm.float() @ w1[j].float() + b1[j], 0)
        y1 = F.pad(y1.to(x.dtype).reshape(n, h, w, cm), (0, 0, 1, 1, 1, 1))
        taps = [y1[:, i:i + h, k:k + w, :].reshape(-1, cm)
                for i in range(3) for k in range(3)]
        a2 = torch.cat(taps, 1).float() @ w2[j].float()
        y2 = torch.clamp_min(a2 + b2[j], 0).to(x.dtype)
        out = torch.clamp_min(y2.float() @ w3[j].float() + b3[j]
                              + xm.float(), 0)
        act = out.to((out_dtype or x.dtype) if j == nb - 1 else x.dtype)
        act = act.reshape(n, h, w, c)
    return act


def launch_block(lib, blk, step):
    """One block (``blk``'s weights hold one) through the probe library at
    ``step``, on the plan the wrapper would make."""
    x = blk["x"]
    n, h, w, c = x.shape
    cm = blk["w1"].shape[2]
    plan = chain_plan(n, h, w, c, cm, 2)._replace(kadd=step[0],
                                                  carry=step[1])
    if plan.variant != "wgmma":
        raise ValueError(f"the probe takes wgmma blocks only, got {plan}")
    odt = blk.get("out_dtype") or x.dtype
    out = torch.empty((n, h, w, c), dtype=odt, device=x.device)
    rc = lib.fcnn_fused_block_float(
        x.data_ptr(), out.data_ptr(), blk["w1"][0].data_ptr(),
        blk["b1"][0].data_ptr(), blk["w2"][0].data_ptr(),
        blk["b2"][0].data_ptr(), blk["w3"][0].data_ptr(),
        blk["b3"][0].data_ptr(), n, h, w, c, cm, plan.th, plan.tw,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[odt], *plan.args(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {rc} ({plan})")
    return out


def share(a, b):
    """Per cent of elements of ``a`` more than 1 bf16 ulp from ``b``."""
    _, _, over = cs.compare(a, b, "float")
    return 100.0 * over / a.numel()


def blocks_of(a):
    """The chain's blocks, each on the input the shipped kernel gives it."""
    nb = a["w1"].shape[0]
    inputs = [a["x"]]
    for j in range(nb - 1):
        blk = {k: a[k][j:j + 1] for k in _W}
        inputs.append(fused_chain_float(x=inputs[-1], **blk))
    out = []
    for j in range(nb):
        blk = {k: a[k][j:j + 1] for k in _W}
        blk.update(x=inputs[j],
                   out_dtype=a["out_dtype"] if j == nb - 1 else None)
        out.append(blk)
    return out


def block_shares(lib, label, a, worst, stage):
    """Block by block: the kernel's share at every step beside the f32
    order's; the shipped library's output equals the probe's at the
    shipped step."""
    for j, blk in enumerate(blocks_of(a)):
        ref = fused_chain_plain(**blk)
        shipped = fused_chain_float(**blk)
        x = blk["x"]
        plan = chain_plan(*x.shape, blk["w1"].shape[2], 2)
        own = (plan.kadd, plan.carry)
        cs.check(torch.equal(shipped, launch_block(lib, blk, own)),
                 f"{label} block {j}: the library and the probe build differ "
                 f"at step {name(own)}")
        parts = []
        for step in STEPS:
            sh = share(launch_block(lib, blk, step), ref)
            worst[step][stage] = max(worst[step].get(stage, 0.0), sh)
            parts.append(f"{name(step)}: {sh:.4f}%")
        print(f"{label} block {j}: kernel " + ", ".join(parts)
              + f"; f32 order {share(plain_f32(**blk), ref):.4f}%",
              flush=True)


def random_chain(gen, n, h, w, c, cm, nb, dt=BF):
    """chip_smoke.py's ragged float-chain case from the same generator
    draws the same inputs."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale
    return dict(x=rnd(n, h, w, c).to(dt),
                w1=kernel_layout(rnd(nb, c, cm, scale=c ** -0.5).to(dt)),
                b1=rnd(nb, cm, scale=0.1),
                w2=kernel_layout(rnd(nb, 9 * cm, cm,
                                     scale=(9 * cm) ** -0.5).to(dt)),
                b2=rnd(nb, cm, scale=0.1),
                w3=kernel_layout(rnd(nb, cm, c, scale=cm ** -0.5).to(dt)),
                b3=rnd(nb, c, scale=0.1), out_dtype=None)


def main() -> int:
    if not torch.cuda.is_available():
        print("float_chain_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.toolchain()
    lib = load_library(("FCNN_FLOAT_PROBE",))
    worst = {step: {} for step in STEPS}
    for case in STAGES:
        for seed in SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            block_shares(lib, f"random {case} seed {seed}",
                         random_chain(gen, *case), worst, case[1])

    g = resnet50(batch=cs.BATCH, seed=cs.SEED)
    g.meta["chain_regions"] = {"*": True}
    eng = Engine(g, EngineConfig(backend="cuda", compute_dtype="bfloat16",
                                 quant=None, fuse_chains=True))
    x = np.random.default_rng(cs.SEED).normal(
        size=(cs.BATCH, 224, 224, 3)).astype(np.float32)
    rec = cs.LaunchRecorder()
    rec.run(eng, x)
    for r in rec.launches:
        if r["kernel"] != "fused_chain_float":
            continue
        a = r["args"]
        label = (f"resnet50 b{cs.BATCH} bf16 x{tuple(a['x'].shape)} "
                 f"nb={a['w1'].shape[0]}")
        block_shares(lib, label, a, worst, a["x"].shape[1])
        blks = blocks_of(a)
        times = []
        for step in STEPS:
            def call(step=step):
                for blk in blks:
                    launch_block(lib, blk, step)
            times.append(f"{name(step)} {cs.median_ms(call):.4f}")
        print(f"{label}: one call, ms by step: " + ", ".join(times)
              + f" ({smi})", flush=True)
    for step in STEPS:
        print(f"step {name(step)}: worst launch per stage (H: %) "
              + ", ".join(f"{h}: {v:.4f}" for h, v in
                          sorted(worst[step].items(), reverse=True))
              + f"; gate {GATE}%: "
              + ("within" if max(worst[step].values()) <= GATE else "OVER"),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
