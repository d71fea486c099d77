#!/usr/bin/env python3
"""How far the float fused-chain kernel (``fused_chain_float`` of
``feathercnn_tpu_torch``) lands from its plain version, on one GPU.

    python3 tools/float_chain_probe.py

Per block (one kernel launch) and per whole chain, on seeded random
chains and on the bf16 ResNet-50 b128 path's own chain calls, it prints
the share of bf16 outputs more than 1 ulp from the plain version (which
rounds each sum once from f64), beside the same share for an f32 version
that sums in PyTorch's order (``x.float() @ w.float()``: another correct
order, the floor that two f32 orders set).  Then the median time of one
call at ResNet-50's four b128 chain shapes.  Imports neither JAX nor the
JAX package; needs a CUDA device.
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
from feathercnn_tpu_torch.kernels.fused_chain import (  # noqa: E402
    fused_chain_float, fused_chain_plain, kernel_layout)
from feathercnn_tpu_torch.models import resnet50  # noqa: E402

BF = torch.bfloat16
_W = ("w1", "b1", "w2", "b2", "w3", "b3")


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


def share(a, b):
    """Per cent of elements of ``a`` more than 1 bf16 ulp from ``b``."""
    _, _, over = cs.compare(a, b, "float")
    return 100.0 * over / a.numel()


def report(label, a):
    """Whole chain, then block by block on the kernel's own inputs."""
    ref = fused_chain_plain(**a)
    print(f"{label}: whole chain, kernel "
          f"{share(fused_chain_float(**a), ref):.4f}% f32 order "
          f"{share(plain_f32(**a), ref):.4f}%", flush=True)
    act, nb = a["x"], a["w1"].shape[0]
    for j in range(nb):
        blk = {k: a[k][j:j + 1] for k in _W}
        blk.update(x=act, out_dtype=a["out_dtype"] if j == nb - 1 else None)
        got, ref = fused_chain_float(**blk), fused_chain_plain(**blk)
        print(f"  block {j}: kernel {share(got, ref):.4f}% f32 order "
              f"{share(plain_f32(**blk), ref):.4f}%", flush=True)
        act = got


def random_chain(gen, n, h, w, c, cm, nb, dt=BF):
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
    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in [(2, 56, 56, 256, 64, 2), (8, 28, 28, 512, 128, 3),
                 (8, 14, 14, 1024, 256, 5), (2, 7, 7, 2048, 512, 1)]:
        report(f"random {case}", random_chain(gen, *case))

    g = resnet50(batch=cs.BATCH, seed=cs.SEED)
    g.meta["chain_regions"] = {"*": True}
    eng = Engine(g, EngineConfig(backend="cuda", compute_dtype="bfloat16",
                                 quant=None, fuse_chains=True))
    x = np.random.default_rng(cs.SEED).normal(
        size=(cs.BATCH, 224, 224, 3)).astype(np.float32)
    rec = cs.LaunchRecorder()
    rec.run(eng, x)
    for r in rec.launches:
        if r["kernel"] == "fused_chain_float":
            a = r["args"]
            report(f"resnet50 b{cs.BATCH} bf16 x{tuple(a['x'].shape)} "
                   f"nb={a['w1'].shape[0]}", a)
            ms = cs.median_ms(lambda: fused_chain_float(**a))
            print(f"  one call: {ms:.4f} ms ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
