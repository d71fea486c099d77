#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feathercnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and 224x224 on the "cuda"
backend, with seeded random weights.  The int8 paths are calibrated by the
port (``method="max"``) and run full int8 (``quant="w8a8"``) with bf16
float activations; the bf16 paths run ``quant=None`` in bf16:

- ResNet-50 at batch 128, then behind an ``InferenceServer``;
- MobileNet-v1 at batch 256 on its default route, where its 13 depthwise
  convs take the int8 depthwise kernel, and with the 13 ``*/dw`` layers
  overridden to "depthwise" (the float depthwise kernel, int8 in);
- MobileNet-v2 at batch 128 with its 17 ``*/dwise`` layers overridden to
  "depthwise" (bf16 in).  Its default route sends them to PyTorch's float
  grouped conv, as the reference leaves them to XLA's; the CPU tests cover
  it;
- ResNet-50 at batch 128 with ``fuse_chains=True`` and the wildcard region
  table ``meta["chain_regions"] = {"*": True}`` that ``bench.py
  --fuse-chains`` sets: its 12 identity blocks run as 4 chains (nb 2, 3, 5,
  2) through the fused-chain kernel, one launch per block;
- ResNet-50 at batch 128 in bf16 (``quant=None``, no calibration),
  unchained: its convs run in PyTorch's (cuDNN's) float conv, as the
  reference leaves float convs to XLA's, and its FC in the float variant of
  ``matmul_epilogue``.  It is the yardstick of the next path;
- the same in bf16 with ``fuse_chains`` and the wildcard region table: the
  12 identity blocks run as 3 chains (nb 2, 3, 5) and 2 single blocks at
  stage 5 through the float fused-chain kernel, one launch per block;
- the boundary probe (``kernels/ident.py``, the ``idctx`` mode of
  ``bench/chain_micro.py``) at ResNet-50's stages 2-5, b128: a producer and
  a consumer int8 1x1 conv with and without the ``ident`` copy between
  them;
- VGG-16 at batch 128 under weight-only int8 (``quant="w8"``, no
  calibration): its 12 3x3 convs after the float stem through
  ``conv2d_implicit_gemm`` and its 3 FCs through ``matmul_epilogue``, both
  on their "wgmma_w8" variant (bf16 x int8 weight); then with every ``conv*_*``
  layer named "winograd" in ``algo_overrides`` (``BASELINE.json:9``): its
  13 convs through ``kernels/winograd.py`` (PyTorch ops, as the
  reference's is plain jnp), each held against ``F.conv2d``, then the same
  in f32, its agreement alone; then full int8 (``"wgmma"``);
- GoogLeNet at batch 256, full int8 (``BASELINE.json:10``): int8 Concat
  and LRN edges, then behind an ``InferenceServer``;
- AlexNet at batch 256, full int8: its 2-group convs in PyTorch's float
  grouped conv (its baked ``int8_grouped=False``), norm2 on float edges;
  then the same with its float convs summed in f64, its agreement alone;
- SqueezeNet v1.1 at batch 1 in fp32 (``BASELINE.json:6``; cuDNN's f32
  convs, TF32 off, no hand kernel), then at batch 128 full int8
  (passthrough Concats).

Phases, each printing its own lines:

1. toolchain: versions, ``nvidia-smi``; the CUDA kernels are built from
   ``feathercnn_tpu_torch/kernels/csrc`` with ``nvcc``.
2. per path: the model is built, calibrated and loaded; one forward runs
   with every kernel's launch count set to 0 just before and read just
   after, against the path's expected counts (``EXPECTED``); the output is
   finite.  The arguments of every launch are recorded on the way, and
   for every kernel whose wrapper counts variants the variant (main loop)
   it took: every int8 GEMM launch must take "wgmma" but where the plan
   gives a reason on a path of ``FALLBACK_OK`` (MobileNet-v2's K = 24
   convs, printed), a bf16 x bf16 GEMM "mma_bf16", a bf16 x with an int8
   weight (weight-only) "wgmma_w8", an f32 x "simt"; every depthwise
   launch "k3s1"
   or "k3s2" by its stride and every chain launch, int8 or float,
   "wgmma".
3. per path, kernels: each launch of that forward is repeated on its own
   tensors and held against the kernel's plain PyTorch version (int8 out:
   equal; bf16 out: within 1 bf16 ulp; f32: within 1e-5 of the largest
   value), and timed (CUDA events, median of 20 behind a spin kernel)
   beside its bound (and the share of it reached) and a library
   yardstick (and the kernel's multiple of it): ``torch._int_mm`` at a GEMM's
   (M, K, N), and for the depthwise kernels ``F.conv2d(groups=C)`` on
   channels-last bf16 (PyTorch has no int8 grouped conv, so the int8
   kernel's yardstick is that bf16 conv too).  No single PyTorch call
   computes a bottleneck: the chain kernels have no yardstick.  Instead
   each chain call is printed beside the device time that the same blocks'
   nodes take in the profiled forward of the unchained ResNet-50 path of
   its precision (phase 4); each int8 chain call is also timed on the
   plans it did not take ("mma_sync", the first body, and "wgmma" with the
   other number of tiles per thread block), each equal to its output, and
   the sums per forward printed.  The float chain is held to its plain version
   launch by launch (block by block, on the kernel's own input of each
   block): bf16 out, every element within 2 bf16 ulp of the plain value or
   within 1e-2 of the largest, and at most 0.1% more than 1 ulp apart
   (the plain version rounds each sum once from f64, the kernel adds in
   f32 in its own order, and a bf16 store of y1, y2 or the output may
   round the other way); f32 out, within 1e-4 of the largest value.  A GEMM
   launch on float x (its sums f32 of float products) takes the same bf16
   gate.  Each "wgmma_w8" launch is also run and timed on the "simt"
   body (its earlier variant) and, where its plan splits K, on the same
   body unsplit (the plans forced through the C entry point, uncounted),
   each held to the same gate, and each path prints the sums per
   forward.  ``ident`` is bit-equal, its yardstick ``x.clone()``.
   A float GEMM's yardstick is ``torch.matmul`` in x's type, a float
   ``conv2d_implicit_gemm``'s ``F.conv2d`` on channels-last bf16 (the
   weight dequantized once).
4. per path, agreement and speed: images 0-1 (or 0) through the port on
   the CPU (the plain versions) hold top-1 equal and the prob cosine >= 0.999
   against the card (bf16 rounds at other places on the two devices, so a
   float edge may differ in its last bit and move an int8 value by one
   step); the classic zoo's paths (``LOGIT_AGREEMENT``) hold the cosine of
   the logits too, and AlexNet's and the Winograd route's that alone, each
   with a witness (the path with every float conv summed in f64, or in
   f32) that holds both (``PROB_WITNESS`` says why); median ms per batch
   and images/s over 10 forwards; one profiled forward's device time by
   kernel, by graph node (the engine names a profiler range after each
   node) and by graph op (the Winograd convs, Concat and LRN are PyTorch
   ops: their time is read here).  The
   Winograd path also holds each Winograd conv's output against
   ``F.conv2d`` (f32, TF32 off) on the same input and dequantized weight:
   RMS error within 6% of the pre-activation output's RMS and the largest
   within 25% of its largest magnitude (F(6,3) on bf16-rounded
   transformed operands; ``tests/test_torch_winograd.py``).
5. ragged cases: stride 2, C not a multiple of a kernel's vector, odd
   sizes, the lo/hi clamp, the float variants, the depthwise kernels'
   tiles (H/W not multiples of the tile, stride 2 on odd inputs, C below
   and not a multiple of the vector, a 5x5 kernel, batch 1) each on its
   planned variant, the GEMM kernels at the
   edges of their variants (M not a multiple of the tile, N = 24 and 1000,
   K = 16, 24, 32, 2048, every output type, misaligned x, each on its
   planned variant, and the refusal of a weight not in ``gemm_layout``),
   the chain's ragged shapes and output types (int8 and float modes: tile
   counts that are not a multiple of the tiles a block takes, a one-tile
   int8 launch whose columns the two consumers split, saturated conv2 sums
   on both int8 variants, a misaligned x, each on its planned variant),
   "wgmma_w8" at the edges of its design (``ragged_w8``: M 1 to 300, K 64
   to 25088, N 24 to 4096, split K, bf16 and int8 out, stride 2, C of 8
   and 72, batch 1; a K and a C not a multiple of 8 and a misaligned x
   refused to "simt", their reasons printed), and
   ``ident`` on int8, bf16 and f32 at odd sizes, against the plain
   versions.
6. server (ResNet-50, then GoogLeNet): ``InferenceServer(batch_size=B,
   batch_slots=[8, B])`` with int8 transfer; 8 client threads send 32
   requests; every answer equals the engine's direct output, with no
   fault.
7. boundary: the probe's launches counted and held against their plain
   versions, then each stage's median ms without and with ``ident``, the
   difference, and ``ident``'s own time beside its byte bound and
   ``x.clone()``.

The order: ResNet-50 (phases 2-4), the ragged cases (5), the server (6),
ResNet-50 with ``fuse_chains``, the two bf16 ResNet-50 paths, the
MobileNets, the boundary probe (7), VGG-16 (w8, w8 Winograd, w8a8),
GoogLeNet and its server, AlexNet, SqueezeNet (fp32, w8a8).  Then the
card's name and power limit, one JSON line of kernel numbers, and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero
before those lines.  Without a GPU, or without the repository beside it,
the script exits nonzero and prints no result.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

BATCH = 128          # ResNet-50
SEED = 0
# Published dense peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12       # float32 outside the tensor cores (FMA)
PEAK_BYTES = 3.35e12
KERNELS = {
    "matmul_epilogue": {
        "source": "feathercnn_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "replaces": "feathercnn_tpu/kernels/matmul.py:96"},
    "conv2d_implicit_gemm": {
        "source": "feathercnn_tpu_torch/kernels/csrc/conv_implicit_gemm.cu",
        "replaces": "feathercnn_tpu/kernels/conv.py:100"},
    "depthwise_conv2d": {
        "source": "feathercnn_tpu_torch/kernels/csrc/depthwise_conv.cu",
        "replaces": "feathercnn_tpu/kernels/depthwise.py:65"},
    "depthwise_conv2d_int8": {
        "source": "feathercnn_tpu_torch/kernels/csrc/depthwise_conv.cu",
        "replaces": "feathercnn_tpu/kernels/dispatch.py:221 (XLA's int8 "
                    "depthwise conv; no Pallas kernel)"},
    "fused_chain": {
        "source": "feathercnn_tpu_torch/kernels/csrc/fused_chain.cu",
        "replaces": "feathercnn_tpu/kernels/fused_chain.py:264"},
    "fused_chain_float": {
        "source": "feathercnn_tpu_torch/kernels/csrc/fused_chain_float.cu",
        "replaces": "feathercnn_tpu/kernels/fused_chain.py:264 (float "
                    "mode)"},
    "ident": {
        "source": "feathercnn_tpu_torch/kernels/csrc/ident.cu",
        "replaces": "bench/chain_micro.py:187"},
}
_ZERO = dict.fromkeys(KERNELS, 0)
# path -> launches of one forward.  A kernel's entry in the kernels line
# takes its numbers from the first path here that launches it.
EXPECTED = {
    "resnet50 b128": {**_ZERO, "matmul_epilogue": 33,
                      "conv2d_implicit_gemm": 16},
    "mobilenet_v1 b256": {**_ZERO, "matmul_epilogue": 14,
                          "depthwise_conv2d_int8": 13},
    "mobilenet_v1 b256 dw override": {**_ZERO, "matmul_epilogue": 14,
                                      "depthwise_conv2d": 13},
    "mobilenet_v2 b128 dw override": {**_ZERO, "matmul_epilogue": 35,
                                      "depthwise_conv2d": 17},
    # one launch per block: 4 calls over 2 + 3 + 5 + 2 identity blocks
    "resnet50 b128 fuse_chains": {**_ZERO, "matmul_epilogue": 9,
                                  "conv2d_implicit_gemm": 4,
                                  "fused_chain": 12},
    # bf16: the convs in PyTorch's float conv, the FC in matmul_epilogue
    "resnet50 b128 bf16": {**_ZERO, "matmul_epilogue": 1},
    # 5 calls over 2 + 3 + 5 + 1 + 1 identity blocks
    "resnet50 b128 bf16 fuse_chains": {**_ZERO, "matmul_epilogue": 1,
                                       "fused_chain_float": 12},
    # per stage 2-5: producer and consumer twice (without and with ident)
    "boundary b128": {**_ZERO, "matmul_epilogue": 16, "ident": 4},
    # weight-only int8: the 12 convs after the float stem and the 3 FCs on
    # "wgmma_w8" (bf16 x int8 weight)
    "vgg16 b128 w8": {**_ZERO, "matmul_epilogue": 3,
                      "conv2d_implicit_gemm": 12},
    # the 13 convs through kernels/winograd.py (PyTorch ops), the FCs as
    # above
    "vgg16 b128 w8 winograd": {**_ZERO, "matmul_epilogue": 3},
    "vgg16 b128 w8a8": {**_ZERO, "matmul_epilogue": 3,
                        "conv2d_implicit_gemm": 12},
    # 1 + 4 per inception (1x1, 3x3_reduce, 5x5_reduce, pool_proj) x 9 +
    # the FC; 1 + 2 per inception (3x3, 5x5) x 9
    "googlenet b256": {**_ZERO, "matmul_epilogue": 38,
                       "conv2d_implicit_gemm": 19},
    # conv3 and the FCs; conv2, 4 and 5 are 2-group float convs
    "alexnet b256": {**_ZERO, "matmul_epilogue": 3,
                     "conv2d_implicit_gemm": 1},
    # every conv in cuDNN's f32 conv
    "squeezenet_v11 b1 fp32": dict(_ZERO),
    # squeeze and expand1x1 per fire x 8 + conv10; expand3x3 x 8
    "squeezenet_v11 b128": {**_ZERO, "matmul_epilogue": 17,
                            "conv2d_implicit_gemm": 8},
}
# the 13 Winograd convs of the Winograd path
WINOGRAD_CONVS = 13
# F(6,3)'s error on bf16-rounded transformed operands against F.conv2d:
# RMS error / RMS of the pre-activation output, and largest error / its
# largest magnitude (tests/test_torch_winograd.py)
WINOGRAD_RMS, WINOGRAD_MAX = 0.06, 0.25
# The classic zoo's paths hold the logits' cosine (the Softmax's input)
# besides the probabilities'.
LOGIT_AGREEMENT = ("vgg16 b128 w8", "vgg16 b128 w8 winograd",
                   "vgg16 b128 w8 winograd f32", "vgg16 b128 w8a8",
                   "googlenet b256", "alexnet b256", "alexnet b256 f64 convs",
                   "squeezenet_v11 b1 fp32", "squeezenet_v11 b128")
# Paths held on the logits' cosine alone, each with its witness: the same
# path with the one change named, held on the probabilities' cosine too.
# (witness label, make_engine arguments, float convs summed in f64)
PROB_WITNESS = {
    # AlexNet's bf16 logits (largest ~16, an ulp of 0.0625) move a
    # probability by ~6% per ulp, and its float convs (the stem and three
    # grouped convs), summed in cuDNN's order and in the CPU's, round some
    # values the other way: prob cosine 0.9986 with every launch equal to
    # its plain version (in f32 too: 0.9987, its FCs keep bf16 outputs).
    # Witness: every float conv summed in f64 and rounded once, one value
    # for every order.
    "alexnet b256": ("alexnet b256 f64 convs", {}, True),
    # F(6,3) rounds transformed tiles (up to ~150|x|) to bf16 and carries
    # each through A^T (entries up to 32); the card's and the CPU's f32
    # sums round some the other way, and over 13 convs the prob cosine
    # reads 0.998-0.99999 by image in every formulation, the logits'
    # 0.9997 (tools/winograd_probe.py).  Witness: the same route in f32.
    "vgg16 b128 w8 winograd": ("vgg16 b128 w8 winograd f32",
                               {"compute_dtype": "float32"}, False),
}
CHAINS = ("fused_chain", "fused_chain_float")
GEMMS = ("matmul_epilogue", "conv2d_implicit_gemm")
# Kernels whose every counted launch must take its main variant: "k3s1"
# or "k3s2" by the stride for the depthwise kernels, "wgmma" for both
# chains.
MAIN_VARIANT = ("depthwise_conv2d", "depthwise_conv2d_int8",
                "fused_chain", "fused_chain_float")
# The paths whose int8 GEMM launches may leave "wgmma" where the plan gives
# a reason (a 24-byte row pitch: MobileNet-v2's K = 24 1x1 convs,
# GoogLeNet's 5x5 convs on 24 channels).
FALLBACK_OK = ("mobilenet_v2 b128 dw override", "googlenet b256")
# Cycles of the spin kernel queued before each timed launch: more than
# the host needs to issue the launch.
SPIN_CYCLES = 2_000_000


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def run_cmd(cmd):
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (r.stdout or r.stderr).strip()


def median_ms(fn, reps=20, warmup=3):
    """Median device time of one call of ``fn`` over ``reps`` runs (CUDA
    events).  A spin kernel queued before each run keeps the card busy
    while the host issues the launch, so the host's launch overhead does
    not count as device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 1
# ----------------------------------------------------------------------
def toolchain():
    import torch
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    say("toolchain", f"python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} triton {triton_v}")
    from feathercnn_tpu_torch.kernels import build
    nvcc = build.nvcc_path()
    say("toolchain", "nvcc: " + run_cmd([nvcc, "--version"]).splitlines()[-1])
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    say("toolchain", f"gpu: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_library()
    say("toolchain", f"kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    log = build.build_log().splitlines()
    for line in log:
        if "registers" in line or ("spill" in line and " 0 bytes spill"
                                   not in line):
            say("toolchain", "ptxas: " + line.split(":", 1)[-1].strip())
    # the int8 chain kernel's "wgmma" builds by name: <columns of conv2's
    # passes, conv2 summed per tap in f32>
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "fused_block_kernel_wg" in line:
            inst = line.split("fused_block_kernel_wgILi")[1]
            bnm, taps = inst.split("ELb")[0], inst.split("ELb")[1][0] == "1"
            spill = next(l for l in log[i + 1:i + 4] if "spill" in l)
            regs = next(l for l in log[i + 1:i + 4] if "registers" in l)
            say("toolchain", f"ptxas fused_block_kernel_wg<{bnm}, "
                f"{str(taps).lower()}>: {regs.split(':', 1)[-1].strip()}; "
                f"{spill.strip()}")
    return smi


# ----------------------------------------------------------------------
# phase 2
# ----------------------------------------------------------------------
def images(g, batch, rng):
    """``batch`` seeded images at the model's input size."""
    return rng.normal(size=(batch,) + tuple(g.inputs["data"].shape[1:])
                      ).astype(np.float32)


def calibrated(builder, batch, rng):
    """The zoo model at ``batch``, calibrated on 3 seeded batches of 8."""
    from feathercnn_tpu_torch.quant import calibrate
    g = builder(batch=batch, seed=SEED)
    calibrate(g, [images(g, 8, rng) for _ in range(3)], method="max")
    return g


def make_engine(label, g, quant="w8a8", compute_dtype="bfloat16", **config):
    from feathercnn_tpu_torch import Engine, EngineConfig
    t0 = time.perf_counter()
    cfg = EngineConfig(backend="cuda", compute_dtype=compute_dtype,
                       quant=quant, **config)
    eng = Engine(g, cfg)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    what = {"w8a8": f"w8a8 {compute_dtype}, calibrated on 3x8 seeded images",
            "w8": f"w8 (weight-only int8) {compute_dtype}, no calibration"
            }.get(quant, f"{compute_dtype}, no quantization")
    say(label, f"{what}, loaded in {time.perf_counter() - t0:.1f} s")
    return cfg, eng


def dw_override(g):
    """algo_overrides naming every depthwise conv of ``g`` "depthwise"."""
    return tuple((n.name, "depthwise") for n in g.nodes
                 if n.op == "Convolution" and n.attrs.get("group", 1) > 1)


class LaunchRecorder:
    """Wraps the dispatcher's kernel entry points for one forward and
    keeps the arguments of every wrapper call, in order, and for the GEMM
    kernels the variant (main loop) the call took."""

    def __init__(self):
        from feathercnn_tpu_torch.kernels import dispatch
        self.dispatch = dispatch
        self.launches = []

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            record = {"kernel": name, "args": dict(bound.arguments)}
            self.launches.append(record)
            if not hasattr(fn, "variants"):
                return fn(*a, **kw)
            before = dict(fn.variants)
            out = fn(*a, **kw)
            record["variant"] = "+".join(v for v, n in fn.variants.items()
                                         if n != before[v])
            return out
        return rec

    def run(self, forward, *args):
        orig = {n: getattr(self.dispatch, n) for n in KERNELS}
        try:
            for n in KERNELS:
                setattr(self.dispatch, n, self._wrap(n, orig[n]))
            return forward(*args)
        finally:
            for n in KERNELS:
                setattr(self.dispatch, n, orig[n])


def _kernel_fns():
    """name -> (wrapper, plain version)."""
    from feathercnn_tpu_torch.kernels import (conv, depthwise, fused_chain,
                                              ident, matmul)
    return {"matmul_epilogue": (matmul.matmul_epilogue,
                                matmul.matmul_epilogue_plain),
            "conv2d_implicit_gemm": (conv.conv2d_implicit_gemm,
                                     conv.conv2d_implicit_gemm_plain),
            "depthwise_conv2d": (depthwise.depthwise_conv2d,
                                 depthwise.depthwise_conv2d_plain),
            "depthwise_conv2d_int8": (depthwise.depthwise_conv2d_int8,
                                      depthwise.depthwise_conv2d_int8_plain),
            "fused_chain": (fused_chain.fused_chain,
                            fused_chain.fused_chain_plain),
            "fused_chain_float": (fused_chain.fused_chain_float,
                                  fused_chain.fused_chain_plain),
            "ident": (ident.ident, ident.ident_plain)}


def reset_counts():
    for fn, _ in _kernel_fns().values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants = dict.fromkeys(fn.variants, 0)


def gemm_plan_of(kernel, a):
    """The plan the wrapper makes for a recorded GEMM call."""
    from feathercnn_tpu_torch.kernels.matmul import (_default_out_dtype,
                                                     plan_for)
    m, k, n = dims(kernel, a)
    out_dtype = _default_out_dtype(a["x"], a["out_dtype"])
    if kernel != GEMMS[1]:
        return plan_for(m, k, n, a["x"], a["w"], out_dtype)
    nb, oh, ow, _, _, _ = dims("depthwise", a)
    return plan_for(m, k, n, a["x"], a["w"], out_dtype,
                    conv_c=a["x"].shape[3], conv_out=(nb, oh, ow),
                    stride=a["stride"])


def gemm_variant_wanted(kernel, a):
    """The variant a GEMM launch must take: "wgmma" for int8 x (int8 w);
    "wgmma_w8" for a bf16 x with an int8 weight (weight-only); "simt" for
    an f32 x (f32 on the tensor cores would be TF32) and for every other
    float conv; "mma_bf16" for a bf16 x bf16 matrix."""
    import torch
    if a["x"].dtype == torch.int8:
        return "wgmma"
    if a["x"].dtype == torch.bfloat16 and a["w"].dtype == torch.int8:
        return "wgmma_w8"
    if (a["x"].dtype == a["w"].dtype == torch.bfloat16
            and kernel == "matmul_epilogue"):
        return "mma_bf16"
    return "simt"


def check_variants(label, launches):
    """Every int8 GEMM launch of the forward took "wgmma", but on the
    paths of FALLBACK_OK where the plan gives its reason (printed); every
    bf16 x bf16 one "mma_bf16", every weight-only one (bf16 x, int8 w)
    "wgmma_w8", every f32 x one "simt"; every depthwise launch (all 3x3)
    "k3s1" or "k3s2" by its stride, and every chain launch (int8 or float)
    "wgmma"."""
    taken, exceptions = {}, []
    for i, r in enumerate(launches):
        if r["kernel"] in MAIN_VARIANT:
            v, a = r["variant"], r["args"]
            want = ("wgmma" if r["kernel"] in CHAINS
                    else f"k3s{a['stride']}")
            check(v == want, f"{label}: launch {i} {r['kernel']} took "
                  f"{v}, expected {want}")
            key = f"{r['kernel']} {v}"
            taken[key] = taken.get(key, 0) + 1
            continue
        if r["kernel"] not in GEMMS:
            continue
        a, v = r["args"], r["variant"]
        taken[v] = taken.get(v, 0) + 1
        want = gemm_variant_wanted(r["kernel"], a)
        if v == want:
            continue
        plan = gemm_plan_of(r["kernel"], a)
        m, k, n = dims(r["kernel"], a)
        what = f"launch {i} {r['kernel']} M={m} K={k} N={n}: {v} ({plan.reason})"
        check(v == plan.variant and plan.reason and label in FALLBACK_OK,
              f"{label}: {what}, expected {want}")
        exceptions.append(what)
    say(label, f"variants {taken}" + ("; not wgmma, as planned: "
                                           + "; ".join(exceptions)
                                           if exceptions else ""))


def read_counts():
    return {name: fn.launches for name, (fn, _) in _kernel_fns().items()}


def drive(label, eng, x):
    """One forward with the counts set to 0 just before and read just
    after, held to the path's expected counts; the launches recorded."""
    import torch
    recorder = LaunchRecorder()
    reset_counts()
    out = recorder.run(eng, x)
    torch.cuda.synchronize()
    counts = read_counts()
    say(label, f"one forward at b{len(x)}: launches {counts}")
    check(counts == EXPECTED[label],
          f"{label}: launches {counts}, expected {EXPECTED[label]}")
    want = ((len(x), 1, 1, 1000) if label.startswith("squeezenet")
            else (len(x), 1000))
    check(tuple(out.shape) == want,
          f"{label}: output {tuple(out.shape)}, expected {want}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    recorded = {name: sum(launches_of(r) for r in recorder.launches
                          if r["kernel"] == name) for name in KERNELS}
    check(recorded == counts, f"recorded {recorded} vs counted {counts}")
    return out, recorder.launches


def launches_of(record):
    """CUDA launches of one recorded wrapper call: the chain kernels
    launch once per block of the chain, the others once."""
    if record["kernel"] in CHAINS:
        return record["args"]["w1"].shape[0]
    return 1


# ----------------------------------------------------------------------
# phase 3
# ----------------------------------------------------------------------
def chain_ops(a):
    """Operations of one ``fused_chain`` call: per block and pixel 2 x
    (C*Cm + 9*Cm^2 + Cm*C) multiply-adds."""
    n, h, w, c = a["x"].shape
    nb, _, cm = a["w1"].shape
    return 2.0 * n * h * w * (2 * c * cm + 9 * cm * cm) * nb


def dims(kernel, a):
    """(M, K, N) of a GEMM-shaped launch, or (N, OH, OW, C, KH, KW) of a
    depthwise one."""
    if kernel == "matmul_epilogue":
        (m, k), n = a["x"].shape, a["w"].shape[1]
        return m, k, n
    x = a["x"] if "x" in a else a["xq"]
    w = a["w"] if "w" in a else a["wq"]
    nb, h, wd, c = x.shape
    kh, kw = w.shape[0], w.shape[1]
    oh = (h + 2 * a["pad_h"] - kh) // a["stride"] + 1
    ow = (wd + 2 * a["pad_w"] - kw) // a["stride"] + 1
    if kernel == "conv2d_implicit_gemm":
        return nb * oh * ow, kh * kw * c, w.shape[3]
    return nb, oh, ow, c, kh, kw


def bound_ms(kernel, a, out):
    """Least time on an H100 SXM: the larger of the bytes the function
    must move (each input read once, the output written once) over the
    memory rate and its operations over the peak for their type (int8 or
    bf16 on the tensor cores by x's type, float32 FMA for f32 x and for the
    float depthwise variant, which computes in f32; ``ident`` does none)."""
    import torch
    nbytes = out.numel() * out.element_size()
    for t in a.values():
        for u in (t if isinstance(t, (tuple, list)) else (t,)):
            if isinstance(u, torch.Tensor):
                nbytes += u.numel() * u.element_size()
    if kernel == "ident":
        ops = 0.0
    elif kernel in CHAINS:
        ops = chain_ops(a)
    else:
        ops = 2.0 * math.prod(dims(kernel, a))
    x = a["x"] if "x" in a else a["xq"]
    peak = {torch.int8: PEAK_INT8_OPS, torch.bfloat16: PEAK_BF16_OPS}.get(
        x.dtype, PEAK_F32_OPS)
    if kernel == "depthwise_conv2d":
        peak = PEAK_F32_OPS
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(kernel_out, plain_out, gate="exact"):
    """(max |kernel - plain|, within the gate, elements more than 1 bf16 ulp
    apart).  ``gate="bits"``: bit-equal.  ``gate="float"``, for a kernel
    that sums products of float inputs in f32 in another order than the
    plain version (the float chain, a GEMM of float x): bf16 out, every
    element within 2 ulp of the plain value or within 1e-2 of the largest
    |plain|, and at most 0.1% of them more than 1 ulp apart; f32 out,
    within 1e-4 of the largest |plain|.  ``gate="exact"``: int8 equal, bf16
    within 1 ulp of the plain value, f32 within 1e-5 of the output's
    magnitude."""
    import torch
    check(kernel_out.dtype == plain_out.dtype
          and kernel_out.shape == plain_out.shape,
          f"kernel gave {kernel_out.dtype}{tuple(kernel_out.shape)}, plain "
          f"{plain_out.dtype}{tuple(plain_out.shape)}")
    if gate == "bits":
        return 0.0, bool(torch.equal(kernel_out, plain_out)), 0
    k, p = kernel_out.double(), plain_out.double()
    err = (k - p).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    top = float(p.abs().max()) if p.numel() else 0.0
    if kernel_out.dtype == torch.int8:
        return max_err, max_err == 0.0, 0
    if kernel_out.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            p.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        over = int((err > ulp).sum())
        if gate == "float":
            ok = (bool(((err <= 2 * ulp) | (err <= 1e-2 * top)).all())
                  and over <= 1e-3 * err.numel())
            return max_err, ok, over
        return max_err, over == 0, over
    tol = 1e-4 if gate == "float" else 1e-5
    return max_err, max_err <= tol * top, 0


def per_launch(a, out):
    """A float chain call held against the plain version one launch (one
    block) at a time: each block's kernel output against the plain version
    of that block on the same input, the kernel's output feeding the next
    block, whose last output must equal the whole call's ``out``.  Two
    correct f32 sum orders of a bf16 chain drift apart from block to block
    (a bf16 store that rounds the other way feeds every later block), so
    the gate holds per launch, where both versions start from one input.
    Returns (max err, every launch within the gate, elements more than 1
    ulp apart, elements compared)."""
    import torch
    kernel, plain = _kernel_fns()["fused_chain_float"]
    nb = a["w1"].shape[0]
    act, worst, ok, over, elements = a["x"], 0.0, True, 0, 0
    for j in range(nb):
        blk = {k: a[k][j:j + 1] for k in ("w1", "b1", "w2", "b2", "w3", "b3")}
        blk.update(x=act, out_dtype=a["out_dtype"] if j == nb - 1 else None)
        got = kernel(**blk)
        e, o, v = compare(got, plain(**blk), "float")
        worst, ok, over = max(worst, e), ok and o, over + v
        elements += got.numel()
        act = got
    check(torch.equal(act, out), "a float chain run block by block differs "
          "from the same chain in one call")
    return worst, ok, over, elements


_LIBRARY_MS = {}


def library_ms(kernel, a):
    """The yardstick, timed once per shape and never called by the port:
    ``torch._int_mm`` (int8 x int8 -> int32, no epilogue) at an int8
    GEMM's (M, K, N), ``torch.matmul`` in x's type at a float one;
    ``F.conv2d(groups=C)`` with its bias on channels-last bf16 at a
    depthwise launch's shape; ``x.clone()`` for ``ident``."""
    import torch
    if kernel in CHAINS:            # no single PyTorch call computes it
        return None
    if kernel == "ident":
        x = a["x"]
        key = ("clone", tuple(x.shape), x.dtype)
        if key not in _LIBRARY_MS:
            _LIBRARY_MS[key] = median_ms(x.clone)
        return _LIBRARY_MS[key]
    d = dims(kernel, a)
    x = a["x"] if "x" in a else a["xq"]
    key = (kernel == "depthwise_conv2d" or kernel == "depthwise_conv2d_int8",
           d, a.get("stride"), a.get("pad_h"), a.get("pad_w"), x.dtype)
    if key not in _LIBRARY_MS:
        if kernel == "conv2d_implicit_gemm" and x.dtype != torch.int8:
            w = a["w"]
            _LIBRARY_MS[key] = _time_conv(tuple(x.shape), w.shape[0],
                                          w.shape[3], a["stride"],
                                          a["pad_h"], a["pad_w"])
        elif key[0]:
            _LIBRARY_MS[key] = _time_dw_conv(d, a["stride"], a["pad_h"],
                                             a["pad_w"])
        elif x.dtype == torch.int8:
            _LIBRARY_MS[key] = _time_int_mm(*d)
        else:
            _LIBRARY_MS[key] = _time_matmul(*d, x.dtype)
    return _LIBRARY_MS[key]


def _time_matmul(m, k, n, dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    b = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
    return median_ms(lambda: a @ b)


def _time_int_mm(m, k, n):
    import torch
    if m <= 16 or k % 8 or n % 8:
        return None
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    bt = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                       generator=gen)
    try:
        return median_ms(lambda: torch._int_mm(a, bt.t()))
    except RuntimeError as e:       # a yardstick: its absence fails nothing
        say("kernels", f"_int_mm at ({m}, {k}, {n}) refused: {e}")
        return None


def _time_conv(x_shape, k, co, stride, pad_h, pad_w):
    """F.conv2d with its bias on channels-last bf16 at a float implicit-GEMM
    launch's shape (a weight-only int8 weight dequantized once to bf16)."""
    import torch
    import torch.nn.functional as F
    nb, h, w, c = x_shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(nb, c, h, w, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(co, c, k, k, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(co, device="cuda", generator=gen).to(torch.bfloat16)
    return median_ms(lambda: F.conv2d(x, wt, b, stride=stride,
                                      padding=(pad_h, pad_w)))


def _time_dw_conv(d, stride, pad_h, pad_w):
    import torch
    import torch.nn.functional as F
    nb, oh, ow, c, kh, kw = d
    h = (oh - 1) * stride + kh - 2 * pad_h
    w = (ow - 1) * stride + kw - 2 * pad_w
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(nb, c, h, w, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(c, 1, kh, kw, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(c, device="cuda", generator=gen).to(torch.bfloat16)
    return median_ms(lambda: F.conv2d(x, wt, b, stride=stride,
                                      padding=(pad_h, pad_w), groups=c))


# Tiles at which each depthwise launch shape of a counted path is timed,
# beside the one dw_plan gives it (64 channels by 16 threads along a row
# by 16 rows for "k3s1"; for "k3s2" 64 by 32 by 8 or 64 by 16 by 16, by
# which leaves fewer outputs past the edge): (channels, threads along a
# row, rows) per variant.
DW_OTHER_TILES = {"k3s1": ((32, 16, 16), (64, 32, 8)),
                  "k3s2": ((64, 32, 8), (64, 16, 16), (128, 32, 8)),
                  "tiled": ()}
_DW_TILE_MS = {}


def dw_tile_ms(kernel, a, want):
    """{tile: median ms} of a depthwise launch at its variant's other
    tiles, launched through the C entry point on the same tensors, each
    held bit-equal to ``want`` (the plain version); timed once per shape.
    Not counted: the wrapper is not called."""
    import torch
    from feathercnn_tpu_torch.kernels import depthwise as dw
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.matmul import _ACT_CODES, _DTYPE_CODES
    int8 = kernel == "depthwise_conv2d_int8"
    x = a["xq"] if int8 else a["x"]
    s, ph, pw = a["stride"], a["pad_h"], a["pad_w"]
    w, oh, ow = dw._geometry(x, a["wq"] if int8 else a["w"], s, ph, pw)
    n, h, wd, c = x.shape
    kh, kw = w.shape[0], w.shape[1]
    odt = want.dtype
    key = (kernel, tuple(x.shape), x.dtype, odt, kh, kw, s, ph, pw)
    if key in _DW_TILE_MS:
        return _DW_TILE_MS[key]
    ss = 1 if int8 else (odt if x.dtype == torch.int8 else x.dtype).itemsize
    variant = dw.dw_plan(n, h, wd, c, kh, kw, s, ph, pw, x.element_size(),
                         ss, int8).variant
    lib = load_library()
    bias = a["bias"].data_ptr() if a["bias"] is not None else None
    res = {}
    for tile in DW_OTHER_TILES[variant]:
        plan = dw._tile_plan(variant, *tile, n, oh, ow, c, kh, kw, s,
                             x.element_size(), ss)
        out = torch.empty_like(want)

        def run():
            st = torch.cuda.current_stream().cuda_stream
            if int8:
                rc = lib.fcnn_depthwise_conv2d_int8(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), bias,
                    a["w_scale"].data_ptr(), n, h, wd, c, kh, kw, s, s, ph,
                    pw, _DTYPE_CODES[odt], _ACT_CODES[a["activation"]],
                    float(a["out_scale"]), *plan.args(), st)
            else:
                xs = a["x_scale"]
                rc = lib.fcnn_depthwise_conv2d(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), bias, n, h,
                    wd, c, kh, kw, s, s, ph, pw, _DTYPE_CODES[x.dtype],
                    _DTYPE_CODES[odt], _ACT_CODES[a["activation"]],
                    float(xs if xs is not None else 1.0), *plan.args(), st)
            check(rc == 0, f"{kernel} at tile {tile}: CUDA error {rc}")
        run()
        check(torch.equal(out, want), f"{kernel} x{tuple(x.shape)} at tile "
              f"{tile} ({plan}) differs from plain")
        res[tile] = median_ms(run)
    _DW_TILE_MS[key] = res
    return res


_W8_ALT_MS = {}


def w8_other_plans_ms(kernel, a, want):
    """{plan: median ms} of a "wgmma_w8" GEMM launch on the plans it did
    not take, launched through the C entry point on the same tensors with
    the plan forced (uncounted: the wrapper is not called), each held
    within the float gate of ``want`` (the plain version); timed once per
    shape: "simt" (the body these launches took before; 5 runs, the
    largest VGG-16 launch takes ~28 ms on it) and, for a matrix whose K the
    plan splits, "unsplit" (the same body on its 128 x BN tiles alone, one
    block each)."""
    import torch
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.matmul import GemmPlan, launch_args
    key = (kernel, tuple(a["x"].shape), tuple(a["w"].shape), a.get("stride"),
           want.dtype)
    if key in _W8_ALT_MS:
        return _W8_ALT_MS[key]
    vecs = {k: a[k] for k in ("bias", "w_scale", "lo", "hi")}
    lib = load_library()
    plans = {"simt": GemmPlan("simt")}
    taken = gemm_plan_of(kernel, a)
    if taken.split > 1:
        m, _, n = dims(kernel, a)
        plans["unsplit"] = taken._replace(
            split=1, grid=-(-m // 128) * -(-n // taken.bn))
    res = {}
    for name, plan in plans.items():
        out = torch.empty_like(want)
        ptrs, codes, _ = launch_args(a["x"], a["w"], out, vecs,
                                     a["activation"], want.dtype)

        def run(plan=plan, ptrs=ptrs, codes=codes):
            st = torch.cuda.current_stream().cuda_stream
            if kernel == "matmul_epilogue":
                m, k, n = dims(kernel, a)
                rc = lib.fcnn_matmul_epilogue(
                    *ptrs, m, k, n, *codes, float(a["x_scale"]),
                    float(a["out_scale"]), *plan.args(), None, st)
            else:
                nb, h, w, c = a["x"].shape
                kh, kw, _, co = a["w"].shape
                rc = lib.fcnn_conv_implicit_gemm(
                    *ptrs, nb, h, w, c, kh, kw, co, a["stride"],
                    a["stride"], a["pad_h"], a["pad_w"], *codes,
                    float(a["x_scale"]), float(a["out_scale"]),
                    *plan.args(), None, st)
            check(rc == 0, f"{kernel} on {name}: CUDA error {rc}")
        run()
        err, ok, _ = compare(out, want, "float")
        check(ok, f"{kernel} x{tuple(a['x'].shape)} on {name}: max err {err}")
        res[name] = (median_ms(run, reps=5, warmup=1) if name == "simt"
                     else median_ms(run))
    _W8_ALT_MS[key] = res
    return res


_CHAIN_ALT_MS = {}


def chain_alt_ms(a, want):
    """{plan: median ms} of an int8 chain call on the plans it did not
    take, launched block by block through the C entry point on the same
    tensors (uncounted), each held bit-equal to ``want`` (the call's own
    output): "mma_sync" (the first body, at tile_plan's tile), and "wgmma"
    with the other number of tiles per thread block (two for one, one for
    two), where that fits."""
    import torch
    from feathercnn_tpu_torch.kernels import fused_chain as fc
    x = a["x"]
    n, h, w, c = x.shape
    cm = a["w1"].shape[2]
    out_dtype = fc._out_dtype(x, a["out_dtype"], a["scales"])
    key = (tuple(x.shape), cm, a["w1"].shape[0], out_dtype)
    if key in _CHAIN_ALT_MS:
        return _CHAIN_ALT_MS[key]
    plan = fc.chain_plan(n, h, w, c, cm, 1)
    th, tw = fc.tile_plan(h, w, cm, 1)
    plans = {"mma_sync": fc.ChainPlan(
        "mma_sync", th, tw, 1, 3, 0, False, fc.smem_bytes(th, tw, cm, 1),
        n * -(-h // th) * -(-w // tw), "timed beside wgmma")}
    if plan.variant == "wgmma":
        try:
            plans["wgmma at the other tiles a block"] = fc.chain_plan(
                n, h, w, c, cm, 1, per_cta=3 - plan.tiles_per_cta)
        except ValueError as e:
            say("kernels", f"fused_chain x{tuple(x.shape)}: {e}")
    res = {}
    for name, pl in plans.items():
        def run(pl=pl):
            return fc._launch_blocks(x, a["w1"], a["b1"], a["w2"], a["b2"],
                                     a["w3"], a["b3"], a["w_scales"],
                                     a["scales"], out_dtype,
                                     lambda *_: pl, False)
        check(torch.equal(run(), want), f"fused_chain x{tuple(x.shape)} on "
              f"{pl} differs from its plan's output")
        res[name] = median_ms(run)
    say("kernels", f"fused_chain x{tuple(x.shape)} Cm={cm}: plan "
        f"{plan.variant}, {plan.th}x{plan.tw} tiles, {plan.tiles_per_cta} a "
        f"block, {plan.stages} stages, grid {plan.grid}; timed beside on "
        + "; ".join(f"{name} ({pl.tiles_per_cta} a block, {pl.stages} "
                    f"stages)" for name, pl in plans.items()))
    _CHAIN_ALT_MS[key] = res
    return res


def describe(kernel, a, out):
    dt = str(out.dtype).replace("torch.", "")
    if kernel == "ident":
        return (f"ident x{tuple(a['x'].shape)} "
                f"{str(a['x'].dtype).replace('torch.', '')} "
                f"chunk={a['chunk']}")
    if kernel in CHAINS:
        return (f"{kernel} x{tuple(a['x'].shape)} nb={a['w1'].shape[0]} "
                f"Cm={a['w1'].shape[2]} out={dt}")
    d = dims(kernel, a)
    if kernel in ("matmul_epilogue", "conv2d_implicit_gemm"):
        xdt = str(a["x"].dtype).replace("torch.", "")
        return (f"{kernel} M={d[0]} K={d[1]} N={d[2]} x{tuple(a['x'].shape)} "
                f"{xdt} out={dt}" + (f" stride={a['stride']}" if "stride" in a
                                     else "")
                + (" lo/hi" if a.get("lo") is not None else ""))
    x = a["x"] if "x" in a else a["xq"]
    return (f"{kernel} x{tuple(x.shape)} {str(x.dtype).replace('torch.', '')}"
            f" {d[4]}x{d[5]} s{a['stride']} {a['activation']} out={dt}")


def kernels_vs_plain(label, launches):
    """Every recorded wrapper call of a path's forward, repeated on its own
    tensors, against the plain version, and timed; one row per call.  A
    row's ``ms`` is one whole call: for ``fused_chain`` that is its
    ``launches`` (one per block of the chain)."""
    import torch
    fns = _kernel_fns()
    rows = []
    for i, launch in enumerate(launches):
        name, a = launch["kernel"], launch["args"]
        float_sums = name == "fused_chain_float" or (
            name in ("matmul_epilogue", "conv2d_implicit_gemm")
            and a["x"].dtype != torch.int8)
        gate = ("bits" if name == "ident" else "float" if float_sums
                else "exact")
        kernel, plain = fns[name]
        out = kernel(**a)
        tiles = None
        if name == "fused_chain_float":
            max_err, ok, over, elements = per_launch(a, out)
        else:
            ref = plain(**a)
            max_err, ok, over = compare(out, ref, gate)
            elements = out.numel()
            if name in ("depthwise_conv2d", "depthwise_conv2d_int8"):
                tiles = dw_tile_ms(name, a, ref)
            elif name == "fused_chain":
                tiles = chain_alt_ms(a, out)
            elif launch.get("variant") == "wgmma_w8":
                tiles = w8_other_plans_ms(name, a, ref)
            del ref
        desc = describe(name, a, out)
        check(ok, f"{label}: launch {i}, {desc}: kernel differs from plain, "
              f"max err {max_err}, {over} elements over 1 ulp")
        b_ms, b_by = bound_ms(name, a, out)
        rows.append({"path": label, "kernel": name, "shape": desc,
                     "x_shape": tuple(a["x"].shape if "x" in a
                                      else a["xq"].shape),
                     "x_bytes": (a["x"].numel() * a["x"].element_size()
                                 if "x" in a else a["xq"].numel()),
                     "over_1ulp": over, "elements": elements,
                     "float_sums": float_sums,
                     "launches": launches_of(launch),
                     "variant": launch.get("variant"),
                     "max_abs_err": max_err,
                     "ms": median_ms(lambda: kernel(**a)),
                     "plain_ms": median_ms(lambda: plain(**a), reps=3,
                                           warmup=1),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms(name, a), "tiles": tiles})
    for desc in dict.fromkeys(r["shape"] for r in rows):
        same = [r for r in rows if r["shape"] == desc]
        lib = same[0]["library_ms"]
        med = statistics.median(r["ms"] for r in same)
        over = sum(r["over_1ulp"] for r in same)
        within = ("within the float-sum gates" if same[0]["float_sums"]
                  else "equal to plain")
        say("kernels", f"{desc}: {len(same)} calls, "
            f"{sum(r['launches'] for r in same)} launches, every one {within} "
            f"(max err {max(r['max_abs_err'] for r in same)}, {over} of "
            f"{sum(r['elements'] for r in same)} elements over 1 bf16 ulp); "
            f"median {med:.4f} ms per call, bound "
            f"{same[0]['bound_ms']:.4f} ms ({same[0]['bound_by']}, "
            f"{100 * same[0]['bound_ms'] / med:.1f}% of it), plain "
            f"{statistics.median(r['plain_ms'] for r in same):.3f} ms, "
            + _library_name(desc) + f" {lib if lib is None else round(lib, 4)}"
            + ("" if lib is None else f" ({med / lib:.2f}x library)")
            + (f", variant {same[0]['variant']}" if same[0]["variant"]
               else "")
            + ("" if not same[0]["tiles"] else (
                ", other tiles " if same[0]["kernel"].startswith("depthwise")
                else ", other plans ") + ", ".join(
                f"{t} {ms:.4f}" for t, ms in same[0]["tiles"].items())))
    chains = [r for r in rows if r["kernel"] == "fused_chain" and r["tiles"]]
    if chains:
        other = {}
        for r in chains:
            for t, ms in r["tiles"].items():
                other[t] = other.get(t, 0.0) + ms
        say(label, f"int8 chain calls of one forward: "
            f"{sum(r['ms'] for r in chains):.4f} ms on the plan's "
            f"{'+'.join(dict.fromkeys(r['variant'] for r in chains))}, "
            + ", ".join(f"{v:.4f} on {t}" for t, v in other.items())
            + " (each equal to the plan's output)")
    w8 = [r for r in rows if r["variant"] == "wgmma_w8"]
    for kern in GEMMS:
        mine = [r for r in w8 if r["kernel"] == kern]
        if mine:
            unsplit = [r for r in mine if "unsplit" in r["tiles"]]
            say(label, f"{kern} weight-only launches of one forward: "
                f"{sum(r['ms'] for r in mine):.4f} ms on wgmma_w8, "
                f"{sum(r['tiles']['simt'] for r in mine):.4f} on simt "
                f"(the earlier body, each within the float gate), bound "
                f"{sum(r['bound_ms'] for r in mine):.4f}, library "
                f"{sum(r['library_ms'] for r in mine):.4f}"
                + (f"; the {len(unsplit)} split-K launches "
                   f"{sum(r['ms'] for r in unsplit):.4f} ms, unsplit "
                   f"{sum(r['tiles']['unsplit'] for r in unsplit):.4f}"
                   if unsplit else ""))
    for var in ("k3s1", "k3s2"):
        mine = [r for r in rows if r["tiles"] and r["variant"] == var]
        if not mine:
            continue
        other = {}
        for r in mine:
            for t, ms in r["tiles"].items():
                other[t] = other.get(t, 0.0) + ms
        say(label, f"depthwise {var} launches of one forward: "
            f"{sum(r['ms'] for r in mine):.4f} ms at the plan's tiles, "
            + ", ".join(f"{v:.4f} at {t}" for t, v in other.items()))
    return rows


def _library_name(desc):
    if desc.startswith("fused_chain"):
        return "library: none"
    if desc.startswith("ident"):
        return "x.clone()"
    if "depthwise" in desc:
        return "bf16 F.conv2d(groups=C)"
    if " int8 " in desc:
        return "_int_mm"
    return ("bf16 F.conv2d" if desc.startswith("conv2d_implicit_gemm")
            else "torch.matmul")


# ----------------------------------------------------------------------
# phase 4
# ----------------------------------------------------------------------
def ops_per_batch(graph):
    """2 x the multiply-adds of every conv and FC of the optimized graph
    at its declared batch (the fp stem included), and of every fused
    bottleneck (as feathercnn_tpu/utils/summary.py counts them)."""
    total = 0
    for n in graph.nodes:
        if n.op in ("FusedBottleneck", "FusedChain"):
            bn, oh, ow, c = graph.specs[n.outputs[0]].shape
            cm = graph.params[n.params[0]].shape[-1]
            total += (2 * bn * oh * ow * (2 * c * cm + 9 * cm * cm)
                      * n.attrs.get("nb", 1))
            continue
        if n.op not in ("Convolution", "InnerProduct"):
            continue
        out = graph.specs[n.outputs[0]].shape
        w = graph.params[n.params[0]].shape
        macs_per_out = np.prod(w[:-1])     # HWIO (kh*kw*cin/g) or (in, out)
        total += 2 * int(np.prod(out)) * int(macs_per_out)
    return total


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def agreement(label, g, cfg, eng, x, out):
    """Images 0-1 (0 at batch 1) through the port on the CPU against the
    card: top-1 equal and the prob cosine >= 0.999; on the classic zoo's
    paths (``LOGIT_AGREEMENT``) the cosine of the logits too, and on a
    path of ``PROB_WITNESS`` that alone, the prob cosine printed."""
    import torch
    from feathercnn_tpu_torch import Engine
    cpu = Engine(g, cfg, device="cpu")
    k = min(2, len(x))
    ref = cpu(x[:k]).double().numpy().reshape(k, -1)
    got = out[:k].double().cpu().numpy().reshape(k, -1)
    on_logits = label in LOGIT_AGREEMENT
    if on_logits:
        (blob,) = (n.inputs[0] for n in eng.graph.nodes if n.op == "Softmax")
        ref_l = cpu.run(x[:k], extract=[blob])[blob].double().numpy()
        got_l = eng.run(torch.from_numpy(x[:k]).cuda(), extract=[blob])[
            blob].double().cpu().numpy()
        ref_l, got_l = ref_l.reshape(k, -1), got_l.reshape(k, -1)
    for i in range(k):
        cos = _cosine(got[i], ref[i])
        check(got[i].argmax() == ref[i].argmax(),
              f"{label} image {i}: top-1 {got[i].argmax()} on the card, "
              f"{ref[i].argmax()} on the CPU")
        if label in PROB_WITNESS:
            held = (f"prob cosine {cos:.6f} (held on the logits; "
                    f"{PROB_WITNESS[label][0]} holds it)")
        else:
            check(cos >= 0.999, f"{label} image {i}: prob cosine {cos}")
            held = f"prob cosine {cos:.6f} (>= 0.999)"
        if on_logits:
            cos_l = _cosine(got_l[i], ref_l[i])
            check(cos_l >= 0.999, f"{label} image {i}: logit cosine {cos_l}")
            held += (f", logit cosine {cos_l:.6f} (>= 0.999; max |diff| "
                     f"{float(np.abs(got_l[i] - ref_l[i]).max()):.3e})")
        say("agreement", f"{label} image {i}: top-1 {int(got[i].argmax())} "
            f"on both, {held}, max |prob diff| "
            f"{float(np.abs(got[i] - ref[i]).max()):.3e}")


def _kernel_group(key):
    if "fused_float_block_kernel" in key:
        return "fused_chain_float"
    if "fused_block_kernel" in key:
        return "fused_chain"
    if "ident_kernel" in key:
        return "ident"
    if "dw_kernel" in key:      # dw_kernel<TX, S, INT_W, ...>, mangled or not
        return ("depthwise_conv2d_int8"
                if "Lb1E" in key or ", true," in key else "depthwise_conv2d")
    if any(k in key for k in ("wgemm_kernel", "igemm_kernel",
                              "fgemm_kernel", "w8gemm_kernel")):
        return ("conv2d_implicit_gemm" if "ConvA" in key
                else "matmul_epilogue")
    if "bgemm_kernel" in key or "splitk_reduce_kernel" in key:
        return "matmul_epilogue"
    if "at::native" in key:
        return "PyTorch's own ops"
    return ("cuDNN/cuBLAS (the float convs; the Winograd path's transforms "
            "and GEMMs)")


def speed_and_profile(label, eng, x, smi):
    """Median ms per batch over 10 synchronized forwards (input on the
    card), images/s, and one profiled forward's device time by kernel.
    Returns the median ms and the profiled forward's device ms by graph
    node (the engine's per-node profiler ranges; {} where not measured)."""
    import torch
    xd = torch.from_numpy(x).cuda()
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng(xd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times[2:])
    ops = ops_per_batch(eng.graph)
    batch = len(x)
    what, kind, peak = {
        "w8a8": ("w8a8 bf16", "int8", PEAK_INT8_OPS),
        "w8": ("w8 bf16", "bf16", PEAK_BF16_OPS)}.get(
            eng.config.quant,
            ("fp32", "f32 (FMA)", PEAK_F32_OPS)
            if eng.config.compute_dtype == "float32"
            else ("no quantization", "bf16", PEAK_BF16_OPS))
    say("speed", f"{label} {what}: median {ms:.2f} ms per batch, "
        f"{batch / ms * 1e3:.1f} images/s, {ops / batch / 1e9:.3f} GOP per "
        f"image, {ops / ms / 1e9:.1f} TOP/s = "
        f"{100 * ops / ms * 1e3 / peak:.2f}% of the dense {kind} "
        f"peak (input on the card; {smi})")

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng(xd)
        torch.cuda.synchronize()
    del xd
    rows = []
    nodes = {n.name for n in eng.graph.nodes}
    node_ms = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        on_card = "CUDA" in str(getattr(ev, "device_type", ""))
        if getattr(ev, "is_user_annotation", False):
            # a node's range as the card ran it: from the start of its
            # first kernel to the end of its last (the host-side range
            # links only PyTorch's own kernels, not the hand kernels)
            if on_card and ev.key in nodes:
                node_ms[ev.key] = dev_us / 1e3
        elif dev_us and on_card:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        say("profile", f"{label}: device time not measured (the profiler "
            "saw no CUDA kernels)")
        return ms, {}
    groups = {}
    for us, cnt, key in rows:
        grp = _kernel_group(key)
        t, c = groups.get(grp, (0.0, 0))
        groups[grp] = (t + us, c + cnt)
    say("profile", f"{label}: device kernel time of one forward: "
        f"{total / 1e3:.3f} ms over {sum(r[1] for r in rows)} kernels, busy "
        f"{100 * total / 1e3 / ms:.1f}% of the median forward; "
        + ", ".join(f"{k} {v / 1e3:.3f} ms x{c} ({100 * v / total:.1f}%)"
                    for k, (v, c) in sorted(groups.items(),
                                            key=lambda kv: -kv[1][0])))
    for us, cnt, key in rows[:12]:
        say("profile", f"{us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
            f"x{cnt} {key[:90]}")
    if node_ms:
        say("profile", f"{label}: the card's ranges of {len(node_ms)} of "
            f"{len(nodes)} graph nodes span {sum(node_ms.values()):.3f} ms "
            f"in all, against {total / 1e3:.3f} ms of kernel time")
        by_op = {}
        for n in eng.graph.nodes:
            if n.name not in node_ms:
                continue
            op = n.op
            if n.op == "Convolution" and eng.config.algo_for(n.name):
                op += f" ({eng.config.algo_for(n.name)})"
            t, c = by_op.get(op, (0.0, 0))
            by_op[op] = (t + node_ms[n.name], c + 1)
        say("profile", f"{label}: node ranges by op: " + ", ".join(
            f"{op} {t:.3f} ms x{c}" for op, (t, c) in sorted(
                by_op.items(), key=lambda kv: -kv[1][0])))
    else:
        say("profile", f"{label}: device time by node not measured (no "
            "node range carried device time)")
    return ms, node_ms


def region_nodes(graph, x_val, out_val):
    """Names of the nodes of ``graph`` that compute ``out_val`` from
    ``x_val`` (a fused chain's region on the unchained graph)."""
    producer = {v: n for n in graph.nodes for v in n.outputs}
    names, todo = set(), [out_val]
    while todo:
        v = todo.pop()
        n = producer.get(v)
        if v == x_val or n is None or n.name in names:
            continue
        names.add(n.name)
        todo += n.inputs
    return names


def chains_beside_unchained(rows, chained, unchained, node_ms):
    """Each chain call of a fuse_chains path (a FusedChain or a single
    FusedBottleneck) beside the device time that the same blocks' nodes
    took in the unchained path's profiled forward, and the design's own
    traffic between blocks (computed, not measured: each block but the
    last writes its output, the next reads it)."""
    chains = [n for n in chained.nodes
              if n.op in ("FusedChain", "FusedBottleneck")]
    calls = [r for r in rows if r["kernel"] in CHAINS]
    check(len(chains) == len(calls),
          f"{len(chains)} chain nodes, {len(calls)} chain calls")
    op_of = {n.name: n.op for n in unchained.nodes}
    for node, r in zip(chains, calls):
        region = region_nodes(unchained, node.inputs[0], node.outputs[0])
        by_op = {}          # op -> (nodes, ms, or None where not measured)
        for name in region:
            k, ms = by_op.get(op_of[name], (0, 0.0))
            got = node_ms.get(name)
            by_op[op_of[name]] = (k + 1, None if None in (ms, got)
                                  else ms + got)
        parts = [f"{k} {op} {'not measured' if ms is None else f'{ms:.4f} ms'}"
                 for op, (k, ms) in sorted(by_op.items())]
        times = [ms for _, ms in by_op.values()]
        if None not in times:
            parts.append(f"in all {sum(times):.4f} ms")
        nb, xs = node.attrs.get("nb", 1), r["x_shape"]
        say("chains", f"{node.name} x{xs} nb={nb}: {r['ms']:.4f} ms per call "
            f"({r['launches']} launches), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); the same blocks unchained: "
            + ", ".join(parts)
            + f"; {2 * (nb - 1) * r['x_bytes'] / 1e6:.1f} MB between "
            f"blocks (computed)")


def run_path(label, g, cfg, eng, x, smi, check_launch=None):
    """Phases 2-4 of one path; returns its kernel rows, its median ms per
    batch and its profiled forward's device ms by graph node."""
    import torch
    out, launches = drive(label, eng, x)
    if check_launch is not None:
        for launch in launches:
            check_launch(launch)
    check_variants(label, launches)
    rows = kernels_vs_plain(label, launches)
    del launches
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        if mine:
            sums = _sums(mine)
            say(label, f"{name} per forward: {len(mine)} calls, "
                f"{sum(r['launches'] for r in mine)} launches, "
                f"{sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms, "
                f"plain {sums['plain_ms']:.3f} ms, library "
                + ("none" if sums["library_ms"] is None
                   else f"{sums['library_ms']:.4f} ms"))
    agreement(label, g, cfg, eng, x, out)
    del out
    torch.cuda.empty_cache()
    ms, node_ms = speed_and_profile(label, eng, x, smi)
    return rows, ms, node_ms


def winograd_check(label, eng, x):
    """One forward with the dispatcher's conv entry wrapped: each Winograd
    conv's output against ``F.conv2d`` (f32, TF32 off) on the same input
    and dequantized weight, plus bias and activation, within F(6,3)'s
    error (``WINOGRAD_RMS``, ``WINOGRAD_MAX`` against the pre-activation
    output)."""
    import torch
    import torch.nn.functional as F
    from feathercnn_tpu_torch.kernels import dispatch
    from feathercnn_tpu_torch.ops.lowering import conv_hparams
    orig = dispatch.conv_forward
    worst = []

    def held(node, x, w, bias, ctx):
        out = orig(node, x, w, bias, ctx)
        if ctx.config.algo_for(node.name) != "winograd":
            return out
        _, _, _, _, ph, pw, _, _ = conv_hparams(node)
        wd = w.float()
        if w.dtype == torch.int8:
            wd = wd * torch.as_tensor(np.asarray(ctx.qinfo(node)["w_scale"],
                                                 np.float32), device=w.device)
        pre = F.conv2d(x.float().permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1),
                       padding=(ph, pw)).permute(0, 2, 3, 1)
        if bias is not None:
            pre = pre + bias
        act = node.attrs.get("activation")
        ref = (pre.clamp_min(0) if act == "relu" else
               pre.clamp(0, 6) if act == "relu6" else pre)
        err = (out.float() - ref).double()
        rms = float(err.pow(2).mean().sqrt()
                    / pre.double().pow(2).mean().sqrt())
        top = float(err.abs().max() / pre.abs().max())
        shape = tuple(x.shape) + (w.shape[3],)
        check(rms <= WINOGRAD_RMS and top <= WINOGRAD_MAX,
              f"{label}: Winograd conv x{shape}: RMS error {rms:.4f} of the "
              f"RMS, largest {top:.4f} of the largest (gates {WINOGRAD_RMS}, "
              f"{WINOGRAD_MAX})")
        worst.append((shape, rms, top))
        return out

    dispatch.conv_forward = held
    try:
        eng(x)
    finally:
        dispatch.conv_forward = orig
    torch.cuda.synchronize()
    check(len(worst) == WINOGRAD_CONVS,
          f"{label}: {len(worst)} Winograd convs, expected {WINOGRAD_CONVS}")
    for shape, rms, top in worst:
        say(label, f"Winograd conv x{shape[:4]} Co={shape[4]} vs F.conv2d "
            f"(f32): RMS error {rms:.4f} of the pre-activation RMS, largest "
            f"{top:.4f} of its largest")
    say(label, f"{len(worst)} Winograd convs within F(6,3)'s error (RMS <= "
        f"{WINOGRAD_RMS}, largest <= {WINOGRAD_MAX}); largest relative error "
        f"{max(t for _, _, t in worst):.4f}, largest RMS "
        f"{max(r for _, r, _ in worst):.4f}")


# ----------------------------------------------------------------------
# phase 5
# ----------------------------------------------------------------------
def ragged_cases():
    """Stride 2, C % 16 != 0, odd OW, ragged M/N/K, the lo/hi clamp and
    the float variants: off the main paths' shapes, each against the
    plain version."""
    import torch
    from feathercnn_tpu_torch.kernels.fused_chain import kernel_layout
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout

    fns = _kernel_fns()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def i8(*s, g=gen):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=g)

    def f32(*s, lo=0.5, hi=1.5, g=gen):
        return torch.rand(*s, device="cuda", generator=g) * (hi - lo) + lo

    def held(name, a, what):
        kernel, plain = fns[name]
        err, ok, _ = compare(kernel(**a), plain(**a))
        check(ok, f"{what}: {err}")

    n = 0
    for (nb, h, w, c, co, k, s, p) in [(4, 15, 13, 72, 40, 3, 2, 1),
                                       (2, 11, 7, 64, 64, 3, 2, 1),
                                       (2, 9, 9, 3, 24, 7, 2, 3),
                                       (1, 8, 10, 136, 130, 3, 1, 1)]:
        for out_dtype in (torch.int8, torch.bfloat16):
            a = dict(x=i8(nb, h, w, c), w=gemm_layout(i8(k, k, c, co)),
                     bias=f32(co),
                     w_scale=f32(co) * 1e-3, stride=s, pad_h=p, pad_w=p,
                     activation="relu", out_dtype=out_dtype, x_scale=0.02,
                     out_scale=0.5)
            held("conv2d_implicit_gemm", a,
                 f"conv {(nb, h, w, c, co, k, s)} {out_dtype}")
            n += 1
    for (m, k, nn) in [(1001, 72, 130), (129, 63, 64), (77, 2048, 1000)]:
        lo = torch.full((nn,), -math.inf, device="cuda")
        hi = torch.full((nn,), math.inf, device="cuda")
        lo[: nn // 2] = 0.0
        hi[nn // 4: nn // 2] = 6.0
        for extra in ({}, {"lo": lo, "hi": hi, "x_scale": 1.0}):
            a = dict(x=i8(m, k), w=gemm_layout(i8(k, nn)), bias=f32(nn),
                     w_scale=f32(nn) * 1e-3, activation=None,
                     out_dtype=torch.int8, x_scale=0.02, out_scale=0.6)
            a.update(extra)
            held("matmul_epilogue", a, f"matmul {(m, k, nn)} {sorted(extra)}")
            n += 1
    # the float variants (off the full-int8 path): f32 and bf16 inputs,
    # with weights of the same type or int8 (weight-only)
    for dt in (torch.float32, torch.bfloat16):
        for wt in (dt, torch.int8):
            def weights(*s):
                return i8(*s) if wt == torch.int8 else f32(*s, lo=-1.0,
                                                           hi=1.0).to(dt)
            ws = f32(24, lo=1e-3, hi=2e-3) if wt == torch.int8 else None
            for name, a in [
                    ("matmul_epilogue",
                     dict(x=f32(77, 130, lo=-1.0).to(dt),
                          w=gemm_layout(weights(130, 24)),
                          bias=f32(24), w_scale=ws, activation="relu")),
                    ("conv2d_implicit_gemm",
                     dict(x=f32(2, 9, 9, 20, lo=-1.0).to(dt),
                          w=gemm_layout(weights(3, 3, 20, 24)),
                          bias=f32(24), w_scale=ws,
                          stride=2, pad_h=1, pad_w=1, activation="relu6"))]:
                kernel, plain = fns[name]
                # bf16 x bf16 sums its products on the tensor cores
                err, ok, _ = compare(kernel(**a), plain(**a),
                                     "float" if wt == torch.bfloat16
                                     else "exact")
                check(ok, f"{name} {dt} x {wt}: {err}")
                n += 1
    # the depthwise kernels: C = 3, 8, 24, 30, 36, 40 (not multiples of
    # 16; 3 and 30 not of the 4-channel vector), odd sizes that are not
    # multiples of the tile, stride 1 and 2 (on odd inputs too), pad 0-2,
    # C = 1024, a 5x5 kernel (variant "tiled"), batch 1; every x and out
    # type, each launch on the variant its plan names
    # (the last five cases draw from their own generator, so the first
    # five keep the inputs they were checked with)
    gen_dw = torch.Generator(device="cuda").manual_seed(6)
    for i, (nb, h, w, c, k, s, p) in enumerate([
            (4, 15, 13, 24, 3, 2, 1), (2, 9, 9, 8, 3, 1, 1),
            (3, 11, 7, 40, 3, 2, 0), (2, 9, 7, 1024, 3, 2, 1),
            (2, 10, 12, 64, 3, 1, 0), (1, 37, 29, 36, 3, 1, 1),
            (1, 33, 35, 48, 3, 2, 1), (2, 7, 7, 3, 3, 1, 1),
            (1, 23, 21, 48, 5, 1, 2), (2, 12, 9, 30, 5, 2, 2)]):
        g = gen if i < 5 else gen_dw
        xq, wq = i8(nb, h, w, c, g=g), i8(k, k, c, g=g)
        want = f"k3s{s}" if k == 3 else "tiled"

        def dw_held(name, a, what):
            kernel = fns[name][0]
            before = dict(kernel.variants)
            held(name, a, what)
            took = [v for v, m in kernel.variants.items() if m != before[v]]
            check(took == [want], f"{what}: took {took}, planned {want}")

        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            a = dict(xq=xq, wq=wq, bias=f32(c, g=g),
                     w_scale=f32(c, g=g) * 1e-3, stride=s, pad_h=p,
                     pad_w=p, activation="relu6",
                     out_dtype=out_dtype, out_scale=20.0)
            dw_held("depthwise_conv2d_int8", a,
                    f"depthwise int8 {(nb, h, w, c, k, s, p)} {out_dtype}")
            n += 1
        wf = f32(k, k, c, lo=-1.0, hi=1.0, g=g)
        for x, extra in [(f32(nb, h, w, c, lo=-1.0, g=g), {}),
                         (f32(nb, h, w, c, lo=-1.0, g=g).to(torch.bfloat16),
                          {}),
                         (xq, {"x_scale": 0.013}),
                         (xq, {"x_scale": 0.013,
                               "out_dtype": torch.float32})]:
            a = dict(x=x, w=wf, bias=f32(c, g=g), stride=s, pad_h=p, pad_w=p,
                     activation="relu", **extra)
            dw_held("depthwise_conv2d", a,
                    f"depthwise {x.dtype} {(nb, h, w, c, k, s, p)} {extra}")
            n += 1
    # the fused chain: odd H and W, nb = 1..3, Cm <= 128 and > 128, C not a
    # multiple of 16, every output type (f32 shows both shortcut forms),
    # and a saturated conv2 sum (Cm = 257) whose f32 output pins the
    # per-tap f32 sum; each equal to plain, with no tolerance, and each
    # launch on the variant its plan names
    n += ragged_int8_chain(gen)
    say("kernels", f"{n} stride-2 / ragged / clamp / float / chain cases "
        f"equal to plain (int8 0 LSB, bf16 1 ulp, f32 1e-5 of the largest "
        f"value; the chain cases exactly)")
    n = ragged_gemm(gen)
    say("kernels", f"{n} GEMM cases at the edges of the wgmma and wgmma_w8 "
        f"designs, each on its planned variant and within its gate (int8 x "
        f"equal to plain, float x the float gate; 2 of them dot1x1's int8 "
        f"product, torch._int_mm)")
    n = ragged_float_chain(gen) + ragged_ident(gen)
    say("kernels", f"{n} float-chain and ident cases within their gates")


def ragged_int8_chain(gen):
    """The int8 chain off the main path, each call equal to the plain
    version (0 LSB int8, bit-equal bf16 and f32) and each launch on the
    variant its plan names: the first ten cases (C or Cm not a multiple of
    16 take "mma_sync"), then from their own generator the "wgmma"
    variant's edges: an odd tile count in pairs (1,127 tiles: the last
    work item's second consumer runs past the last tile), one tile whose
    columns the two consumers split (Cm = 160 > 128: conv2 per tap, each
    tap's K padded to whole ring stages), tile counts that are not a
    multiple of the grid, Cm = 48 (an odd number of conv1 passes), every
    output type; the saturated conv2 sum at Cm = 257 (C = 24: "mma_sync")
    and at Cm = 272 with C = 32 ("wgmma"), whose f32 outputs pin the
    per-tap f32 sum; a misaligned x ("mma_sync", its reason given); and the
    refusal of a weight not in kernel_layout."""
    import torch
    from feathercnn_tpu_torch.kernels.fused_chain import (chain_plan,
                                                          kernel_layout)
    kernel, plain = _kernel_fns()["fused_chain"]
    srng = np.random.default_rng(3)

    def i8(*s, g=gen):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=g)

    def f32(*s, lo=0.5, hi=1.5, g=gen):
        return torch.rand(*s, device="cuda", generator=g) * (hi - lo) + lo

    def chain(n_, h, w, c, cm, nb, out, g=gen):
        def ws(k, cols):
            return f32(nb, cols, lo=0.5e-3 / k ** 0.5, hi=1.5e-3 / k ** 0.5,
                       g=g)
        sc = [tuple(float(v) for v in srng.uniform(lo, hi, nb))
              for lo, hi in ((0.02, 0.05), (5e-4, 2e-3), (5e-4, 2e-3))]
        return dict(x=i8(n_, h, w, c, g=g), w1=i8(nb, c, cm, g=g),
                    b1=f32(nb, cm, lo=-1.0, hi=1.0, g=g),
                    w2=i8(nb, 9 * cm, cm, g=g),
                    b2=f32(nb, cm, lo=-1.0, hi=1.0, g=g),
                    w3=i8(nb, cm, c, g=g), b3=f32(nb, c, lo=-1.0, hi=1.0, g=g),
                    w_scales=(ws(c, cm), ws(9 * cm, cm), ws(cm, c)),
                    scales=(*sc, 0.05 if out == torch.int8 else None),
                    out_dtype=out)

    def saturated(c, cm, g=gen):
        v = torch.randint(100, 128, (cm,), device="cuda", generator=g)
        return dict(
            x=i8(1, 5, 6, c, g=g), w1=i8(1, c, cm, g=g),
            b1=torch.full((1, cm), 1e4, device="cuda"),
            w2=v.to(torch.int8).expand(1, 9 * cm, cm).contiguous(),
            b2=(60.0 - 127.0 * v.double() * 9 * cm).float()[None]
            .contiguous(),
            w3=i8(1, cm, c, g=g), b3=f32(1, c, lo=-1.0, hi=1.0, g=g),
            w_scales=(torch.full((1, cm), 1e-3, device="cuda"),
                      torch.ones(1, cm, device="cuda"),
                      torch.full((1, c), 1e-6, device="cuda")),
            scales=((0.03,), (1.0,), (1.0,), None), out_dtype=torch.float32)

    sat = saturated(24, 257)
    cases = [(2, 9, 11, 64, 32, 2, torch.int8),
             (2, 9, 11, 64, 32, 2, torch.float32),
             (1, 13, 9, 72, 144, 3, torch.bfloat16),
             (3, 7, 7, 48, 144, 1, torch.float32),
             (2, 8, 8, 40, 16, 3, torch.int8),
             (2, 6, 5, 24, 8, 2, torch.int8),
             (2, 15, 15, 256, 64, 2, torch.int8),
             (1, 28, 28, 512, 128, 1, torch.bfloat16),
             (1, 7, 9, 2048, 512, 1, torch.bfloat16)]
    runs = [(f"{case}", lambda case=case: chain(*case)) for case in cases]
    runs.append(("saturated conv2 sum, C=24 Cm=257", lambda: sat))
    gen_c = torch.Generator(device="cuda").manual_seed(8)
    for case in [(23, 56, 56, 64, 32, 2, torch.int8),
                 (1, 7, 7, 256, 160, 2, torch.float32),
                 (3, 17, 20, 32, 48, 3, torch.bfloat16),
                 (2, 30, 30, 128, 64, 2, torch.int8),
                 (1, 7, 9, 2048, 512, 2, torch.float32)]:
        runs.append((f"{case}", lambda case=case: chain(*case, g=gen_c)))
    runs.append(("saturated conv2 sum, C=32 Cm=272",
                 lambda: saturated(32, 272, g=gen_c)))

    def misaligned():      # one block: the next block's x is aligned
        a = chain(2, 9, 9, 32, 48, 1, torch.int8, g=gen_c)
        flat = i8(a["x"].numel() + 1, g=gen_c)
        a["x"] = flat[1:].view(a["x"].shape)
        return a
    runs.append(("misaligned x (2, 9, 9, 32, 48, 1)", misaligned))
    n = 0
    for what, make in runs:
        a = make()
        row_major = a["w1"]
        for k in ("w1", "w2", "w3"):
            a[k] = kernel_layout(a[k])
        nn_, h, w, c = a["x"].shape
        cm = a["w1"].shape[2]
        plan = chain_plan(nn_, h, w, c, cm, 1, a["x"].data_ptr() % 16 == 0)
        before = dict(kernel.variants)
        got = kernel(**a)
        took = [v for v, m in kernel.variants.items() if m != before[v]]
        check(took == [plan.variant], f"fused_chain {what}: took {took}, "
              f"planned {plan.variant}")
        err, _, _ = compare(got, plain(**a))
        check(err == 0.0, f"fused_chain {what}: max err {err}")
        say("kernels", f"fused_chain {what}: {plan.variant}"
            + (f" ({plan.reason})" if plan.reason else
               f", {plan.tiles_per_cta} tile(s) a block, grid {plan.grid}")
            + ", equal to plain")
        n += 1
        try:        # the kernel takes its own weight layout and no other
            kernel(**{**a, "w1": row_major})
            check(False, f"fused_chain {what}: a row-major w1 was taken")
        except ValueError:
            pass
    return n


def ragged_gemm(gen):
    """The GEMM kernels at the edges of their variants, each against the
    plain version and on the variant its plan names: M not a multiple of
    the 128-row tile, N = 24 and 1000, K = 16, 24, 32, 2048, every output
    type, the lo/hi clamp, a persistent grid with several tiles per block,
    stride-2 convs with C = 16, 24, 64, misaligned x (the "mma_sync"
    variant), bf16 x with an even and an odd K; and the refusal of a weight
    not in gemm_layout."""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout
    fns = _kernel_fns()

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def f32(*s, lo=0.5, hi=1.5):
        return torch.rand(*s, device="cuda", generator=gen) * (hi - lo) + lo

    def run(name, a, want, what):
        kernel, plain = fns[name]
        before = dict(kernel.variants)
        got = kernel(**a)
        v = next(k for k, c in kernel.variants.items() if c != before[k])
        check(v == want, f"{what}: took {v}, planned {want}")
        gate = "exact" if a["x"].dtype == torch.int8 else "float"
        err, ok, _ = compare(got, plain(**a), gate)
        check(ok, f"{what} ({v}): max err {err}")

    def misaligned(*s):
        flat = i8(math.prod(s) + 1)
        return flat[1:].view(*s)

    n = 0
    for (m, k, nn) in [(1001, 16, 24), (130, 24, 1000), (77, 32, 1000),
                       (129, 2048, 1000), (300, 64, 320), (40000, 128, 256),
                       (257, 96, 144)]:
        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            for clamp in (False, True):
                lo = hi = None
                if clamp:
                    lo = torch.full((nn,), -math.inf, device="cuda")
                    hi = torch.full((nn,), math.inf, device="cuda")
                    lo[: nn // 2] = 0.0
                    hi[nn // 4: nn // 2] = 6.0
                a = dict(x=i8(m, k), w=gemm_layout(i8(k, nn)), bias=f32(nn),
                         w_scale=f32(nn) * 1e-3, activation=None if clamp
                         else "relu", out_dtype=out_dtype, x_scale=0.02,
                         out_scale=0.6, lo=lo, hi=hi)
                run("matmul_epilogue", a, "mma_sync" if k % 16 else "wgmma",
                    f"matmul {(m, k, nn)} {out_dtype} clamp={clamp}")
                n += 1
    a = dict(x=misaligned(515, 64), w=gemm_layout(i8(64, 200)),
             bias=f32(200), w_scale=f32(200) * 1e-3, activation="relu",
             out_dtype=torch.int8, x_scale=0.02, out_scale=0.6)
    run("matmul_epilogue", a, "mma_sync", "matmul with misaligned x")
    n += 1
    for (nb, h, w, c, co, k, s, p) in [(3, 17, 15, 64, 96, 3, 2, 1),
                                       (2, 19, 13, 16, 40, 3, 2, 1),
                                       (2, 12, 10, 24, 32, 3, 1, 1),
                                       (2, 9, 11, 8, 64, 3, 2, 1),
                                       (4, 30, 30, 128, 256, 3, 1, 1)]:
        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            a = dict(x=i8(nb, h, w, c), w=gemm_layout(i8(k, k, c, co)),
                     bias=f32(co), w_scale=f32(co) * 1e-3, stride=s, pad_h=p,
                     pad_w=p, activation="relu6", out_dtype=out_dtype,
                     x_scale=0.02, out_scale=0.5)
            run("conv2d_implicit_gemm", a,
                "mma_sync" if c % 16 else "wgmma",
                f"conv {(nb, h, w, c, co, k, s)} {out_dtype}")
            n += 1
    a = dict(x=misaligned(2, 9, 9, 32), w=gemm_layout(i8(3, 3, 32, 48)),
             bias=f32(48), w_scale=f32(48) * 1e-3, stride=2, pad_h=1,
             pad_w=1, activation="relu", out_dtype=torch.int8, x_scale=0.02,
             out_scale=0.5)
    run("conv2d_implicit_gemm", a, "mma_sync", "conv with misaligned x")
    n += 1
    for (m, k, nn, want) in [(128, 2048, 1000, "mma_bf16"),
                             (77, 136, 24, "mma_bf16"),
                             (300, 130, 72, "simt")]:
        a = dict(x=torch.randn(m, k, device="cuda", generator=gen).to(
                     torch.bfloat16),
                 w=gemm_layout((torch.randn(k, nn, device="cuda", generator=gen)
                                * k ** -0.5).to(torch.bfloat16)),
                 bias=f32(nn), activation="relu")
        run("matmul_epilogue", a, want, f"bf16 matmul {(m, k, nn)}")
        n += 1
    n += ragged_w8(run)
    # the "dot1x1" algo's int8 product on the card (torch._int_mm, not a
    # hand kernel): exact against the f64 product of the int8 grids; a shape
    # outside _int_mm's rules raises (its own generator: the cases after
    # this function keep their inputs)
    from types import SimpleNamespace
    from feathercnn_tpu_torch.kernels.dispatch import _int8_product
    node = SimpleNamespace(name="dot1x1 case")
    g9 = torch.Generator(device="cuda").manual_seed(9)
    for (m, k, nn) in [(1000, 64, 96), (50176, 192, 64)]:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=g9)
        w = gemm_layout(torch.randint(-127, 128, (k, nn), dtype=torch.int8,
                                      device="cuda", generator=g9))
        want = (x.double() @ w.double()).float()
        check(torch.equal(_int8_product(node, x, w), want),
              f"dot1x1 int8 product {(m, k, nn)} differs from the f64 one")
        n += 1
    try:
        _int8_product(node, x[:100, :20].contiguous(),
                      gemm_layout(w[:20, :16].contiguous()))
        check(False, "dot1x1: an int8 product with K=20 was taken")
    except ValueError:
        pass
    for name, a in [("matmul_epilogue", dict(x=i8(64, 64), w=i8(64, 32))),
                    ("conv2d_implicit_gemm",
                     dict(x=i8(1, 8, 8, 16), w=i8(3, 3, 16, 32), pad_h=1,
                          pad_w=1))]:
        try:        # the kernels take gemm_layout and no other layout
            fns[name][0](**a)
            check(False, f"{name}: a weight not in gemm_layout was taken")
        except ValueError:
            pass
    return n


def ragged_w8(run):
    """"wgmma_w8" (bf16 x int8 weight) at the edges of its design, each on
    its planned variant and within its gate (``run``), on a generator of
    its own (the cases after keep their inputs).  matmul_epilogue: every M
    of 1, 77, 128, 300 by K of 64, 136 (8-byte weight pieces), 25088 by N
    of 24, 1000, 4096 (split-K where the tiles leave SMs idle), bf16 out
    on normal x (the float gate) and int8 out on integer-valued x (its f32
    sums exact in any order: equal to the plain version), the lo/hi clamp
    on every other pair.  conv2d_implicit_gemm: stride 1 and 2, C of 8, 64,
    72, 128, odd H/W, batch 1: A gathered, A by TMA, 256-wide tiles with N
    not a multiple of 256, bf16, int8 and f32 out (f32: within 1e-4 of the
    largest value).  Then a K and a C not a multiple of 8 and a
    misaligned x, each refused to "simt" with its reason printed."""
    import itertools
    import torch
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout
    gen = torch.Generator(device="cuda").manual_seed(10)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def f32(*s):
        return torch.rand(*s, device="cuda", generator=gen) + 0.5

    def x_of(shape, int8_out):
        if int8_out:   # small integers: exact products and sums
            return torch.randint(-8, 9, shape, device="cuda",
                                 generator=gen).to(torch.bfloat16)
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    def epilogue(nn, k, int8_out, clamp):
        lo = hi = None
        if clamp:
            lo = torch.full((nn,), -math.inf, device="cuda")
            hi = torch.full((nn,), math.inf, device="cuda")
            lo[: nn // 2] = 0.0
            hi[nn // 4: nn // 2] = 6.0
        spread = (0.3 / (360 * math.sqrt(k)) if int8_out
                  else 1e-2 / math.sqrt(k))
        return dict(bias=f32(nn), w_scale=f32(nn) * spread,
                    activation=None if clamp else "relu",
                    out_dtype=torch.int8 if int8_out else torch.bfloat16,
                    x_scale=0.5 if int8_out else 1.0, out_scale=100.0,
                    lo=lo, hi=hi)

    n = 0
    for i, (m, k, nn) in enumerate(itertools.product(
            (1, 77, 128, 300), (64, 136, 25088), (24, 1000, 4096))):
        int8_out, clamp = i % 2 == 1, (i // 2) % 2 == 1
        a = dict(x=x_of((m, k), int8_out), w=gemm_layout(i8(k, nn)),
                 **epilogue(nn, k, int8_out, clamp))
        run("matmul_epilogue", a, "wgmma_w8",
            f"w8 matmul {(m, k, nn)} {a['out_dtype']} clamp={clamp}")
        n += 1
    # gathered A (stride 2, C of 8 or 72), A by TMA over rectangles of
    # output pixels (stride 1, C of 64 or 128), 256-wide tiles (N > 128)
    for (nb, h, w, c, co, s, out) in [
            (1, 17, 15, 8, 64, 2, "bf16"), (1, 13, 11, 64, 96, 1, "int8"),
            (2, 9, 13, 72, 40, 2, "bf16"), (1, 15, 17, 72, 24, 1, "int8"),
            (3, 11, 9, 64, 128, 2, "bf16"), (2, 7, 9, 8, 200, 1, "int8"),
            (1, 9, 7, 128, 320, 1, "bf16"), (2, 11, 13, 64, 200, 1, "int8"),
            (1, 5, 19, 64, 72, 1, "f32"), (1, 6, 6, 128, 512, 1, "f32")]:
        int8_out = out == "int8"
        ep = epilogue(co, 9 * c, int8_out, False)
        ep["activation"] = "relu6"
        if out == "f32":
            ep["out_dtype"] = torch.float32
        a = dict(x=x_of((nb, h, w, c), int8_out),
                 w=gemm_layout(i8(3, 3, c, co)), stride=s, pad_h=1, pad_w=1,
                 **ep)
        run("conv2d_implicit_gemm", a, "wgmma_w8",
            f"w8 conv {(nb, h, w, c, co, s)} {a['out_dtype']}")
        n += 1
    flat = x_of((77 * 64 + 1,), False)
    for name, what, a in [
            ("matmul_epilogue", "K = 20",
             dict(x=x_of((50, 20), False), w=gemm_layout(i8(20, 64)),
                  **epilogue(64, 20, False, False))),
            ("conv2d_implicit_gemm", "C = 12",
             dict(x=x_of((1, 9, 9, 12), False),
                  w=gemm_layout(i8(3, 3, 12, 32)), stride=1, pad_h=1,
                  pad_w=1, **epilogue(32, 108, False, False))),
            ("matmul_epilogue", "misaligned x",
             dict(x=flat[1:].view(77, 64), w=gemm_layout(i8(64, 96)),
                  **epilogue(96, 64, False, False)))]:
        run(name, a, "simt", f"w8 {name} with {what}")
        say("ragged", f"w8 {name} with {what}: simt, as planned "
            f"({gemm_plan_of(name, a).reason})")
        n += 1
    return n


def ragged_float_chain(gen):
    """The float chain off the main path: bf16 and f32 x, C and Cm not
    multiples of a 16-byte vector (C odd once), odd H and W, Cm > 128,
    nb 1-3, an f32 output on the last block, stage 2 and 5 shapes (stage
    5 on three seeds), an f32 block at stage 4; and the refusal of an f32
    block whose tile does not fit shared memory."""
    import torch
    from feathercnn_tpu_torch.kernels.fused_chain import kernel_layout

    kernel = _kernel_fns()["fused_chain_float"][0]

    def args(n_, h, w, c, cm, nb, xdt, out, g=gen):
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * scale
        return dict(
            x=rnd(n_, h, w, c).to(xdt),
            w1=kernel_layout(rnd(nb, c, cm, scale=c ** -0.5).to(xdt)),
            b1=rnd(nb, cm, scale=0.1),
            w2=kernel_layout(rnd(nb, 9 * cm, cm, scale=(9 * cm) ** -0.5)
                             .to(xdt)),
            b2=rnd(nb, cm, scale=0.1),
            w3=kernel_layout(rnd(nb, cm, c, scale=cm ** -0.5).to(xdt)),
            b3=rnd(nb, c, scale=0.1), out_dtype=out)

    bf, f4 = torch.bfloat16, torch.float32
    n = 0
    # the first eleven cases, then (from their own generator, so those
    # keep their inputs) the "wgmma" variant's edges: tile counts that are
    # not a multiple of the two tiles a block takes (3, 5 and 15 tiles),
    # more pairs of tiles than the persistent grid's blocks (147 over 132),
    # H and W not multiples of the tile, Cm = 8 and 24 (a K step across
    # taps), C and Cm not multiples of 64 or 128, and both output types.
    # Each launch takes the variant its plan names: "wgmma" for bf16 with C
    # and Cm multiples of 8, "mma_sync" for other bf16, "fma_f32" for f32.
    gen_fc = torch.Generator(device="cuda").manual_seed(7)
    cases = [(2, 9, 11, 64, 32, 2, bf, bf),
             (2, 9, 11, 64, 32, 2, bf, f4),
             (1, 13, 9, 72, 144, 3, bf, bf),
             (2, 6, 5, 20, 12, 2, bf, bf),
             (1, 5, 7, 21, 10, 2, bf, f4),
             (3, 7, 7, 48, 144, 1, f4, f4),
             (2, 9, 11, 64, 32, 2, f4, f4),
             (2, 6, 5, 18, 6, 3, f4, bf),
             (2, 56, 56, 256, 64, 2, bf, bf),
             (2, 7, 7, 2048, 512, 1, bf, bf),
             (2, 14, 14, 1024, 256, 2, f4, f4),
             (1, 21, 7, 40, 24, 2, bf, bf),
             (1, 7, 33, 16, 8, 1, bf, f4),
             (1, 17, 20, 136, 56, 2, bf, bf),
             (6, 56, 56, 64, 32, 1, bf, bf)]
    # and the stage-5 block at three tiles (one per thread block, H and W
    # under the 8x8 tile), from generators seeded 5, 6 and 7: the inputs
    # that tools/float_chain_probe.py draws for it, where the gate is
    # tightest (K = 4608)
    runs = [(case, gen if i < 11 else gen_fc, None)
            for i, case in enumerate(cases)]
    runs += [((3, 7, 7, 2048, 512, 2, bf, bf),
              torch.Generator(device="cuda").manual_seed(seed), seed)
             for seed in (5, 6, 7)]
    for case, g, seed in runs:
        a = args(*case, g=g)
        c, cm, xdt = case[3], case[4], case[6]
        want = ("fma_f32" if xdt == f4 else
                "mma_sync" if c % 8 or cm % 8 else "wgmma")
        before = dict(kernel.variants)
        out = kernel(**a)
        took = [v for v, m in kernel.variants.items() if m != before[v]]
        check(took == [want], f"fused_chain_float {case}: took {took}, "
              f"planned {want}")
        err, ok, over, elements = per_launch(a, out)
        check(ok, f"fused_chain_float {case}: max err {err}, {over} "
              f"elements over 1 ulp")
        if seed is not None:
            say("kernels", f"fused_chain_float {case[:6]} seed {seed}: "
                f"{over} of {elements} elements of its two launches over 1 "
                f"ulp ({100.0 * over / elements:.4f}%; gate 0.1% per "
                f"launch)")
        n += 1
    try:
        kernel(**args(1, 7, 7, 2048, 512, 1, f4, f4))
        check(False, "fused_chain_float: an f32 block with Cm=512 was taken")
    except ValueError:
        pass
    return n


def ragged_ident(gen):
    """``ident`` on int8, bf16 and f32 at odd sizes, chunk 1 and 2, an
    unaligned view (the byte path), bit-equal to ``x.clone()``; and the
    refusal of a batch that is not a multiple of the chunk."""
    import torch
    kernel, plain = _kernel_fns()["ident"]
    n = 0
    for dt in (torch.int8, torch.bfloat16, torch.float32):
        base = torch.randn(5, 7, 9, 13, device="cuda", generator=gen) * 50
        base = base.to(dt)
        for x, chunk in ((base, 1), (base[1:], 2), (base[:2, :1, :1, :1]
                                                    .contiguous(), 2),
                         (base[:3], 3)):
            _, ok, _ = compare(kernel(x, chunk), plain(x, chunk), "bits")
            check(ok, f"ident {dt} {tuple(x.shape)} chunk {chunk}: differs")
            n += 1
    try:
        kernel(base, 2)
        check(False, "ident: a batch of 5 was taken with chunk 2")
    except ValueError:
        pass
    return n


# ----------------------------------------------------------------------
# phase 6
# ----------------------------------------------------------------------
def serve(eng, x, batch=BATCH, label="ResNet-50"):
    from feathercnn_tpu_torch.serve import InferenceServer
    from feathercnn_tpu_torch.serve.server import InferenceFailed

    srv = InferenceServer(eng, batch_size=batch, batch_slots=[8, batch],
                          batch_timeout_us=2000)
    check(srv._transfer_scale is not None, "int8 transfer not engaged")
    imgs = x[:32]
    q = srv._to_transfer(imgs)

    def run(b):
        return eng(b).float().cpu().numpy().reshape(len(b), -1)

    def direct_at(n):
        if n >= len(q):
            pad = np.zeros((n - len(q),) + q.shape[1:], q.dtype)
            return run(np.concatenate([q, pad]))[:len(q)]
        return np.concatenate([run(q[i:i + n])
                               for i in range(0, len(q), n)])

    direct = {n: direct_at(n) for n in (8, 32, batch)}
    diff = {n: float(np.abs(direct[n] - direct[batch]).max())
            for n in (8, 32)}
    say("server", f"{label}: direct output of the 32 images at batch 8 / 32 "
        f"vs {batch}: max |diff| {diff[8]} / {diff[32]}")
    results = [None] * len(imgs)
    errors = []
    srv.start()
    try:
        def client(t):
            for i in range(t, len(imgs), 8):
                try:
                    results[i] = srv.infer(imgs[i], timeout_s=120)
                except InferenceFailed as e:
                    errors.append((i, e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not errors, f"InferenceFailed: {errors}")
        check(all(r is not None for r in results), "a request timed out")
        for i, r in enumerate(results):
            err = float(np.abs(r.ravel() - direct[batch][i]).max())
            check(err == 0.0, f"request {i}: server answer differs from "
                  f"the direct run by {err}")
        m = srv.gauges()
        check(m["faults"] == 0, f"faults {m['faults']}")
        check(srv.healthy(), "server unhealthy")
        say("server", f"{label}: 32 requests from 8 threads in {wall:.2f} s: "
            f"{m['batches']} batches, {m['pad_images']} pad images, "
            f"0 faults, every answer equal to the direct run")
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# phase 7
# ----------------------------------------------------------------------
def boundary(label, smi):
    """The boundary probe at ResNet-50's stages 2-5, b128, chunk 2: one
    untimed run of both variants per stage with the counts set to 0 before
    and read after, every launch held against its plain version; then the
    timed runs.  Returns the kernel rows."""
    import torch
    from feathercnn_tpu_torch.kernels.ident import STAGES, boundary_probe
    recorder = LaunchRecorder()
    reset_counts()
    sums = recorder.run(lambda: [boundary_probe(st, BATCH, 2, reps=0)
                                 for st in STAGES])
    torch.cuda.synchronize()
    counts = read_counts()
    say(label, f"one untimed run of both variants at stages 2-5: launches "
        f"{counts}")
    check(counts == EXPECTED[label],
          f"{label}: launches {counts}, expected {EXPECTED[label]}")
    for r in sums:
        check(r["sum_none"] == r["sum_ident"],
              f"{label} stage {r['stage']}: sums {r['sum_none']} without "
              f"ident, {r['sum_ident']} with")
    check_variants(label, recorder.launches)
    rows = kernels_vs_plain(label, recorder.launches)
    del recorder
    idents = [r for r in rows if r["kernel"] == "ident"]
    for st, row in zip(STAGES, idents):
        p = boundary_probe(st, BATCH, 2)
        say("boundary", f"stage {st} x{p['x_shape']} int8, chunk 2: "
            f"{p['ms_none']:.4f} ms without ident, {p['ms_ident']:.4f} ms "
            f"with, boundary {p['ms_ident'] - p['ms_none']:+.4f} ms; ident "
            f"alone {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), x.clone() {row['library_ms']:.4f} ms; "
            f"sums equal ({p['sum_none']}) ({smi})")
    return rows


# ----------------------------------------------------------------------
# the kernels line
# ----------------------------------------------------------------------
def _sums(rows):
    """ms, plain_ms, bound_ms and library_ms summed over one forward's
    launches (None where a launch has no value)."""
    out = {}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        vals = [r[key] for r in rows]
        out[key] = None if any(v is None for v in vals) else sum(vals)
    return out


def kernel_summary(name, rows, counts):
    """One kernel's entry of the ``{"kernels": ...}`` line.  Its numbers
    come from the first path of ``EXPECTED`` that launches it (``path``):
    ``launches`` is that forward's count, and ms, plain_ms, bound_ms and
    library_ms sum every wrapper call of that forward.  ``paths`` gives the
    same per path that launches the kernel, and ``shapes``, per distinct
    call shape of ``path``, the wrapper calls, their CUDA launches (a
    ``fused_chain`` call launches once per block) and the median per call
    (the ``[kernels]`` lines print them for every path).
    ``launches_per_forward`` and ``max_err_vs_plain`` repeat ``launches``
    and ``max_abs_err`` under the names the port's issue tracker asks
    for."""
    paths = [p for p in EXPECTED if counts[p][name]]
    main = paths[0]
    mine = [r for r in rows if r["kernel"] == name]
    main_rows = [r for r in mine if r["path"] == main]
    sums = _sums(main_rows)
    by_bytes = sum(r["bound_ms"] for r in main_rows
                   if r["bound_by"] == "bytes")
    max_err = max(r["max_abs_err"] for r in mine)
    shapes = []
    for desc in dict.fromkeys(r["shape"] for r in main_rows):
        same = [r for r in main_rows if r["shape"] == desc]
        shapes.append({
            "shape": desc, "calls": len(same),
            "variant": same[0]["variant"],
            "launches": sum(r["launches"] for r in same),
            "bound_by": same[0]["bound_by"],
            "max_abs_err": max(r["max_abs_err"] for r in same),
            **{k: (None if any(r[k] is None for r in same)
                   else statistics.median(r[k] for r in same))
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}})
    library = ("bf16 F.conv2d(groups=C), channels-last"
               + ("; PyTorch has no int8 grouped conv" if name.endswith(
                   "_int8") else "")
               if name.startswith("depthwise") else "torch._int_mm")
    if name in CHAINS:
        library = "none: no single PyTorch call computes a bottleneck"
    elif name == "ident":
        library = "x.clone()"
    return {
        "name": name, "route": "cuda", **KERNELS[name],
        "path": main, "launches": counts[main][name],
        "launches_per_forward": counts[main][name],
        "max_abs_err": max_err, "max_err_vs_plain": max_err,
        **sums,
        "bound_by": "bytes" if 2 * by_bytes >= sums["bound_ms"]
        else "operations",
        "library": library,
        "paths": [{"path": p, "launches": counts[p][name],
                   **_sums([r for r in mine if r["path"] == p])}
                  for p in paths],
        "shapes": shapes,
    }


def witness(path, g, x, quant, config):
    """The witness of ``path``, held on the logits alone
    (``PROB_WITNESS``): the same graph and batch with the witness's change,
    its images 0-1 held to the CPU on the probabilities too
    (``agreement``)."""
    import torch
    import torch.nn.functional as F
    label, change, f64_convs = PROB_WITNESS[path]
    conv = F.conv2d

    def conv_f64(inp, weight, bias=None, *args, **kw):
        return conv(inp.double(), weight.double(),
                    None if bias is None else bias.double(), *args,
                    **kw).to(inp.dtype)

    if f64_convs:
        F.conv2d = conv_f64
    try:
        cfg, eng = make_engine(label, g, quant=quant, **{**config, **change})
        out = eng(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        agreement(label, g, cfg, eng, x, out)
    finally:
        F.conv2d = conv
    del eng, out


def classic_paths(smi, rng, rows, counts, speed):
    """The classic zoo's paths (phases 2-4 each, and GoogLeNet's server):
    VGG-16 b128 w8, w8 on the Winograd route, w8a8; GoogLeNet and AlexNet
    b256 w8a8; SqueezeNet v1.1 b1 fp32 and b128 w8a8.  Adds to ``rows``,
    ``counts`` and ``speed``."""
    import torch
    from feathercnn_tpu_torch.models import (alexnet, googlenet,
                                             squeezenet_v11, vgg16)

    # VGG-16 b128: weight-only int8 on the default route and on the
    # Winograd route (every conv*_* named "winograd"), then full int8
    g = vgg16(batch=BATCH, seed=SEED)
    x = images(g, BATCH, rng)
    wino = tuple((n.name, "winograd") for n in g.nodes
                 if n.op == "Convolution")
    for label, quant, config in [
            ("vgg16 b128 w8", "w8", {}),
            ("vgg16 b128 w8 winograd", "w8", {"algo_overrides": wino})]:
        cfg, eng = make_engine(label, g, quant=quant, **config)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
        rows += r
        if config:
            winograd_check(label, eng, x)
        del eng
        if label in PROB_WITNESS:
            witness(label, g, x, quant, config)
        torch.cuda.empty_cache()
    label = "vgg16 b128 w8a8"
    g = calibrated(vgg16, BATCH, rng)
    cfg, eng = make_engine(label, g)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
    rows += r
    del eng, x, g
    torch.cuda.empty_cache()

    # GoogLeNet b256 full int8, then its server; AlexNet b256 full int8
    for label, builder in [("googlenet b256", googlenet),
                           ("alexnet b256", alexnet)]:
        g = calibrated(builder, 256, rng)
        x = images(g, 256, rng)
        cfg, eng = make_engine(label, g)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
        rows += r
        if builder is googlenet:
            serve(eng, x, 256, "GoogLeNet")
        del eng
        if label in PROB_WITNESS:
            witness(label, g, x, "w8a8", {})
        del x
        torch.cuda.empty_cache()

    # SqueezeNet v1.1: fp32 at batch 1 (no quantization, no hand kernel),
    # then full int8 at batch 128
    label = "squeezenet_v11 b1 fp32"
    g = squeezenet_v11(batch=1, seed=SEED)
    cfg, eng = make_engine(label, g, quant=None, compute_dtype="float32")
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, images(g, 1, rng), smi)
    rows += r
    del eng
    label = "squeezenet_v11 b128"
    g = calibrated(squeezenet_v11, BATCH, rng)
    cfg, eng = make_engine(label, g)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, images(g, BATCH, rng),
                                  smi)
    rows += r
    del eng
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import feathercnn_tpu_torch  # noqa: F401  (fails without the repo)
    from feathercnn_tpu_torch.models import (mobilenet_v1, mobilenet_v2,
                                             resnet50)

    t_start = time.perf_counter()
    smi = toolchain()
    rng = np.random.default_rng(SEED)
    rows, counts, speed = [], {}, {}

    # ResNet-50 b128, then its server
    label = "resnet50 b128"
    g = calibrated(resnet50, BATCH, rng)
    cfg, eng = make_engine(label, g)
    x = rng.normal(size=(BATCH, 224, 224, 3)).astype(np.float32)
    counts[label] = EXPECTED[label]
    r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
    rows += r
    ragged_cases()
    serve(eng, x)
    unchained = eng.graph
    del eng
    torch.cuda.empty_cache()

    # ResNet-50 b128 with fuse_chains: the same calibrated graph with the
    # wildcard region table that bench.py --fuse-chains sets
    label = "resnet50 b128 fuse_chains"
    g.meta["chain_regions"] = {"*": True}
    cfg, eng = make_engine(label, g, fuse_chains=True)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                  _chain_launch_check(label))
    rows += r
    chains_beside_unchained(r, eng.graph, unchained, node_ms)
    del eng
    torch.cuda.empty_cache()

    # ResNet-50 b128 in bf16 (no quantization): unchained, the yardstick of
    # the float chains, then with fuse_chains and the wildcard region table
    g = resnet50(batch=BATCH, seed=SEED)
    label = "resnet50 b128 bf16"
    cfg, eng = make_engine(label, g, quant=None)
    counts[label] = EXPECTED[label]
    r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
    rows += r
    unchained = eng.graph
    del eng
    torch.cuda.empty_cache()
    label = "resnet50 b128 bf16 fuse_chains"
    g.meta["chain_regions"] = {"*": True}
    cfg, eng = make_engine(label, g, quant=None, fuse_chains=True)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                  _float_chain_launch_check(label))
    rows += r
    chains_beside_unchained(r, eng.graph, unchained, node_ms)
    del eng, x, unchained
    torch.cuda.empty_cache()

    # MobileNet-v1 b256 on its default route and with the dw override
    g = calibrated(mobilenet_v1, 256, rng)
    x = rng.normal(size=(256, 224, 224, 3)).astype(np.float32)
    for label, config, want in [
            ("mobilenet_v1 b256", {}, None),
            ("mobilenet_v1 b256 dw override",
             {"algo_overrides": dw_override(g)},
             (torch.int8, "relu", torch.bfloat16))]:
        cfg, eng = make_engine(label, g, **config)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                      _dw_launch_check(label, want))
        rows += r
        del eng
        torch.cuda.empty_cache()
    del x

    # MobileNet-v2 b128 with the dw override
    label = "mobilenet_v2 b128 dw override"
    g = calibrated(mobilenet_v2, 128, rng)
    x = rng.normal(size=(128, 224, 224, 3)).astype(np.float32)
    cfg, eng = make_engine(label, g, algo_overrides=dw_override(g))
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                  _dw_launch_check(label, (
                                      torch.bfloat16, "relu6",
                                      torch.bfloat16)))
    rows += r
    del eng, x
    torch.cuda.empty_cache()

    label = "boundary b128"
    counts[label] = EXPECTED[label]
    rows += boundary(label, smi)

    classic_paths(smi, rng, rows, counts, speed)

    say("done", f"every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s (from the start of the "
        f"build); ms per batch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in speed.items()))
    summary = [kernel_summary(name, rows, counts) for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _chain_launch_check(label):
    """A check of the fuse_chains path's chain calls: int8 x (the lowering
    quantizes the bf16 edge into stage 5 with a divide, as the reference
    does), nb 2, 3, 5, 2 in order, int8 out but on the last chain (bf16 for
    the global AVE pool)."""
    import torch
    seen = []

    def check_launch(launch):
        if launch["kernel"] != "fused_chain":
            return
        a = launch["args"]
        check(a["x"].dtype == torch.int8,
              f"{label}: chain input {a['x'].dtype}, expected int8")
        seen.append((a["w1"].shape[0], a["scales"][3] is not None))
        if len(seen) == 4:
            check(seen == [(2, True), (3, True), (5, True), (2, False)],
                  f"{label}: chain calls (nb, int8 out) {seen}")
            say(label, f"4 chain calls, (nb, int8 out) {seen}, every x int8")
    return check_launch


def _float_chain_launch_check(label):
    """A check of the bf16 fuse_chains path's chain calls: bf16 x and
    output, nb 2, 3, 5 (the chains) then 1, 1 (stage 5's single blocks)."""
    import torch
    seen = []

    def check_launch(launch):
        if launch["kernel"] != "fused_chain_float":
            return
        a = launch["args"]
        out = a["out_dtype"] or a["x"].dtype
        check(a["x"].dtype == torch.bfloat16 and out == torch.bfloat16,
              f"{label}: chain call with x {a['x'].dtype}, out {out}; "
              f"expected bfloat16 both")
        seen.append(a["w1"].shape[0])
        if len(seen) == 5:
            check(seen == [2, 3, 5, 1, 1], f"{label}: chain calls nb {seen}")
            say(label, f"5 chain calls, nb {seen}, x and output bf16")
    return check_launch


def _dw_launch_check(label, want):
    """A check of each float depthwise launch of an override path: its x
    type, activation and output type."""
    if want is None:
        return None
    x_dtype, act, out_dtype = want

    def check_launch(launch):
        if launch["kernel"] != "depthwise_conv2d":
            return
        a = launch["args"]
        got = (a["x"].dtype, a["activation"],
               a["out_dtype"] or a["x"].dtype)
        check(got == want, f"{label}: depthwise launch with x "
              f"{got[0]}, {got[1]}, out {got[2]}; expected {x_dtype}, "
              f"{act}, {out_dtype}")
    return check_launch


if __name__ == "__main__":
    try:
        rc = main()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
