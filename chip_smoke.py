#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feathercnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path: ResNet-50 at full width and 224x224, seeded
random weights, calibrated by the port, full int8 (``quant="w8a8"``) with
bf16 float activations, batch 128, on the "cuda" backend, behind an
``InferenceServer``.  Phases, each printing its own lines:

1. toolchain: versions, ``nvidia-smi``; the CUDA kernels are built from
   ``feathercnn_tpu_torch/kernels/csrc`` with ``nvcc``.
2. engine: the model is built, calibrated (``method="max"``) and loaded.
3. main path: one forward at batch 128 with the kernels' launch counts set
   to 0 just before and read just after (33 launches of matmul_epilogue
   and 16 of conv2d_implicit_gemm per forward); the logits are finite.
   The arguments of every launch are recorded on the way.
4. kernels: each of the 49 launches of that forward is repeated on the
   same tensors and held against the kernel's plain PyTorch version (int8
   out: equal; bf16 out: within 1 bf16 ulp), with stride-2 and ragged
   cases besides; each is timed (CUDA events, median of 20 after warm-up)
   beside its bound and the ``torch._int_mm`` time at the same (M, K, N).
5. agreement and speed: images 0-1 through the port on the CPU (the plain
   versions) hold top-1 equal and the prob cosine >= 0.999 against the
   card (bf16 rounds at other places on the two devices, so a float edge
   may differ in its last bit and move an int8 value by one step); median
   ms per batch and images/s.
6. server: ``InferenceServer(batch_size=128, batch_slots=[8, 128])`` with
   int8 transfer; 8 client threads send 32 requests; every answer equals
   the engine's direct output, with no fault.

Then the card's name and power limit, one JSON line of kernel numbers,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero before those lines.  Without a GPU, or without the repository
beside it, the script exits nonzero and prints no result.
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

BATCH = 128
SEED = 0
# Published dense peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
KERNELS = {
    "matmul_epilogue": {
        "source": "feathercnn_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "replaces": "feathercnn_tpu/kernels/matmul.py:96"},
    "conv2d_implicit_gemm": {
        "source": "feathercnn_tpu_torch/kernels/csrc/conv_implicit_gemm.cu",
        "replaces": "feathercnn_tpu/kernels/conv.py:100"},
}
EXPECTED_LAUNCHES = {"matmul_epilogue": 33, "conv2d_implicit_gemm": 16}
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
    for line in build.build_log().splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill"
                                   not in line):
            say("toolchain", "ptxas: " + line.split(":", 1)[-1].strip())
    return smi


# ----------------------------------------------------------------------
# phase 2-3
# ----------------------------------------------------------------------
def build_engine(rng):
    from feathercnn_tpu_torch import Engine, EngineConfig
    from feathercnn_tpu_torch.models import resnet50
    from feathercnn_tpu_torch.quant import calibrate

    t0 = time.perf_counter()
    g = resnet50(batch=BATCH, seed=SEED)
    cal = [rng.normal(size=(8, 224, 224, 3)).astype(np.float32)
           for _ in range(3)]
    calibrate(g, cal, method="max")
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16",
                       quant="w8a8")
    eng = Engine(g, cfg)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    say("engine", f"resnet50 b{BATCH} w8a8 bf16 calibrated on 3x8 seeded "
        f"images and loaded in {time.perf_counter() - t0:.1f} s")
    return g, cfg, eng


class LaunchRecorder:
    """Wraps the dispatcher's two kernel entry points for one forward and
    keeps the arguments of every launch, in order."""

    def __init__(self):
        from feathercnn_tpu_torch.kernels import dispatch
        self.dispatch = dispatch
        self.launches = []

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            self.launches.append({"kernel": name,
                                  "args": dict(bound.arguments)})
            return fn(*a, **kw)
        return rec

    def run(self, forward, *args):
        names = ("matmul_epilogue", "conv2d_implicit_gemm")
        orig = {n: getattr(self.dispatch, n) for n in names}
        try:
            for n in names:
                setattr(self.dispatch, n, self._wrap(n, orig[n]))
            return forward(*args)
        finally:
            for n in names:
                setattr(self.dispatch, n, orig[n])


def reset_counts():
    from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
    from feathercnn_tpu_torch.kernels.matmul import matmul_epilogue
    matmul_epilogue.launches = 0
    conv2d_implicit_gemm.launches = 0


def read_counts():
    from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
    from feathercnn_tpu_torch.kernels.matmul import matmul_epilogue
    return {"matmul_epilogue": matmul_epilogue.launches,
            "conv2d_implicit_gemm": conv2d_implicit_gemm.launches}


# ----------------------------------------------------------------------
# phase 4
# ----------------------------------------------------------------------
def gemm_dims(kernel, a):
    """(M, K, N) of the launch as a GEMM."""
    if kernel == "matmul_epilogue":
        (m, k), n = a["x"].shape, a["w"].shape[1]
        return m, k, n
    nb, h, w, c = a["x"].shape
    kh, kw, _, co = a["w"].shape
    oh = (h + 2 * a["pad_h"] - kh) // a["stride"] + 1
    ow = (w + 2 * a["pad_w"] - kw) // a["stride"] + 1
    return nb * oh * ow, kh * kw * c, co


def bound_ms(kernel, a, out):
    """Least time on an H100 SXM: the larger of the bytes the function
    must move (each input read once, the output written once) over the
    memory rate and its int8 operations over the int8 peak."""
    m, k, n = gemm_dims(kernel, a)
    nbytes = out.numel() * out.element_size()
    for key in ("x", "w", "bias", "w_scale", "lo", "hi"):
        t = a.get(key)
        if t is not None:
            nbytes += t.numel() * t.element_size()
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 2.0 * m * n * k / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(kernel_out, plain_out):
    """Max |kernel - plain| and whether it is within the tolerance: int8
    equal, bf16 within 1 ulp of the plain value, f32 within 1e-5 of the
    output's magnitude."""
    import torch
    check(kernel_out.dtype == plain_out.dtype
          and kernel_out.shape == plain_out.shape,
          f"kernel gave {kernel_out.dtype}{tuple(kernel_out.shape)}, plain "
          f"{plain_out.dtype}{tuple(plain_out.shape)}")
    k, p = kernel_out.double(), plain_out.double()
    err = (k - p).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if kernel_out.dtype == torch.int8:
        return max_err, max_err == 0.0
    if kernel_out.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            p.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        return max_err, bool((err <= ulp).all())
    return max_err, max_err <= 1e-5 * float(p.abs().max())


_INT_MM_MS = {}


def int_mm_ms(m, k, n):
    """``torch._int_mm`` (int8 x int8 -> int32, no epilogue) at (M, K, N):
    a yardstick only, never called by the port.  Timed once per shape."""
    if (m, k, n) not in _INT_MM_MS:
        _INT_MM_MS[(m, k, n)] = _time_int_mm(m, k, n)
    return _INT_MM_MS[(m, k, n)]


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


def kernels_vs_plain(launches):
    """Every recorded launch of the main path, repeated on its own
    tensors, against the plain version; one row per launch."""
    from feathercnn_tpu_torch.kernels.conv import (
        conv2d_implicit_gemm, conv2d_implicit_gemm_plain)
    from feathercnn_tpu_torch.kernels.matmul import (
        matmul_epilogue, matmul_epilogue_plain)
    fns = {"matmul_epilogue": (matmul_epilogue, matmul_epilogue_plain),
           "conv2d_implicit_gemm": (conv2d_implicit_gemm,
                                    conv2d_implicit_gemm_plain)}
    rows = []
    for i, launch in enumerate(launches):
        name, a = launch["kernel"], launch["args"]
        kernel, plain = fns[name]
        out = kernel(**a)
        ref = plain(**a)
        max_err, ok = compare(out, ref)
        m, k, n = gemm_dims(name, a)
        desc = (f"{name} M={m} K={k} N={n} x{tuple(a['x'].shape)} "
                f"out={str(out.dtype).replace('torch.', '')}"
                + (f" stride={a['stride']}" if "stride" in a else "")
                + (" lo/hi" if a.get("lo") is not None else ""))
        check(ok, f"launch {i}, {desc}: kernel differs from plain, max err "
              f"{max_err}")
        b_ms, b_by = bound_ms(name, a, out)
        rows.append({"kernel": name, "shape": desc, "max_abs_err": max_err,
                     "ms": median_ms(lambda: kernel(**a)),
                     "plain_ms": median_ms(lambda: plain(**a), reps=3,
                                           warmup=1),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": int_mm_ms(m, k, n)})
    for desc in dict.fromkeys(r["shape"] for r in rows):
        same = [r for r in rows if r["shape"] == desc]
        say("kernels", f"{desc} x{len(same)}: every launch equal to plain "
            f"(max err {max(r['max_abs_err'] for r in same)}); median "
            f"{statistics.median(r['ms'] for r in same):.4f} ms, bound "
            f"{same[0]['bound_ms']:.4f} ms ({same[0]['bound_by']}), plain "
            f"{statistics.median(r['plain_ms'] for r in same):.3f} ms, "
            f"_int_mm {same[0]['library_ms']}")
    return rows


def ragged_cases():
    """Stride 2, C % 16 != 0, odd OW, ragged M/N/K, the lo/hi clamp and
    the float variants: off the batch-128 path's shapes, each against the
    plain version."""
    import torch

    from feathercnn_tpu_torch.kernels.conv import (
        conv2d_implicit_gemm, conv2d_implicit_gemm_plain)
    from feathercnn_tpu_torch.kernels.matmul import (
        matmul_epilogue, matmul_epilogue_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def f32(*s, lo=0.5, hi=1.5):
        return torch.rand(*s, device="cuda", generator=gen) * (hi - lo) + lo

    n = 0
    for (nb, h, w, c, co, k, s, p) in [(4, 15, 13, 72, 40, 3, 2, 1),
                                       (2, 11, 7, 64, 64, 3, 2, 1),
                                       (2, 9, 9, 3, 24, 7, 2, 3),
                                       (1, 8, 10, 136, 130, 3, 1, 1)]:
        for out_dtype in (torch.int8, torch.bfloat16):
            a = dict(x=i8(nb, h, w, c), w=i8(k, k, c, co), bias=f32(co),
                     w_scale=f32(co) * 1e-3, stride=s, pad_h=p, pad_w=p,
                     activation="relu", out_dtype=out_dtype, x_scale=0.02,
                     out_scale=0.5)
            err, ok = compare(conv2d_implicit_gemm(**a),
                              conv2d_implicit_gemm_plain(**a))
            check(ok, f"conv {(nb, h, w, c, co, k, s)} {out_dtype}: {err}")
            n += 1
    for (m, k, nn) in [(1001, 72, 130), (129, 63, 64), (77, 2048, 1000)]:
        lo = torch.full((nn,), -math.inf, device="cuda")
        hi = torch.full((nn,), math.inf, device="cuda")
        lo[: nn // 2] = 0.0
        hi[nn // 4: nn // 2] = 6.0
        for extra in ({}, {"lo": lo, "hi": hi, "x_scale": 1.0}):
            a = dict(x=i8(m, k), w=i8(k, nn), bias=f32(nn),
                     w_scale=f32(nn) * 1e-3, activation=None,
                     out_dtype=torch.int8, x_scale=0.02, out_scale=0.6)
            a.update(extra)
            err, ok = compare(matmul_epilogue(**a), matmul_epilogue_plain(**a))
            check(ok, f"matmul {(m, k, nn)} {sorted(extra)}: {err}")
            n += 1
    # the float variants (off the full-int8 path): f32 and bf16 inputs,
    # with weights of the same type or int8 (weight-only)
    for dt in (torch.float32, torch.bfloat16):
        for wt in (dt, torch.int8):
            def weights(*s):
                return i8(*s) if wt == torch.int8 else f32(*s, lo=-1.0,
                                                           hi=1.0).to(dt)
            ws = f32(24, lo=1e-3, hi=2e-3) if wt == torch.int8 else None
            for out, plain, a in [
                    (matmul_epilogue, matmul_epilogue_plain,
                     dict(x=f32(77, 130, lo=-1.0).to(dt), w=weights(130, 24),
                          bias=f32(24), w_scale=ws, activation="relu")),
                    (conv2d_implicit_gemm, conv2d_implicit_gemm_plain,
                     dict(x=f32(2, 9, 9, 20, lo=-1.0).to(dt),
                          w=weights(3, 3, 20, 24), bias=f32(24), w_scale=ws,
                          stride=2, pad_h=1, pad_w=1, activation="relu6"))]:
                err, ok = compare(out(**a), plain(**a))
                check(ok, f"{out.__name__} {dt} x {wt}: {err}")
                n += 1
    say("kernels", f"{n} stride-2 / ragged / clamp / float cases equal to "
        f"plain (int8 0 LSB, bf16 1 ulp, f32 1e-5 of the largest value)")


# ----------------------------------------------------------------------
# phase 5
# ----------------------------------------------------------------------
def ops_per_batch(graph):
    """2 x the multiply-adds of every conv and FC of the optimized graph
    at its declared batch (the fp stem included)."""
    total = 0
    for n in graph.nodes:
        if n.op not in ("Convolution", "InnerProduct"):
            continue
        out = graph.specs[n.outputs[0]].shape
        w = graph.params[n.params[0]].shape
        macs_per_out = np.prod(w[:-1])     # HWIO (kh*kw*cin/g) or (in, out)
        total += 2 * int(np.prod(out)) * int(macs_per_out)
    return total


def agreement_and_speed(g, cfg, eng, x, out, smi):
    import torch

    from feathercnn_tpu_torch import Engine
    cpu = Engine(g, cfg, device="cpu")
    ref = cpu(x[:2]).double().numpy().reshape(2, -1)
    got = out[:2].double().cpu().numpy().reshape(2, -1)
    for i in range(2):
        cos = float(got[i] @ ref[i]
                    / (np.linalg.norm(got[i]) * np.linalg.norm(ref[i])))
        check(got[i].argmax() == ref[i].argmax(),
              f"image {i}: top-1 {got[i].argmax()} on the card, "
              f"{ref[i].argmax()} on the CPU")
        check(cos >= 0.999, f"image {i}: prob cosine {cos}")
        say("agreement", f"image {i}: top-1 {int(got[i].argmax())} on both, "
            f"prob cosine {cos:.6f} (>= 0.999), max |diff| "
            f"{float(np.abs(got[i] - ref[i]).max()):.3e}")

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
    say("speed", f"resnet50 w8a8 bf16 b{BATCH}: median {ms:.2f} ms per "
        f"batch, {BATCH / ms * 1e3:.1f} images/s, {ops / BATCH / 1e9:.3f} "
        f"GOP per image, {ops / ms / 1e9:.1f} TOP/s = "
        f"{100 * ops / ms * 1e3 / PEAK_INT8_OPS:.2f}% of the dense int8 "
        f"peak (input on the card; {smi})")

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng(xd)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        say("profile", "device time not measured (the profiler saw no "
            "CUDA kernels)")
        return ms
    groups = {"the port's kernels": 0.0, "PyTorch's own ops": 0.0,
              "other libraries (the cuDNN stem)": 0.0}
    for us, _, key in rows:
        grp = ("the port's kernels" if "fcnn::" in key else
               "PyTorch's own ops" if "at::native" in key else
               "other libraries (the cuDNN stem)")
        groups[grp] += us
    say("profile", f"device kernel time of one forward: {total / 1e3:.3f} "
        f"ms over {sum(r[1] for r in rows)} kernels, busy "
        f"{100 * total / 1e3 / ms:.1f}% of the median forward; "
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in groups.items()))
    for us, cnt, key in rows[:12]:
        say("profile", f"{us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
            f"x{cnt} {key[:90]}")
    return ms


# ----------------------------------------------------------------------
# phase 6
# ----------------------------------------------------------------------
def serve(eng, x):
    from feathercnn_tpu_torch.serve import InferenceServer
    from feathercnn_tpu_torch.serve.server import InferenceFailed

    srv = InferenceServer(eng, batch_size=BATCH, batch_slots=[8, BATCH],
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

    direct = {n: direct_at(n) for n in (8, 32, BATCH)}
    diff = {n: float(np.abs(direct[n] - direct[BATCH]).max())
            for n in (8, 32)}
    say("server", f"direct output of the 32 images at batch 8 / 32 vs "
        f"{BATCH}: max |diff| {diff[8]} / {diff[32]}")
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
            err = float(np.abs(r.ravel() - direct[BATCH][i]).max())
            check(err == 0.0, f"request {i}: server answer differs from "
                  f"the direct run by {err}")
        m = srv.gauges()
        check(m["faults"] == 0, f"faults {m['faults']}")
        check(srv.healthy(), "server unhealthy")
        say("server", f"32 requests from 8 threads in {wall:.2f} s: "
            f"{m['batches']} batches, {m['pad_images']} pad images, "
            f"0 faults, every answer equal to the direct run")
    finally:
        srv.stop()


def kernel_summary(name, rows, launches):
    """One kernel's entry of the ``{"kernels": ...}`` line.  ms, plain_ms,
    bound_ms and library_ms sum every launch of one forward; ``shapes``
    gives, per distinct launch shape, its launches and the median per
    launch.  ``launches_per_forward`` and ``max_err_vs_plain`` repeat
    ``launches`` and ``max_abs_err`` under the names the port's issue
    tracker asks for."""
    def per_forward(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    def per_shape(same, key):
        vals = [r[key] for r in same]
        return None if any(v is None for v in vals) \
            else statistics.median(vals)

    bound = per_forward("bound_ms")
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    max_err = max(r["max_abs_err"] for r in rows)
    shapes = []
    for desc in dict.fromkeys(r["shape"] for r in rows):
        same = [r for r in rows if r["shape"] == desc]
        shapes.append({"shape": desc, "launches": len(same),
                       "bound_by": same[0]["bound_by"],
                       "max_abs_err": max(r["max_abs_err"] for r in same),
                       **{k: per_shape(same, k) for k in (
                           "ms", "plain_ms", "bound_ms", "library_ms")}})
    return {
        "name": name, "route": "cuda", **KERNELS[name],
        "launches": launches, "launches_per_forward": launches,
        "max_abs_err": max_err, "max_err_vs_plain": max_err,
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": bound,
        "bound_by": "bytes" if 2 * by_bytes >= bound else "operations",
        "library_ms": per_forward("library_ms"),
        "shapes": shapes,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import feathercnn_tpu_torch  # noqa: F401  (fails without the repo)

    t_start = time.perf_counter()
    smi = toolchain()
    rng = np.random.default_rng(SEED)
    g, cfg, eng = build_engine(rng)
    x = rng.normal(size=(BATCH, 224, 224, 3)).astype(np.float32)

    recorder = LaunchRecorder()
    reset_counts()
    out = recorder.run(eng, x)
    torch.cuda.synchronize()
    counts = read_counts()
    say("main path", f"one forward at b{BATCH}: launches {counts}")
    for name, want in EXPECTED_LAUNCHES.items():
        check(counts[name] == want,
              f"{name}: {counts[name]} launches, expected {want}")
    check(tuple(out.shape) == (BATCH, 1000), f"output {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    recorded = {name: sum(1 for r in recorder.launches
                          if r["kernel"] == name) for name in KERNELS}
    check(recorded == counts, f"recorded {recorded} vs counted {counts}")

    rows = kernels_vs_plain(recorder.launches)
    ragged_cases()
    agreement_and_speed(g, cfg, eng, x, out, smi)
    serve(eng, x)

    say("done", f"every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    summary = [kernel_summary(name, [r for r in rows if r["kernel"] == name],
                              counts[name]) for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
