"""The port's int8 and f32 arithmetic, each rule written once: the
activations, the f32 device scalar, the int8 store and the two
requantization rules that end in it, dequantization, the single-rounding
FMA and the NHWC conv.  The package's bottom layer: it imports nothing of
the package, and ``ops/``, ``kernels/`` and ``parallel/`` build on it."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["apply_activation", "act_segment_bounds", "apply_act_segments",
           "scalar", "weak", "to_int8", "quantize", "requantize",
           "reciprocal", "dequantize", "dequantize_edge", "fma_f32", "fma",
           "sum_terms", "conv_hparams", "nchw_conv"]


def apply_activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """Fused epilogue activations."""
    if act is None:
        return x
    if act == "relu":
        return torch.clamp_min(x, 0)
    if act == "relu6":
        return torch.clamp(x, 0, 6)
    raise ValueError(f"unknown activation {act!r}")


def act_segment_bounds(segments):
    """Per-output-channel (lo, hi) clamp bounds of merged sibling convs:
    relu -> [0, inf), relu6 -> [0, 6], none -> (-inf, inf)."""
    lo = np.concatenate([
        np.full(c, 0.0 if a in ("relu", "relu6") else -np.inf, np.float32)
        for a, c in segments])
    hi = np.concatenate([
        np.full(c, 6.0 if a == "relu6" else np.inf, np.float32)
        for a, c in segments])
    return lo, hi


def apply_act_segments(y: torch.Tensor, segments) -> torch.Tensor:
    """Per-output-channel activation for horizontally merged convs
    (passes.merge_sibling_convs), as one clamp.  ``y`` must be float
    (pre-requant)."""
    lo, hi = act_segment_bounds(segments)
    lo = torch.as_tensor(lo, device=y.device)
    hi = torch.as_tensor(hi, device=y.device)
    return torch.minimum(torch.maximum(y, lo), hi)


def scalar(v: float, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``: arithmetic with it rounds like
    the reference's f32 arithmetic with a Python float (CUDA replaces a
    division by a host scalar with a multiply by its reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def weak(v: float, x: torch.Tensor) -> torch.Tensor:
    """The Python number ``v`` as the reference's arithmetic with ``x``
    takes it (JAX's weak typing): rounded to x's type first."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def to_int8(v: torch.Tensor) -> torch.Tensor:
    """The int8 store: ``clip(round_half_even(v), -127, 127)`` as int8."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """The divide rule: ``to_int8(x / scale)`` in f32, ``scale`` an f32
    device scalar made from a number (a tensor as it is)."""
    if not torch.is_tensor(scale):
        scale = scalar(scale, x.device)
    return to_int8(x.float() / scale)


def requantize(y: torch.Tensor, mul) -> torch.Tensor:
    """The multiply rule: ``to_int8(y * mul)``, ``mul`` an f32 device
    scalar made from a number (a tensor as it is).  With ``mul`` the f32
    ``1 / scale`` it may round a value differently from :func:`quantize`
    at ``scale``: each site takes the rule, and the multiplier, that the
    reference's compiled form has there."""
    if not torch.is_tensor(mul):
        mul = scalar(mul, y.device)
    return to_int8(y * mul)


def reciprocal(y_scale: float) -> float:
    """``1 / y_scale`` as the reference's compiled requantization takes it:
    XLA folds a division by the constant ``y_scale`` (rounded to f32) into
    a multiply by its reciprocal, rounded to f32."""
    return float(np.float32(1.0) / np.float32(y_scale))


def dequantize(x: torch.Tensor, scale) -> torch.Tensor:
    """An edge's value in f32: an int8 ``x`` at ``scale`` is ``x * scale``,
    the scale an f32 device scalar; a float ``x`` is taken as it is."""
    if x.dtype != torch.int8:
        return x.float()
    return x.float() * scalar(scale, x.device)


def dequantize_edge(x: torch.Tensor, q, dtype: torch.dtype) -> torch.Tensor:
    """An int8 ``x`` that a float path reads, as ``dtype``: dequantized at
    its node's ``x_scale`` (a stray int8 edge), else at ``input_scale`` (a
    serving-transferred int8 input into a float stem), else at 1.0 (``q``,
    the node's quant metadata, None).  A float ``x`` passes as it is."""
    if x.dtype != torch.int8:
        return x
    s = (q.get("x_scale") or q.get("input_scale", 1.0)) if q else 1.0
    return dequantize(x, s).to(dtype)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a*b + c`` rounded once, bit for bit a hardware FMA.  The
    product of two f32 values is exact in f64.  The f64 sum is then
    rounded to odd (TwoSum gives its exact error; an inexact sum with an
    even last bit steps one ulp toward the error), and an f64 value
    rounded to odd, with 29 more bits than f32, rounds to the f32 value of
    the exact sum."""
    b64 = b.double() if torch.is_tensor(b) else float(b)
    c64 = c.double()
    p = a.double() * b64
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    step = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (a fused multiply-add), whatever
    ATen's CPU dispatch picks: on the card ``torch.addcmul``, one FMA per
    element (``chip_smoke.py`` holds it to ``fma_f32``); on the CPU
    :func:`fma_f32`, since ``torch.addcmul`` is an FMA on ATen's
    vectorized paths only (under ``ATEN_CPU_CAPABILITY=default`` it rounds
    the product first)."""
    if a.is_cuda or b.is_cuda or c.is_cuda:
        return torch.addcmul(c, a, b)
    return fma_f32(a, b, c)


def sum_terms(terms):
    """Left-to-right sum of ``x*s`` terms (s None: plain ``x``), fusing a
    product into the add that consumes it: ``a*s + t`` and ``t + b*s`` are
    single-rounding FMAs (:func:`fma`), preferring the left operand."""
    (x0, s0), rest = terms[0], terms[1:]
    if not rest:
        return x0 * s0 if s0 is not None else x0
    (x1, s1), rest = rest[0], rest[1:]
    if s0 is not None:
        acc = fma(x0, s0, x1 * s1 if s1 is not None else x1)
    else:
        acc = fma(x1, s1, x0) if s1 is not None else x0 + x1
    for x, s in rest:
        acc = fma(x, s, acc) if s is not None else acc + x
    return acc


def conv_hparams(node):
    """(kh, kw, sh, sw, ph, pw, dilation, group) of a conv node's
    attributes, with Caffe's defaults."""
    a = node.attrs
    kh = a.get("kernel_h", a.get("kernel_size", 1))
    kw = a.get("kernel_w", a.get("kernel_size", 1))
    sh = a.get("stride_h", a.get("stride", 1))
    sw = a.get("stride_w", a.get("stride", 1))
    ph = a.get("pad_h", a.get("pad", 0))
    pw = a.get("pad_w", a.get("pad", 0))
    dil = a.get("dilation", 1)
    group = a.get("group", 1)
    return kh, kw, sh, sw, ph, pw, dil, group


def nchw_conv(x: torch.Tensor, w: torch.Tensor, stride, padding,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC x (..., C) with HWIO w -> NHWC result of ``F.conv2d`` in the
    inputs' dtype (the NHWC storage is used as channels-last memory)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)
