"""The port's int8 and f32 arithmetic, each rule written once: the
activations, the int8 store and the two requantization rules that end in
it, dequantization, the single-rounding FMA and the NHWC conv.  The
package's bottom layer: it imports nothing of the package, and ``ops/``,
``kernels/`` and ``parallel/`` build on it.

A rule's scale is a device tensor (or a :class:`Scale`, which carries one)
that its node made once and keeps (``ops.lowering.LoweringCtx.const``):
none of these functions copies a number to the card."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["apply_activation", "act_segment_bounds", "apply_act_segments",
           "Scale", "scale_tensor", "to_int8", "quantize", "requantize",
           "reciprocal", "dequantize", "edge_scale", "fma_f32", "fma",
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


def apply_act_segments(y: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor) -> torch.Tensor:
    """Per-output-channel activation for horizontally merged convs
    (passes.merge_sibling_convs), as one clamp between the device tensors
    ``lo`` and ``hi`` of :func:`act_segment_bounds` (made once per node).
    ``y`` must be float (pre-requant)."""
    return torch.minimum(torch.maximum(y, lo), hi)


class Scale(float):
    """A node's number as both forms it is used in: the float a CUDA
    kernel takes as its argument, and ``t``, the same number as an f32 0-d
    tensor on the node's device, which PyTorch's ops (a kernel's plain
    version, a fallback) compute with.  A CUDA op rounds a host float
    otherwise than the reference's f32 arithmetic (it divides by one as a
    multiply by its reciprocal), and copying one to the card waits for it,
    so the node makes both once and keeps them
    (``ops.lowering.LoweringCtx.scale``)."""

    def __new__(cls, v, t: torch.Tensor):
        self = super().__new__(cls, v)
        self.t = t
        return self

    def __reduce__(self):
        return Scale, (float(self), self.t)


def scale_tensor(v, device) -> torch.Tensor:
    """``v`` as the f32 0-d tensor the rules compute with: a tensor as it
    is, a :class:`Scale`'s ``t``.  A bare number, which only tests pass
    (on the CPU), is made into one on ``device``."""
    if torch.is_tensor(v):
        return v
    if isinstance(v, Scale):
        return v.t
    return torch.tensor(v, dtype=torch.float32, device=device)


def to_int8(v: torch.Tensor) -> torch.Tensor:
    """The int8 store: ``clip(round_half_even(v), -127, 127)`` as int8."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """The divide rule: ``to_int8(x / scale)`` in f32, ``scale`` an f32
    device tensor (:func:`scale_tensor`)."""
    return to_int8(x.float() / scale_tensor(scale, x.device))


def requantize(y: torch.Tensor, mul) -> torch.Tensor:
    """The multiply rule: ``to_int8(y * mul)``, ``mul`` an f32 device
    tensor (:func:`scale_tensor`).  With ``mul`` the f32 ``1 / scale`` it
    may round a value differently from :func:`quantize` at ``scale``: each
    site takes the rule, and the multiplier, that the reference's compiled
    form has there."""
    return to_int8(y * scale_tensor(mul, y.device))


def reciprocal(y_scale: float) -> float:
    """``1 / y_scale`` as the reference's compiled requantization takes it:
    XLA folds a division by the constant ``y_scale`` (rounded to f32) into
    a multiply by its reciprocal, rounded to f32."""
    return float(np.float32(1.0) / np.float32(y_scale))


def dequantize(x: torch.Tensor, scale) -> torch.Tensor:
    """An edge's value in f32: an int8 ``x`` at ``scale`` is ``x * scale``,
    the scale an f32 device tensor (:func:`scale_tensor`); a float ``x`` is
    taken as it is."""
    if x.dtype != torch.int8:
        return x.float()
    return x.float() * scale_tensor(scale, x.device)


def edge_scale(q) -> float:
    """The scale at which a float path reads an int8 edge: its node's
    ``x_scale`` (a stray int8 edge), else ``input_scale`` (a
    serving-transferred int8 input into a float stem), else 1.0 (``q``,
    the node's quant metadata, None)."""
    return (q.get("x_scale") or q.get("input_scale", 1.0)) if q else 1.0


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
