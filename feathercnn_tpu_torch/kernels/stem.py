"""``stem_conv_int8``: the float stem, a conv on the image's few channels
(C_in <= 4) with bf16 operands and f32 sums, its bias, activation and int8
requantization in one kernel, bit-equal to its plain version.

Counterpart of the reference's float conv branch
(``feathercnn_tpu/kernels/dispatch.py:232-252``, the end of
``conv_forward``: ``conv_general_dilated`` of the bf16 input and the
dequantized weight with ``preferred_element_type=float32``, + bias, the
activation, then ``clip(round(y * out_scale), -127, 127)``), which has no
Pallas kernel: XLA compiles it.  The port's own composition of that branch
is :func:`stem_conv_plain` (the input cast to f32, PyTorch's conv, then the
bias, the activation and the requantization as PyTorch ops); the
dispatcher's float branch runs it for every float conv the kernel does not
take.  On a CUDA tensor :func:`stem_conv_int8` launches the hand-written
kernel in ``csrc/stem_conv.cu`` (whose header note gives its bound on an
H100 and its design), with ``out_scale`` and the activation as kernel
arguments, so the node makes no host sync; on a CPU tensor it computes
:func:`stem_conv_plain`.  The kernel sums each output's taps in (r, s, c)
order with f32 FMAs, as PyTorch's CPU conv sums a stem padded by at most
(k - 1) / 2 (every zoo stem but FCN's pad 100), so there the card's int8
stem equals the port's on the CPU.

:func:`takes_stem_kernel` decides from what the dispatcher observes: a
bf16 input of C_in <= 4 channels, group 1, no dilation, an int8 output
with one activation (no per-channel segments), Co in ``STEM_CO``, kernel
sides up to 11, strides 1-4, and a weight and a band of input rows that
fit in one SM's shared memory (:func:`stem_plan`).  The weight goes to the
kernel as f32 in the lanes' order (:func:`stem_layout`), made once per
node.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..numerics import (apply_act_segments, apply_activation, nchw_conv,
                        requantize)
from .matmul import _ACT_CODES

__all__ = ["STEM_CO", "StemPlan", "stem_conv_int8", "stem_conv_plain",
           "stem_layout", "stem_plan", "takes_stem_kernel"]

# output channels -> (CL, P): CL lanes share a pixel, each with Co / CL
# channels, and each lane takes P pixels (csrc/stem_conv.cu's
# instantiations: every zoo stem's width)
STEM_CO = {24: (2, 4), 32: (4, 8), 64: (8, 8), 96: (8, 4)}
_WARPS = 8
# a block's shared memory: two blocks an SM where they fit, else one
# (227 KB an SM, 1 KB of it the system's per block)
_SMEM_BLOCKS = (115200, 231424)
_TH_MAX = 64


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class StemPlan:
    """A launch of the stem kernel: ``th`` output rows a band, the
    ``rows`` input rows it stages as f32 at a pitch of ``rp`` floats
    (``lead`` zeros before each row's data), and the block's shared
    memory."""
    th: int
    rows: int
    lead: int
    rp: int
    smem: int


def stem_plan(h: int, w: int, c: int, kh: int, kw: int, co: int, sh: int,
              sw: int, ph: int, pw: int) -> Optional[StemPlan]:
    """The plan ``fcnn_stem_conv`` takes for a stem of this geometry (the
    C entry derives the same rows), or None where the kernel does not take
    it.  ``th`` minimizes the bands an image times their rounds of warp
    work (one round more a band for staging its rows) among the bands
    whose shared memory lets two blocks share an SM, or, where none does
    (AlexNet's 11x11 weight on 96 channels: 139 KB as f32), one block."""
    if (co not in STEM_CO or not 1 <= c <= 4 or not 1 <= kh <= 11
            or not 1 <= kw <= 11 or not 1 <= sh <= 4 or not 1 <= sw <= 4
            or ph < 0 or pw < 0 or h + 2 * ph < kh or w + 2 * pw < kw):
        return None
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    lead = _round_up(pw * c, 8)
    last = lead + ((ow - 1) * sw - pw + kw) * c
    rp = _round_up(max(lead + w * c, last), 8)
    cl, p = STEM_CO[co]
    unit = 32 // cl * p
    fixed = 4 * kh * kw * c * co + 4 * co
    for budget in _SMEM_BLOCKS:
        best = None
        for th in range(1, min(oh, _TH_MAX) + 1):
            rows = (th - 1) * sh + kh
            smem = fixed + 4 * rows * rp
            if smem > budget:
                break
            units = math.ceil(th * ow / unit)
            cost = math.ceil(oh / th) * (math.ceil(units / _WARPS) + 1)
            if best is None or cost < best[0]:
                best = (cost, StemPlan(th, rows, lead, rp, smem))
        if best:
            return best[1]
    return None


def stem_layout(w: torch.Tensor) -> torch.Tensor:
    """The (KH, KW, C, Co) stem weight in the kernel's layout: f32, K over
    (r, s, c) as the sums run, and each K row's Co channels as 16-byte
    vectors in the lanes' order, (K, Co / CL / 4, CL, 4): lane ``cl`` holds
    channels ``cl * Q`` to ``cl * Q + Q - 1`` (Q = Co / CL, ``STEM_CO``),
    and the CL lanes' v-th vectors lie side by side."""
    kh, kw, c, co = w.shape
    cl, _ = STEM_CO[co]
    return (w.float().reshape(kh * kw * c, cl, co // cl // 4, 4)
            .permute(0, 2, 1, 3).contiguous())


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: Sequence[int],
                    padding: Sequence[int], activation: Optional[str] = None,
                    out_scale: float = 1.0, wk: Optional[torch.Tensor] = None,
                    dilation: int = 1, groups: int = 1, bounds=None,
                    out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The dispatcher's float conv in PyTorch ops, the plain version of
    :func:`stem_conv_int8` (``wk`` unused): the NHWC ``x`` and HWIO ``w``
    cast to f32, PyTorch's conv (f32 sums; TF32 off on the card), + bias,
    the activation (or, for merged convs, the per-channel clamp between
    the kept ``bounds``, ``(lo, hi)``), then for an int8 ``out_dtype``
    ``clip(round_half_even(y * out_scale), -127, 127)`` with ``out_scale``
    as an f32 device tensor (the node's kept ``numerics.Scale``), else
    ``y`` cast to ``out_dtype``."""
    y = nchw_conv(x.float(), w.float(), tuple(stride), tuple(padding),
                  dilation, groups)
    if bias is not None:
        y = y + bias
    y = apply_act_segments(y, *bounds) if bounds is not None \
        else apply_activation(y, activation)
    if out_dtype == torch.int8:
        return requantize(y, out_scale)
    return y.to(out_dtype)


def _plan_of(x: torch.Tensor, w: torch.Tensor, stride, padding):
    kh, kw, c, co = w.shape
    return stem_plan(x.shape[1], x.shape[2], c, kh, kw, co, stride[0],
                     stride[1], padding[0], padding[1])


def takes_stem_kernel(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                      padding: Sequence[int], groups: int = 1,
                      dilation: int = 1,
                      out_dtype: torch.dtype = torch.int8,
                      segments=None) -> bool:
    """Whether :func:`stem_conv_int8` computes this float conv: a 4-d bf16
    ``x`` of C_in <= 4 channels and its bf16 (KH, KW, C_in, Co) weight,
    group 1, no dilation, an int8 output with one activation (no
    ``segments``) and a geometry :func:`stem_plan` takes.  Decides without
    launching."""
    return (x.dim() == 4 and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16 and w.dim() == 4
            and x.shape[-1] == w.shape[2] and groups == 1 and dilation == 1
            and out_dtype == torch.int8 and segments is None
            and _plan_of(x, w, tuple(stride), tuple(padding)) is not None)


def stem_conv_int8(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: Sequence[int],
                   padding: Sequence[int], activation: Optional[str] = None,
                   out_scale: float = 1.0,
                   wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``clip(round_half_even(act(conv(x, w) + bias) * out_scale), -127,
    127)`` as int8 NHWC, on a bf16 NHWC ``x`` and the bf16 HWIO ``w``
    (f32 sums of exact bf16 products over the taps in (r, s, c) order, as
    :func:`stem_conv_plain` sums them), ``bias`` f32 (Co,) or None,
    ``stride`` and ``padding`` (h, w) pairs, ``activation`` None, "relu" or
    "relu6", ``out_scale`` the f32 multiplier (1 / y_scale).  ``wk``: ``w``
    as :func:`stem_layout` makes it (made here where None).  A CPU tensor
    takes :func:`stem_conv_plain`; a CUDA one launches the kernel, and
    raises where :func:`takes_stem_kernel` does not hold."""
    stride, padding = tuple(stride), tuple(padding)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, bias, stride, padding, activation,
                               out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not takes_stem_kernel(x, w, stride, padding):
        raise ValueError(
            f"stem_conv_int8: no kernel for x {x.dtype}{tuple(x.shape)}, "
            f"w {w.dtype}{tuple(w.shape)}, stride {stride}, padding "
            f"{padding}")
    plan = _plan_of(x, w, stride, padding)
    kh, kw, c, co = w.shape
    n, h, wd, _ = x.shape
    oh = (h + 2 * padding[0] - kh) // stride[0] + 1
    ow = (wd + 2 * padding[1] - kw) // stride[1] + 1
    out = torch.empty((n, oh, ow, co), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    if wk is None:
        wk = stem_layout(w)
    cl, _ = STEM_CO[co]
    if (wk.shape != (kh * kw * c, co // cl // 4, cl, 4)
            or wk.dtype != torch.float32 or not wk.is_contiguous()):
        raise ValueError(f"stem_conv_int8: weight layout {wk.dtype}"
                         f"{tuple(wk.shape)} is not stem_layout's")
    x = x.contiguous()
    b = None
    if bias is not None:
        b = bias.float().contiguous()
    from .build import load_library
    rc = load_library().fcnn_stem_conv(
        x.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), n, h, wd, c, kh, kw, co, stride[0], stride[1],
        padding[0], padding[1], plan.th, _ACT_CODES[activation],
        float(out_scale), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_conv_int8 launch failed: CUDA error {rc} "
                           f"(x={tuple(x.shape)} w={tuple(w.shape)} "
                           f"stride={stride} padding={padding})")
    stem_conv_int8.launches += 1
    return out


stem_conv_int8.launches = 0
# int8-emitting float convs on C_in <= 4 channels that takes_stem_kernel
# sent to stem_conv_plain on the "cuda" backend (a width, kernel or stride
# the kernel does not take, segments, a float input)
stem_conv_int8.fallbacks = 0
