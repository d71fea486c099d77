"""``conv2d_implicit_gemm``: NHWC convolution as an implicit GEMM.

Counterpart of ``feathercnn_tpu/kernels/conv.py`` (the Pallas kernel
``conv2d_implicit_gemm``, :100).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/conv_implicit_gemm.cu`` (whose header note
says what bounds it on an H100 and what its design does about that); on a
CPU tensor it computes the same function with
:func:`conv2d_implicit_gemm_plain`.  Stride 1 or 2 (any stride works),
zero padding, f32 / bf16 / weight-only int8 / full int8, the epilogue of
``matmul_epilogue``.  :func:`~.matmul.gemm_plan` picks the main loop of
each launch; on the GPU the weight must be stored as
:func:`~.matmul.gemm_layout` gives it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .matmul import (VARIANTS, _default_out_dtype, check_operands,
                     epilogue_plain, launch_args, plan_for)

__all__ = ["conv2d_implicit_gemm", "conv2d_implicit_gemm_plain"]


def conv2d_implicit_gemm_plain(x, w, bias=None, w_scale=None, stride: int = 1,
                               pad_h: int = 0, pad_w: int = 0,
                               activation=None, out_dtype=None,
                               x_scale: float = 1.0, out_scale: float = 1.0,
                               lo=None, hi=None):
    """Plain PyTorch version of the kernel: a float64 convolution of the
    int8 grids (exact) or an f32 convolution of float inputs, then the same
    epilogue in the same order."""
    out_dtype = _default_out_dtype(x, out_dtype)
    ct = torch.float64 if x.dtype == torch.int8 else torch.float32
    xc = x.to(ct).permute(0, 3, 1, 2)
    wc = w.to(x.dtype).to(ct).permute(3, 2, 0, 1)
    acc = F.conv2d(xc, wc, stride=stride, padding=(pad_h, pad_w))
    acc = acc.permute(0, 2, 3, 1).float()
    return epilogue_plain(acc, w_scale, x_scale, bias, activation, lo, hi,
                          out_dtype, out_scale)


def conv2d_implicit_gemm(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         w_scale: Optional[torch.Tensor] = None,
                         stride: int = 1, pad_h: int = 0, pad_w: int = 0,
                         activation: Optional[str] = None,
                         out_dtype: Optional[torch.dtype] = None,
                         x_scale: float = 1.0, out_scale: float = 1.0,
                         lo: Optional[torch.Tensor] = None,
                         hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC conv.  x: (N, H, W, C) float32/bfloat16/int8; w: (KH, KW, C, Co)
    same type or int8, on the GPU stored as ``gemm_layout`` gives it; bias,
    w_scale, lo, hi: (Co,) float32.  A CPU ``x`` takes the plain version; a
    CUDA ``x`` launches the variant ``gemm_plan`` picks, counted in
    ``conv2d_implicit_gemm.variants``, or raises."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv shapes {tuple(x.shape)} (NHWC) and "
                         f"{tuple(w.shape)} (HWIO) do not match")
    if stride < 1 or pad_h < 0 or pad_w < 0:
        raise ValueError(f"bad stride/pad {stride}/{pad_h}/{pad_w}")
    out_dtype = _default_out_dtype(x, out_dtype)
    N, H, W, C = x.shape
    KH, KW, _, Co = w.shape
    OH = (H + 2 * pad_h - KH) // stride + 1
    OW = (W + 2 * pad_w - KW) // stride + 1
    if OH <= 0 or OW <= 0:
        raise ValueError(f"kernel {KH}x{KW} larger than padded input "
                         f"{H}x{W}")
    vecs = {"bias": bias, "w_scale": w_scale, "lo": lo, "hi": hi}
    check_operands(x, w, vecs, Co, out_dtype, activation, lo, hi)
    if x.device.type == "cpu":
        return conv2d_implicit_gemm_plain(x, w, bias, w_scale, stride, pad_h,
                                          pad_w, activation, out_dtype,
                                          x_scale, out_scale, lo, hi)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty((N, OH, OW, Co), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptrs, codes, stream = launch_args(x, w, out, vecs, activation, out_dtype)
    plan = plan_for(N * OH * OW, KH * KW * C, Co, x, w, out_dtype, conv_c=C,
                    conv_out=(N, OH, OW), stride=stride)
    from .build import load_library
    rc = load_library().fcnn_conv_implicit_gemm(
        *ptrs, N, H, W, C, KH, KW, Co, stride, stride, pad_h, pad_w, *codes,
        float(x_scale), float(out_scale), *plan.args(), None, stream)
    if rc != 0:
        raise RuntimeError(
            f"conv2d_implicit_gemm launch failed: CUDA error {rc} "
            f"(x={tuple(x.shape)} w={tuple(w.shape)} stride={stride} {plan})")
    conv2d_implicit_gemm.launches += 1
    conv2d_implicit_gemm.variants[plan.variant] += 1
    return out


conv2d_implicit_gemm.launches = 0
conv2d_implicit_gemm.variants = dict.fromkeys(VARIANTS, 0)
