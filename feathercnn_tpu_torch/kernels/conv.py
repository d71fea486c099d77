"""``conv2d_implicit_gemm``: NHWC convolution as an implicit GEMM.

Counterpart of ``feathercnn_tpu/kernels/conv.py`` (the Pallas kernel
``conv2d_implicit_gemm``, :100).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/conv_implicit_gemm.cu`` (whose header note
says what bounds it on an H100 and what its design does about that); on a
CPU tensor it computes the same function with
:func:`conv2d_implicit_gemm_plain`.  Any stride, one for both axes or an
(sh, sw) pair (the reference's Pallas kernel takes 1-2 and leaves the
rest, a non-square stride too, to XLA's int8 conv), zero padding, any
dilation (the reference leaves a dilated int8 conv to XLA's int8 conv,
``feathercnn_tpu/kernels/dispatch.py:221-252``), f32 / bf16 / weight-only
int8 / full int8, the epilogue of ``matmul_epilogue``.  A grouped int8
conv (``groups`` > 1: the reference's XLA grouped int8 conv,
``feathercnn_tpu/kernels/dispatch.py:221-231``, a group = C conv that is
not plain depthwise among them) runs as
super-groups: its weight compacted by :func:`~.matmul.grouped_layout`, each
column tile of q whole groups reads only their S = q * C/group = 32 input
channels (entry ``fcnn_conv_implicit_gemm_grouped``, variant
"wgmma_halo"), or, where no q fits (:func:`~.matmul.supergroup`), on its
block-diagonal weight as an ungrouped conv.
:func:`~.matmul.gemm_plan` picks the main loop of each launch; on the GPU
the weight must be stored as :func:`~.matmul.gemm_layout` gives it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .matmul import (VARIANTS, _default_out_dtype, check_operands,
                     epilogue_plain, launch_args, plan_for, split_workspace,
                     stride_pair, supergroup)

__all__ = ["conv2d_implicit_gemm", "conv2d_implicit_gemm_plain"]


def _grouped_width(c: int, co: int, groups: int, kernel, stride) -> int:
    """The width S of the weight a grouped conv of ``groups`` groups over C
    channels takes: ``grouped_layout``'s at :func:`~.matmul.supergroup`'s
    q, or C (the block-diagonal weight) where no q fits."""
    if c % groups or co % groups:
        return 0
    q = supergroup(c, co, groups, kernel, stride)[0]
    return q * c // groups if q else c


def conv2d_implicit_gemm_plain(x, w, bias=None, w_scale=None, stride=1,
                               pad_h: int = 0, pad_w: int = 0,
                               activation=None, out_dtype=None,
                               x_scale: float = 1.0, out_scale: float = 1.0,
                               lo=None, hi=None, dilation: int = 1,
                               groups: int = 1):
    """Plain PyTorch version of the kernel: a float64 convolution of the
    int8 grids (exact) or an f32 convolution of float inputs, then the same
    epilogue in the same order.  A grouped conv's weight (``groups`` > 1)
    is read as the kernel reads it, in its compact layout (KH, KW, S, Co):
    one conv per super-group, output channels nt * BN .. + BN - 1 from
    input channels nt * S .. + S - 1 (``F.conv2d(groups=C/S)``), so the
    zeros of the layout take part as they do on the card."""
    out_dtype = _default_out_dtype(x, out_dtype)
    ct = torch.float64 if x.dtype == torch.int8 else torch.float32
    xc = x.to(ct).permute(0, 3, 1, 2)
    wc = w.to(x.dtype).to(ct).permute(3, 2, 0, 1)
    acc = F.conv2d(xc, wc, stride=stride_pair(stride), padding=(pad_h, pad_w),
                   dilation=dilation,
                   groups=x.shape[3] // w.shape[2] if groups > 1 else 1)
    acc = acc.permute(0, 2, 3, 1).float()
    return epilogue_plain(acc, w_scale, x_scale, bias, activation, lo, hi,
                          out_dtype, out_scale)


def conv2d_implicit_gemm(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         w_scale: Optional[torch.Tensor] = None,
                         stride=1, pad_h: int = 0, pad_w: int = 0,
                         activation: Optional[str] = None,
                         out_dtype: Optional[torch.dtype] = None,
                         x_scale: float = 1.0, out_scale: float = 1.0,
                         lo: Optional[torch.Tensor] = None,
                         hi: Optional[torch.Tensor] = None,
                         dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC conv.  x: (N, H, W, C) float32/bfloat16/int8; w: (KH, KW, C, Co)
    same type or int8, on the GPU stored as ``gemm_layout`` gives it; bias,
    w_scale, lo, hi: (Co,) float32; ``stride``: an int, or an (sh, sw)
    pair; ``dilation``: the taps ``dilation`` pixels apart in both
    directions (tap (kh, kw) reads x[oh*sh - pad_h + kh*d, ow*sw - pad_w +
    kw*d]).  ``groups`` > 1: an int8
    grouped conv, undilated, its weight ``grouped_layout(w, groups, q)``
    (KH, KW, S, Co), S = q * C/groups, at ``supergroup``'s q (the
    super-group route, S = 32) or at q = groups (the block-diagonal
    weight, S = C, where no q fits).  A CPU ``x`` takes the plain version; a CUDA ``x``
    launches the variant ``gemm_plan`` picks, counted in
    ``conv2d_implicit_gemm.variants`` (and a dilated launch in
    ``.dilated_launches``, a super-group one in ``.grouped_launches``), or
    raises."""
    grouped = groups > 1
    sh, sw = stride_pair(stride)
    if (x.dim() != 4 or w.dim() != 4
            or w.shape[2] != (_grouped_width(x.shape[3], w.shape[3], groups,
                                             tuple(w.shape[:2]), (sh, sw))
                              if grouped else x.shape[3])):
        raise ValueError(f"conv shapes {tuple(x.shape)} (NHWC) and "
                         f"{tuple(w.shape)} (HWIO) at groups={groups} do "
                         f"not match")
    if min(sh, sw) < 1 or pad_h < 0 or pad_w < 0 or dilation < 1:
        raise ValueError(f"bad stride/pad/dilation {stride}/{pad_h}/{pad_w}/"
                         f"{dilation}")
    if grouped and (dilation > 1 or x.dtype != torch.int8):
        raise ValueError(f"groups={groups} takes an undilated int8 conv, got "
                         f"{x.dtype} at dilation {dilation}")
    out_dtype = _default_out_dtype(x, out_dtype)
    N, H, W, C = x.shape
    KH, KW, _, Co = w.shape
    OH = (H + 2 * pad_h - dilation * (KH - 1) - 1) // sh + 1
    OW = (W + 2 * pad_w - dilation * (KW - 1) - 1) // sw + 1
    if OH <= 0 or OW <= 0:
        raise ValueError(f"kernel {KH}x{KW} at dilation {dilation} larger "
                         f"than padded input {H}x{W}")
    vecs = {"bias": bias, "w_scale": w_scale, "lo": lo, "hi": hi}
    check_operands(x, w, vecs, Co, out_dtype, activation, lo, hi)
    if x.device.type == "cpu":
        return conv2d_implicit_gemm_plain(x, w, bias, w_scale, stride, pad_h,
                                          pad_w, activation, out_dtype,
                                          x_scale, out_scale, lo, hi,
                                          dilation, groups)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty((N, OH, OW, Co), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptrs, codes, stream = launch_args(x, w, out, vecs, activation, out_dtype)
    S = w.shape[2]
    plan = plan_for(N * OH * OW, KH * KW * S, Co, x, w, out_dtype, conv_c=C,
                    conv_out=(N, OH, OW), stride=(sh, sw), group=groups)
    ws = split_workspace(plan, N * OH * OW, Co, x.dtype, x.device)
    from .build import load_library
    lib = load_library()
    geometry = (N, H, W, C, KH, KW, Co, sh, sw, pad_h, pad_w)
    tail = (*codes, float(x_scale), float(out_scale), *plan.args(),
            None if ws is None else ws.data_ptr(), stream)
    # the super-group route where supergroup gives a q (else the
    # block-diagonal weight on the plain entry)
    route = grouped and supergroup(C, Co, groups, (KH, KW), (sh, sw))[0] > 0
    if route:
        rc = lib.fcnn_conv_implicit_gemm_grouped(*ptrs, *geometry, S, *tail)
    elif dilation == 1:
        rc = lib.fcnn_conv_implicit_gemm(*ptrs, *geometry, *tail)
    else:
        rc = lib.fcnn_conv_implicit_gemm_dilated(*ptrs, *geometry, dilation,
                                                 *tail)
    if rc != 0:
        raise RuntimeError(
            f"conv2d_implicit_gemm launch failed: CUDA error {rc} "
            f"(x={tuple(x.shape)} w={tuple(w.shape)} stride={stride} "
            f"dilation={dilation} groups={groups} {plan})")
    conv2d_implicit_gemm.launches += 1
    conv2d_implicit_gemm.variants[plan.variant] += 1
    if dilation > 1:
        conv2d_implicit_gemm.dilated_launches += 1
    if route:
        conv2d_implicit_gemm.grouped_launches += 1
    return out


conv2d_implicit_gemm.launches = 0
conv2d_implicit_gemm.variants = dict.fromkeys(VARIANTS, 0)
conv2d_implicit_gemm.dilated_launches = 0   # those of them at dilation > 1
conv2d_implicit_gemm.grouped_launches = 0   # those on the super-group route
