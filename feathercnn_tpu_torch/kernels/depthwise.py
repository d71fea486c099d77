"""Depthwise convolution: a per-channel KH x KW conv (channel multiplier 1)
on NHWC tensors, the MobileNet path.  Two wrappers over the two variants of
the hand-written kernel in ``csrc/depthwise_conv.cu`` (whose header note
says what bounds it on an H100 and what its design does about that):

- :func:`depthwise_conv2d`, the counterpart of the Pallas kernel
  ``feathercnn_tpu/kernels/depthwise.py`` (``depthwise_conv2d``, :65): f32
  accumulation tap by tap, + bias, ReLU/ReLU6, stored in the compute type.
- :func:`depthwise_conv2d_int8`, the counterpart of XLA's int8 depthwise
  conv in the reference's "xla" branch (``feathercnn_tpu/kernels/
  dispatch.py:221-253``): exact int32 accumulation and the GEMM kernels'
  epilogue, int8 or float out.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the same function with its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .matmul import (_ACT_CODES, _DTYPE_CODES, check_contiguous,
                     check_epilogue, epilogue_plain, fma_f32)

__all__ = ["depthwise_conv2d", "depthwise_conv2d_plain",
           "depthwise_conv2d_int8", "depthwise_conv2d_int8_plain"]

_FLOAT = (torch.float32, torch.bfloat16)


def _taps(x, kh_, kw_, stride, pad_h, pad_w, oh, ow):
    """(kh, kw, window) in the kernel's order, kh outer and kw inner: the
    zero-padded input seen by tap (kh, kw) of every output pixel."""
    xp = F.pad(x, (0, 0, pad_w, pad_w, pad_h, pad_h))
    for kh in range(kh_):
        for kw in range(kw_):
            yield kh, kw, xp[:, kh:kh + (oh - 1) * stride + 1:stride,
                             kw:kw + (ow - 1) * stride + 1:stride, :]


def _geometry(x, w, stride, pad_h, pad_w):
    """(w as (KH, KW, C), OH, OW), raising on shapes the kernel does not
    take.  w may also be HWIO-style (KH, KW, 1, C)."""
    if w.dim() == 4 and w.shape[2] == 1:
        w = w.reshape(w.shape[0], w.shape[1], w.shape[3])
    if x.dim() != 4 or w.dim() != 3 or x.shape[3] != w.shape[2]:
        raise ValueError(f"depthwise shapes {tuple(x.shape)} (NHWC) and "
                         f"{tuple(w.shape)} (KH, KW, C) do not match")
    if stride < 1 or pad_h < 0 or pad_w < 0:
        raise ValueError(f"bad stride/pad {stride}/{pad_h}/{pad_w}")
    _, h, wd, _ = x.shape
    kh, kw, _ = w.shape
    oh = (h + 2 * pad_h - kh) // stride + 1
    ow = (wd + 2 * pad_w - kw) // stride + 1
    if h + 2 * pad_h < kh or wd + 2 * pad_w < kw:
        raise ValueError(f"kernel {kh}x{kw} larger than padded input "
                         f"{h}x{wd}")
    return w, oh, ow


def _ptr(t):
    return None if t is None else t.data_ptr()


# ----------------------------------------------------------------------
# the float variant
# ----------------------------------------------------------------------

def _float_out_dtype(x, out_dtype):
    if x.dtype == torch.int8:
        out_dtype = torch.bfloat16 if out_dtype is None else out_dtype
        if out_dtype not in _FLOAT:
            raise TypeError(f"int8 x dequantizes to float32 or bfloat16, "
                            f"not {out_dtype}")
        return out_dtype
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"a {x.dtype} x gives a {x.dtype} output, not "
                        f"{out_dtype}")
    return x.dtype


def depthwise_conv2d_plain(x, w, bias=None, stride: int = 1, pad_h: int = 0,
                           pad_w: int = 0, activation=None, x_scale=None,
                           out_dtype=None):
    """Plain PyTorch version of the float variant, in the kernel's order:
    int8 x dequantized to ``out_dtype``, then one f32 FMA per tap (kh
    outer, kw inner, from 0), + bias, activation, stored in the output
    type."""
    w, oh, ow = _geometry(x, w, stride, pad_h, pad_w)
    out_dtype = _float_out_dtype(x, out_dtype)
    if x.dtype == torch.int8:
        scale = torch.tensor(x_scale, dtype=torch.float32, device=x.device)
        xf = (x.float() * scale).to(out_dtype).float()
    else:
        xf = x.float()
    acc = torch.zeros(x.shape[0], oh, ow, x.shape[3], device=x.device)
    for kh, kw, xs in _taps(xf, w.shape[0], w.shape[1], stride, pad_h,
                            pad_w, oh, ow):
        acc = fma_f32(xs, w[kh, kw].float(), acc)
    return epilogue_plain(acc, bias=bias, activation=activation,
                          out_dtype=out_dtype)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 1,
                     pad_h: int = 0, pad_w: int = 0,
                     activation: Optional[str] = None,
                     x_scale: Optional[float] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[n, oh, ow, c] = act(sum over kh, kw of x[n, oh*s - pad_h + kh,
    ow*s - pad_w + kw, c] * w[kh, kw, c] + bias[c])``, zero padding, f32
    accumulation with one FMA per tap.

    x: (N, H, W, C) float32 or bfloat16, stored out in its own type; or int8
    with ``x_scale``, which the kernel dequantizes as it loads each element
    to ``out_dtype`` (bfloat16 unless given, or float32):
    ``out_dtype(float(q) * x_scale)``, bit for bit the separate dequantize
    of the reference's dispatcher, without a pass over the edge.  w: (KH,
    KW, C) or (KH, KW, 1, C) float32; bias: (C,) float32.  A CPU ``x``
    takes the plain version; a CUDA ``x`` launches the kernel or raises."""
    if x.dtype not in _FLOAT + (torch.int8,):
        raise TypeError(f"x must be float32, bfloat16 or int8, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if (x.dtype == torch.int8) != (x_scale is not None):
        raise ValueError("x_scale goes with an int8 x, and only with it")
    w, oh, ow = _geometry(x, w, stride, pad_h, pad_w)
    out_dtype = _float_out_dtype(x, out_dtype)
    check_epilogue(x, w, {"bias": bias}, x.shape[3], activation)
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w, bias, stride, pad_h, pad_w,
                                      activation, x_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_contiguous({"x": x, "w": w, "bias": bias})
    n, h, wd, c = x.shape
    out = torch.empty((n, oh, ow, c), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    from .build import load_library
    rc = load_library().fcnn_depthwise_conv2d(
        _ptr(x), _ptr(w), _ptr(out), _ptr(bias), n, h, wd, c, w.shape[0],
        w.shape[1], stride, stride, pad_h, pad_w, _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[out_dtype], _ACT_CODES[activation],
        float(x_scale if x_scale is not None else 1.0),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"depthwise_conv2d launch failed: CUDA error {rc} "
                           f"(x={tuple(x.shape)} {x.dtype} "
                           f"w={tuple(w.shape)} stride={stride})")
    depthwise_conv2d.launches += 1
    return out


depthwise_conv2d.launches = 0


# ----------------------------------------------------------------------
# the int8 variant
# ----------------------------------------------------------------------

def depthwise_conv2d_int8_plain(xq, wq, bias=None, w_scale=None,
                                stride: int = 1, pad_h: int = 0,
                                pad_w: int = 0, activation=None,
                                out_dtype=torch.int8,
                                out_scale: float = 1.0):
    """Plain PyTorch version of the int8 variant: the taps summed in float64
    (exact: |acc| <= 127^2 * KH * KW is far inside its 53 bits), then the
    GEMM kernels' epilogue (:func:`epilogue_plain`)."""
    wq, oh, ow = _geometry(xq, wq, stride, pad_h, pad_w)
    acc = torch.zeros(xq.shape[0], oh, ow, xq.shape[3], dtype=torch.float64,
                      device=xq.device)
    for kh, kw, xs in _taps(xq.double(), wq.shape[0], wq.shape[1], stride,
                            pad_h, pad_w, oh, ow):
        acc += xs * wq[kh, kw].double()
    return epilogue_plain(acc.float(), w_scale, 1.0, bias, activation,
                          out_dtype=out_dtype, out_scale=out_scale)


def depthwise_conv2d_int8(xq: torch.Tensor, wq: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          w_scale: torch.Tensor, stride: int = 1,
                          pad_h: int = 0, pad_w: int = 0,
                          activation: Optional[str] = None,
                          out_dtype: torch.dtype = torch.int8,
                          out_scale: float = 1.0) -> torch.Tensor:
    """``y = act(acc * w_scale[c] + bias[c])`` with ``acc`` the exact int32
    depthwise conv of the int8 grids; int8 out is
    ``clip(round_half_even(y * out_scale), -127, 127)``.

    xq: (N, H, W, C) int8; wq: (KH, KW, C) or (KH, KW, 1, C) int8; bias and
    w_scale (the folded ``w_scale * x_scale``): (C,) float32.  A CPU ``xq``
    takes the plain version; a CUDA ``xq`` launches the kernel or raises."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype} and "
                        f"{wq.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32, bfloat16 or int8, "
                        f"got {out_dtype}")
    if w_scale is None:
        raise ValueError("the int8 variant needs w_scale")
    wq, oh, ow = _geometry(xq, wq, stride, pad_h, pad_w)
    check_epilogue(xq, wq, {"bias": bias, "w_scale": w_scale}, xq.shape[3],
                   activation)
    if xq.device.type == "cpu":
        return depthwise_conv2d_int8_plain(xq, wq, bias, w_scale, stride,
                                           pad_h, pad_w, activation,
                                           out_dtype, out_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    check_contiguous({"xq": xq, "wq": wq, "bias": bias, "w_scale": w_scale})
    n, h, wd, c = xq.shape
    out = torch.empty((n, oh, ow, c), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    from .build import load_library
    rc = load_library().fcnn_depthwise_conv2d_int8(
        _ptr(xq), _ptr(wq), _ptr(out), _ptr(bias), _ptr(w_scale), n, h, wd,
        c, wq.shape[0], wq.shape[1], stride, stride, pad_h, pad_w,
        _DTYPE_CODES[out_dtype], _ACT_CODES[activation], float(out_scale),
        torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"depthwise_conv2d_int8 launch failed: CUDA error "
                           f"{rc} (x={tuple(xq.shape)} w={tuple(wq.shape)} "
                           f"stride={stride})")
    depthwise_conv2d_int8.launches += 1
    return out


depthwise_conv2d_int8.launches = 0
