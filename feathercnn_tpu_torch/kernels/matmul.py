"""``matmul_epilogue``: GEMM with a fused epilogue — the engine's GEMM.

Counterpart of ``feathercnn_tpu/kernels/matmul.py`` (the Pallas kernel
``matmul_epilogue``, :96).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/matmul_epilogue.cu`` (whose header note says
what bounds it on an H100 and what its design does about that); on a CPU
tensor it computes the same function with :func:`matmul_epilogue_plain`.

Variants (one kernel, chosen by the operand types):
  f32 x f32, bf16 x bf16            -> float out        (float paths)
  f32/bf16 x int8 (+ w_scale)       -> float out        (weight-only int8)
  int8 x int8 (+ both scales)       -> float or int8    (full int8, int32 acc)
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["matmul_epilogue", "matmul_epilogue_plain", "epilogue_plain",
           "fma_f32"]

_ACT_CODES = {None: 0, "relu": 1, "relu6": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def epilogue_plain(acc: torch.Tensor, w_scale=None, x_scale: float = 1.0,
                   bias=None, activation: Optional[str] = None,
                   lo=None, hi=None, out_dtype=torch.float32,
                   out_scale: float = 1.0) -> torch.Tensor:
    """The kernels' epilogue on an f32 accumulator (last axis = output
    channel), step for step: ``acc * w_scale * x_scale + bias`` with the
    last multiply and the bias add rounding once (as the reference's
    compiled epilogue contracts them), activation, lo/hi clamp, then the
    store (int8: round half to even of ``y * out_scale``, saturated)."""
    y = acc
    last = None
    if w_scale is not None:
        last = w_scale
    if x_scale != 1.0:
        if last is not None:
            y = y * last
        last = torch.tensor(x_scale, dtype=torch.float32, device=acc.device)
    if bias is not None:
        y = fma_f32(y, last, bias) if last is not None else y + bias
    elif last is not None:
        y = y * last
    if activation == "relu":
        y = torch.clamp_min(y, 0.0)
    elif activation == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    if lo is not None:
        y = torch.minimum(torch.maximum(y, lo), hi)
    if out_dtype == torch.int8:
        q = torch.round(y * torch.tensor(out_scale, dtype=torch.float32,
                                         device=y.device))
        return torch.clamp(q, -127, 127).to(torch.int8)
    return y.to(out_dtype)


def matmul_epilogue_plain(x, w, bias=None, w_scale=None, activation=None,
                          out_dtype=None, x_scale: float = 1.0,
                          out_scale: float = 1.0, lo=None, hi=None):
    """Plain PyTorch version of the kernel.  int8 x int8 accumulates
    exactly (a float64 product of the int8 grids: |acc| <= 127^2 * K is far
    inside f64's 53 bits); float inputs accumulate in f32 (bf16 products
    are exact in f32)."""
    out_dtype = _default_out_dtype(x, out_dtype)
    if x.dtype == torch.int8:
        acc = (x.double() @ w.double()).float()
    else:
        acc = x.float() @ w.to(x.dtype).float()
    return epilogue_plain(acc, w_scale, x_scale, bias, activation, lo, hi,
                          out_dtype, out_scale)


def _default_out_dtype(x, out_dtype):
    if out_dtype is not None:
        return out_dtype
    return x.dtype if x.dtype != torch.int8 else torch.bfloat16


def check_operands(x, w, vecs, n: int, out_dtype, activation, lo, hi):
    """Raise on anything the kernels do not take: operand types, the
    epilogue vectors' type/length/device, a lone lo or hi, an unknown
    activation or output type."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32, bfloat16 or int8, got {x.dtype}")
    if w.dtype not in (x.dtype, torch.int8):
        raise TypeError(f"w must be {x.dtype} or int8, got {w.dtype}")
    if x.dtype == torch.int8 and w.dtype != torch.int8:
        raise TypeError("int8 x needs int8 w")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32, bfloat16 or int8, "
                        f"got {out_dtype}")
    if (lo is None) != (hi is None):
        raise ValueError("lo and hi go together")
    check_epilogue(x, w, vecs, n, activation)


def check_epilogue(x, w, vecs, n: int, activation):
    """Raise on an unknown activation, on an epilogue vector that is not
    float32 of shape (n,), or on a vector or ``w`` on another device than
    ``x``."""
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    for name, v in vecs.items():
        if v is None:
            continue
        if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != n:
            raise ValueError(f"{name} must be float32 of shape ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")


def check_contiguous(tensors):
    """Raise unless every tensor of the name -> tensor (or None) mapping
    is contiguous: the kernels compute offsets from the shapes alone."""
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_args(x, w, out, vecs, activation, out_dtype):
    """The pointer/type arguments shared by both kernels' C interfaces.
    Raises unless every tensor is contiguous on one CUDA device."""
    check_contiguous({"x": x, "w": w, **vecs})
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return ([ptr(x), ptr(w), ptr(out), ptr(vecs["bias"]),
             ptr(vecs["w_scale"]), ptr(vecs["lo"]), ptr(vecs["hi"])],
            [_DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
             _DTYPE_CODES[out_dtype], _ACT_CODES[activation]],
            stream)


def matmul_epilogue(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    w_scale: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    x_scale: float = 1.0, out_scale: float = 1.0,
                    lo: Optional[torch.Tensor] = None,
                    hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = clamp(act((x @ w) * w_scale * x_scale + bias), lo, hi)``
    ``[* out_scale -> int8]``.

    x: (M, K) float32/bfloat16/int8;  w: (K, N) same type or int8;
    bias, w_scale, lo, hi: (N,) float32.  Ragged M/N/K are masked in the
    kernel.  A CPU ``x`` takes the plain version; a CUDA ``x`` launches the
    kernel or raises."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(w.shape)} "
                         "do not form a GEMM")
    out_dtype = _default_out_dtype(x, out_dtype)
    M, K = x.shape
    N = w.shape[1]
    vecs = {"bias": bias, "w_scale": w_scale, "lo": lo, "hi": hi}
    check_operands(x, w, vecs, N, out_dtype, activation, lo, hi)
    if x.device.type == "cpu":
        return matmul_epilogue_plain(x, w, bias, w_scale, activation,
                                     out_dtype, x_scale, out_scale, lo, hi)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    ptrs, codes, stream = launch_args(x, w, out, vecs, activation, out_dtype)
    from .build import load_library
    rc = load_library().fcnn_matmul_epilogue(
        *ptrs, M, K, N, *codes, float(x_scale), float(out_scale), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_epilogue launch failed: CUDA error {rc} "
                           f"(M={M} K={K} N={N} x={x.dtype} w={w.dtype})")
    matmul_epilogue.launches += 1
    return out


matmul_epilogue.launches = 0
