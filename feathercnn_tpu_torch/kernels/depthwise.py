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

On a CUDA tensor each wrapper launches its kernel with the plan that
:func:`dw_plan` makes on the host (counted per variant in the wrapper's
``variants``), or raises; on a CPU tensor it computes the same function
with its plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..numerics import dequantize, fma_f32
from .matmul import (_ACT_CODES, _DTYPE_CODES, SMEM_LIMIT,
                     check_contiguous, check_epilogue, epilogue_plain)

__all__ = ["depthwise_conv2d", "depthwise_conv2d_plain",
           "depthwise_conv2d_int8", "depthwise_conv2d_int8_plain",
           "dw_plan", "DwPlan", "DW_VARIANTS"]

_FLOAT = (torch.float32, torch.bfloat16)

# The kernel's variants, in the order of their codes in the C interface:
# "tiled" (any kernel size and stride, one output per thread), "k3s1" (3x3,
# stride 1, 8 outputs per thread), "k3s2" (3x3, stride 2, 4 per thread).
DW_VARIANTS = ("tiled", "k3s1", "k3s2")
_RW = {"tiled": 1, "k3s1": 8, "k3s2": 4}
DW_V = 4                  # channels per thread
DW_MAX_THREADS = 256       # the kernel's launch bound (64 registers)
# The int8 variant sums in f32, exactly while KH*KW*127^2 < 2^24.
DW_INT_MAX_TAPS = 1040
# Per variant, the tiles of a thread block: at most CS channels, LANES
# threads along an output row (CS / 4 channel quads, then groups of RW
# outputs) and TH output rows.  Of two, the plan takes the one whose tiles
# cover the output with fewer outputs past its edge, the first on a tie.
_TILE = {"k3s1": ((64, 16, 16),), "k3s2": ((64, 32, 8), (64, 16, 16)),
         "tiled": ((64, 16, 16),)}
# The pad after a staged pixel's channels: a warp's 8-byte reads of
# neighbouring rows then start 16 bytes apart in the banks.
_PAD = 16


class DwPlan(NamedTuple):
    """One depthwise launch's plan: the variant; a thread block's TH x TW
    tile of output pixels and CS channels; the byte pitch of a staged pixel
    (CS channels of the staged type plus a pad that spreads a warp's reads
    over the banks); threads per block; dynamic shared memory (the window,
    then the weights as f32); and the grid (tiles, channel slices)."""
    variant: str
    th: int
    tw: int
    cs: int
    pitch: int
    threads: int
    smem: int
    grid: tuple

    def args(self):
        """The plan's integers as the C entry points take them."""
        return (DW_VARIANTS.index(self.variant), self.th, self.tw, self.cs,
                self.pitch, self.threads, self.smem)


def _tile_plan(variant, cs_max, lanes, th_max, n, oh, ow, c, kh, kw, stride,
               x_itemsize, staged_itemsize) -> DwPlan:
    """The plan of a tile of at most ``cs_max`` channels, ``lanes``
    threads along a row and ``th_max`` rows, cut to the output and to
    shared memory.  C, the output's rows and its columns are each cut into
    even parts (channels rounded up to whole 16-byte chunks), so that no
    tile is mostly past the edge."""
    rw = _RW[variant]
    ch = 16 // x_itemsize                     # channels per staged chunk
    per = -(-c // -(-c // cs_max))            # C in even slices
    cs = -(-per // ch) * ch
    cv = cs // DW_V
    groups = -(-ow // rw)                     # RW-wide output groups a row
    px = max(1, min(lanes // cv, groups))
    px = -(-groups // -(-groups // px))       # the row in even tiles
    tw = rw * px
    pitch = cs * staged_itemsize + _PAD
    rows = min(th_max, DW_MAX_THREADS // (cv * px))
    for top in range(rows, 0, -1):
        th = -(-oh // -(-oh // top))          # the column in even tiles
        smem = (((th - 1) * stride + kh) * ((tw - 1) * stride + kw) * pitch
                + 4 * kh * kw * cs)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"depthwise: no tile of {kh}x{kw} stride {stride} "
                         f"with C={c} fits {SMEM_LIMIT} bytes of shared "
                         f"memory")
    grid = (n * -(-oh // th) * -(-ow // tw), -(-c // cs))
    if grid[0] > 0x7fffffff or grid[1] > 65535:
        raise ValueError(f"depthwise: grid {grid} exceeds the limits")
    return DwPlan(variant, th, tw, cs, pitch, cv * px * th, smem, grid)


@functools.lru_cache(maxsize=None)
def dw_plan(n: int, h: int, w: int, c: int, kh: int, kw: int, stride: int,
            pad_h: int, pad_w: int, x_itemsize: int, staged_itemsize: int,
            int_variant: bool = False) -> DwPlan:
    """The plan of one depthwise launch, made on the host from the shapes
    and the item sizes of x and of the staged type (int8 for the int8
    variant, the output's type for the float variant's int8 x, else x's
    type).  Raises ``ValueError`` for a shape no plan fits.

    The variant follows from the kernel size and stride, the tile from the
    variant (``_TILE``): up to 64 channels and 256 threads, as 16 threads
    along an output row by 16 rows ("k3s1", "tiled"); for "k3s2" 32 by 8,
    or 16 by 16 where that leaves fewer outputs past the edge (a 28-wide
    output); fewer where the output has fewer or the window would not fit
    shared memory.  ``chip_smoke.py`` times these tiles against others on
    the card."""
    oh = (h + 2 * pad_h - kh) // stride + 1
    ow = (w + 2 * pad_w - kw) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"kernel {kh}x{kw} larger than padded input {h}x{w}")
    if int_variant and kh * kw > DW_INT_MAX_TAPS:
        raise ValueError(f"int8 depthwise: {kh}x{kw} taps exceed the "
                         f"{DW_INT_MAX_TAPS} whose f32 sum stays exact")
    variant = ("k3s1" if (kh, kw, stride) == (3, 3, 1) else
               "k3s2" if (kh, kw, stride) == (3, 3, 2) else "tiled")
    plans = [_tile_plan(variant, *t, n, oh, ow, c, kh, kw, stride,
                        x_itemsize, staged_itemsize) for t in _TILE[variant]]
    return min(plans, key=lambda p: -(-oh // p.th) * p.th
               * -(-ow // p.tw) * p.tw)


def _plan_for(x, kh, kw, stride, pad_h, pad_w, staged, int_variant):
    n, h, w, c = x.shape
    return dw_plan(n, h, w, c, kh, kw, stride, pad_h, pad_w,
                   x.element_size(), torch.empty((), dtype=staged)
                   .element_size(), int_variant)


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
        xf = dequantize(x, x_scale).to(out_dtype).float()
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
    staged = out_dtype if x.dtype == torch.int8 else x.dtype
    plan = _plan_for(x, w.shape[0], w.shape[1], stride, pad_h, pad_w, staged,
                     False)
    from .build import load_library
    rc = load_library().fcnn_depthwise_conv2d(
        _ptr(x), _ptr(w), _ptr(out), _ptr(bias), n, h, wd, c, w.shape[0],
        w.shape[1], stride, stride, pad_h, pad_w, _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[out_dtype], _ACT_CODES[activation],
        float(x_scale if x_scale is not None else 1.0), *plan.args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"depthwise_conv2d launch failed: CUDA error {rc} "
                           f"(x={tuple(x.shape)} {x.dtype} "
                           f"w={tuple(w.shape)} stride={stride} {plan})")
    depthwise_conv2d.launches += 1
    depthwise_conv2d.variants[plan.variant] += 1
    return out


depthwise_conv2d.launches = 0
depthwise_conv2d.variants = dict.fromkeys(DW_VARIANTS, 0)


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
    plan = _plan_for(xq, wq.shape[0], wq.shape[1], stride, pad_h, pad_w,
                     torch.int8, True)
    from .build import load_library
    rc = load_library().fcnn_depthwise_conv2d_int8(
        _ptr(xq), _ptr(wq), _ptr(out), _ptr(bias), _ptr(w_scale), n, h, wd,
        c, wq.shape[0], wq.shape[1], stride, stride, pad_h, pad_w,
        _DTYPE_CODES[out_dtype], _ACT_CODES[activation], float(out_scale),
        *plan.args(), torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"depthwise_conv2d_int8 launch failed: CUDA error "
                           f"{rc} (x={tuple(xq.shape)} w={tuple(wq.shape)} "
                           f"stride={stride} {plan})")
    depthwise_conv2d_int8.launches += 1
    depthwise_conv2d_int8.variants[plan.variant] += 1
    return out


depthwise_conv2d_int8.launches = 0
depthwise_conv2d_int8.variants = dict.fromkeys(DW_VARIANTS, 0)
