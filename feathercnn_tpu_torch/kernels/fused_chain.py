"""``fused_chain``: ``nb`` identity bottlenecks in a row, the ResNet stage
under ``fuse_chains``.

Counterpart of the Pallas kernel ``feathercnn_tpu/kernels/fused_chain.py``
(``fused_chain``, :264).  On a CUDA tensor each mode launches its
hand-written kernel once per block: the int8 mode ``csrc/fused_chain.cu``,
the float mode (bf16 or f32) ``csrc/fused_chain_float.cu`` (their header
notes say what bounds them on an H100 and what their designs do about
that).  On a CPU tensor both modes compute the same function with
:func:`fused_chain_plain`.  The float mode's launches are counted apart,
on :func:`fused_chain_float`, which the float lowering calls.

Block j of the int8 mode, over NHWC int8 ``x`` with per-tensor activation
scales ``sx``, ``sy1``, ``sy2`` and per-channel weight scales::

    y1  = q8(relu(acc(x·w1) * f32(w1s·sx) + b1) * f32(1/sy1))
    y2  = q8(relu(acc(conv3x3(y1, pad 1)) * f32(w2s·sy1) + b2) * f32(1/sy2))
    out = relu(acc(y2·w3) * f32(w3s·sy2) + b3 + f32(x)·sx) -> q8(· * r)

with ``r = f32(1/sx[j+1])``, or ``f32(1/s_out)`` on the last block, whose
output is bf16 instead where ``s_out`` is None.  ``q8`` rounds half to
even and clips to +-127; every reciprocal is a double rounded once to f32.
Each ``* s + b`` rounds once (an FMA), as the reference's compiled kernel
contracts it.  The shortcut's ``+ f32(x)·sx`` is a second FMA on the
chain's first block; on a later block it is a rounded product and an add,
because there the reference's compiled code recomputes the previous
block's requant inside the add and the clamp it emits keeps the product
apart.  Conv2's sum is one exact int32 sum where ``Cm <= 128``; above, the
reference sums nine per-tap int32 dots in f32 (kh outer, kw inner), and so
do both versions here.

Block j of the float mode, over NHWC ``x`` of type T (bf16 or f32) with
weights of type T and f32 biases, every sum in f32::

    y1  = T(relu(x·w1 + b1))
    y2  = T(relu(conv3x3(y1, pad 1) + b2))
    out = relu((y2·w3 + b3) + f32(x)) -> T, or out_dtype on the last block
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..numerics import fma_f32, requantize
from .matmul import _DTYPE_CODES, H100_SMS, check_contiguous

__all__ = ["fused_chain", "fused_chain_float", "fused_chain_plain",
           "kernel_layout", "tile_plan", "chain_plan", "ChainPlan",
           "FLOAT_VARIANTS", "INT8_VARIANTS"]

_FLOAT = (torch.float32, torch.bfloat16)


def _f32(v) -> float:
    """``v`` rounded once to f32, as a Python float."""
    return float(torch.tensor(float(v), dtype=torch.float32))


def _scale_args(nb, scales):
    """(sx, sy1, sy2, r, out_int8) of the int8 mode: ``r[j] = 1/sx[j+1]``
    in double, and ``1/s_out`` (or 1.0: bf16 out) on the last block."""
    sx, sy1, sy2, s_out = scales
    if not (len(sx) == len(sy1) == len(sy2) == nb):
        raise ValueError(f"scales need {nb} entries each, got "
                         f"{len(sx)}/{len(sy1)}/{len(sy2)}")
    out_int8 = s_out is not None
    r = [1.0 / sx[j + 1] for j in range(nb - 1)]
    r.append(1.0 / s_out if out_int8 else 1.0)
    return ([float(v) for v in sx], [float(v) for v in sy1],
            [float(v) for v in sy2], r, out_int8)


def _exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in float64 and rounded once to f32.  Exact for two
    int8 grids (|acc| <= 127^2 * K is far inside 53 bits); for bf16 or f32
    operands the products are exact and the sum carries 53 bits."""
    return (a.double() @ b.double()).float()


def _taps(y: torch.Tensor):
    """The nine 3x3 windows of the zero-padded NHWC ``y`` as (M, Cm)
    matrices, kh outer and kw inner."""
    n, h, w, c = y.shape
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    for kh in range(3):
        for kw in range(3):
            yield yp[:, kh:kh + h, kw:kw + w, :].reshape(-1, c)


def fused_chain_plain(x, w1, b1, w2, b2, w3, b3, w_scales=None,
                      scales: Optional[Sequence] = None, out_dtype=None):
    """Plain PyTorch version of both modes.  The int8 mode rounds step for
    step as the reference kernel: int8 sums exact in float64, the FMAs of
    the module note emulated exactly (``fma_f32``).  The float mode takes
    each sum in float64 (the products of bf16 or f32 values are exact
    there) and rounds it once to f32: the f32 sum that every order of f32
    adds approximates, the reference's and the kernel's included."""
    n, h, w, c = x.shape
    nb, _, cm = w1.shape
    int8 = x.dtype == torch.int8
    out_dtype = _out_dtype(x, out_dtype, scales)
    if int8:
        sx, sy1, sy2, r, out_int8 = _scale_args(nb, scales)
    act = x
    for j in range(nb):
        last = j == nb - 1
        xm = act.reshape(-1, c)
        if int8:
            w1s, w2s, w3s = (s[j] for s in w_scales)
            s1 = w1s * torch.tensor(_f32(sx[j]), device=x.device)
            y1 = torch.clamp_min(fma_f32(_exact_mm(xm, w1[j]), s1, b1[j]), 0)
            y1 = requantize(y1, 1.0 / sy1[j]).reshape(n, h, w, cm)
            if cm <= 128:
                a2 = _exact_mm(torch.cat(list(_taps(y1)), dim=1), w2[j])
            else:
                a2 = torch.zeros(n * h * w, cm, device=x.device)
                for t, ys in enumerate(_taps(y1)):
                    a2 = a2 + _exact_mm(ys, w2[j, t * cm:(t + 1) * cm])
            s2 = w2s * torch.tensor(_f32(sy1[j]), device=x.device)
            y2 = requantize(torch.clamp_min(fma_f32(a2, s2, b2[j]), 0),
                            1.0 / sy2[j])
            s3 = w3s * torch.tensor(_f32(sy2[j]), device=x.device)
            t3 = fma_f32(_exact_mm(y2, w3[j]), s3, b3[j])
            if j == 0:
                out = fma_f32(xm.float(), _f32(sx[j]), t3)
            else:
                out = t3 + xm.float() * torch.tensor(_f32(sx[j]),
                                                     device=x.device)
            out = torch.clamp_min(out, 0)
            if not last or out_int8:
                act = requantize(out, r[j])
            else:
                act = out.to(out_dtype)
        else:
            dt = x.dtype
            y1 = torch.clamp_min(_exact_mm(xm, w1[j]) + b1[j], 0)
            y1 = y1.to(dt).reshape(n, h, w, cm)
            a2 = _exact_mm(torch.cat(list(_taps(y1)), dim=1), w2[j])
            y2 = torch.clamp_min(a2 + b2[j], 0).to(dt)
            out = torch.clamp_min(_exact_mm(y2, w3[j]) + b3[j] + xm.float(),
                                  0)
            act = out.to(out_dtype if last else dt)
        act = act.reshape(n, h, w, c)
    return act


def _out_dtype(x, out_dtype, scales):
    if x.dtype == torch.int8:
        if scales is not None and scales[3] is not None:
            return torch.int8
        return torch.bfloat16 if out_dtype is None else out_dtype
    return x.dtype if out_dtype is None else out_dtype


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """``w`` (nb, K, N) with the same values, stored as the CUDA kernel
    reads a weight: (nb, N, K) with K contiguous, so that a 16-byte copy
    lands where the mma's B fragment reads it.  ``dispatch.chain_forward``
    makes it once per node; on a CUDA tensor the wrapper takes no other
    layout."""
    return w.transpose(1, 2).contiguous().transpose(1, 2)


# Shared memory a CUDA kernel's thread block can use on an H100, and what
# the two kernels' layouts take besides y1 and y2: the 3-stage ring of A
# and B tiles (128 rows of 80 bytes each) and the row indices.
_SMEM_LIMIT = 227 * 1024
_SMEM_FIXED = 3 * (128 + 128) * 80 + 128 * (8 + 4) + 64 * 4


def smem_bytes(th: int, tw: int, cm: int, itemsize: int) -> int:
    """Shared memory of one thread block of either kernel at a TH x TW
    tile: y1 over the (TH + 2) x (TW + 2) halo and y2 over 64 pixels, each
    row ``Cm`` elements padded to a 64-byte K step plus 16 bytes."""
    pitch = -(-cm * itemsize // 64) * 64 + 16
    return ((th + 2) * (tw + 2) + 64) * pitch + _SMEM_FIXED


def tile_plan(h: int, w: int, cm: int, itemsize: int):
    """(TH, TW) of the CUDA kernel's output tile: 8x8 or 7x7, whichever
    makes the fewer conv1 halo pixels over the image ((t + 2)^2 per tile)
    among those whose shared memory fits (:func:`smem_bytes`).  Raises
    ``ValueError`` where neither fits."""
    def cost(t):
        return -(-h // t) * -(-w // t) * (t + 2) ** 2
    fits = [t for t in (8, 7) if smem_bytes(t, t, cm, itemsize) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"fused_chain: no tile of H={h} W={w} Cm={cm} with "
            f"{itemsize}-byte elements fits {_SMEM_LIMIT} bytes of shared "
            f"memory (7x7 needs {smem_bytes(7, 7, cm, itemsize)})")
    t = min(fits, key=lambda t: (cost(t), -t))
    return t, t


# The float kernel's variants, in the order of their codes in the C
# interface: "wgmma" (bf16 x: wgmma with a TMA ring, up to two tiles per
# thread block), "mma_sync" (bf16 x whose C or Cm is not a multiple of 8,
# or a pointer not 16-byte aligned: the mma.sync body) and "fma_f32" (f32
# x: the same body on FMAs).
FLOAT_VARIANTS = ("wgmma", "mma_sync", "fma_f32")
# (products of bf16 x bf16 per rounded f32 add, the add's rounding error
# carried into the next slice) of the "wgmma" variant: 128 uncarried where
# conv2's K = 9 * Cm is at most 2304 (Cm <= 256), else 32 carried
# (ResNet-50's stage 5, where 128-product slices leave launches over the
# float gate).  The library builds these two (csrc/fused_chain_float.cu);
# tools/float_chain_probe.py builds the others and measures them against
# the float gate.
FLOAT_ADD_STEPS = ((128, False), (32, True))
_FW_B_BYTES = 128 * 128          # a ring stage's weight tile
_FW_MAX_STAGES = 4
# The int8 kernel's variants, their codes shared with the float ones:
# "wgmma" (C and Cm multiples of 16, 16-byte aligned pointers: s8 wgmma with
# a TMA ring and a persistent grid) and "mma_sync" (the rest: the first,
# mma.sync body).
INT8_VARIANTS = FLOAT_VARIANTS[:2]
# Tiles below which an int8 launch takes one tile per thread block, its
# columns split between the two consumers, rather than two tiles (one per
# consumer).  Under 2 x 132 tiles pairs leave SMs idle; at ResNet-50's
# stage 4 (512 tiles, b128) the split ran 6-7% faster too, at stage 3
# (2,048 tiles) pairs 25-26% faster (chip_smoke.py times both; PERF.md §6).
_PAIR_MIN_TILES = 8 * H100_SMS
_CW_SPITCH = 64 * 2 + 16         # a staged output row of the int8 kernel


class ChainPlan(NamedTuple):
    """One chain launch's plan (one block): the variant; the TH x TW
    output tile; the tiles a thread block takes at a time ("wgmma": 2, one
    per consumer warpgroup, or 1, whose columns the int8 kernel's two
    consumers split; else 1); the ring's stages; the float kernel's
    products per rounded add and whether its error is carried (0 and False
    for int8); the dynamic shared memory; the grid; and why a launch does
    not take "wgmma" ("" where it does)."""
    variant: str
    th: int
    tw: int
    tiles_per_cta: int
    stages: int
    kadd: int
    carry: bool
    smem: int
    grid: int
    reason: str = ""

    def args(self):
        """The plan's integers as the C entry point takes them."""
        return (FLOAT_VARIANTS.index(self.variant), self.tiles_per_cta,
                self.stages, self.kadd, int(self.carry), self.smem, self.grid)

    def int8_args(self):
        """The int8 kernel's plan integers as its C entry point takes them."""
        return (INT8_VARIANTS.index(self.variant), self.tiles_per_cta,
                self.stages, self.smem, self.grid)


def wgmma_chain_smem(tiles: int, stages: int, th: int, tw: int,
                     cm: int) -> int:
    """Dynamic shared memory of the "wgmma" variant (fw_smem in
    csrc/fused_chain_float.cu, which refuses a plan whose count differs):
    1024 bytes of alignment slack; the ring, each stage the tiles' x halos
    (1024-aligned) and a 128 x 128-byte weight tile; per tile y1 over the
    (TH+2) x (TW+2) halo and y2 over TH x TW pixels, rows of Cm bf16 plus
    16 bytes; two barriers per stage; a 16-byte zero chunk."""
    npos = (th + 2) * (tw + 2)
    ld = cm * 2 + 16
    a_bytes = -(-npos * 128 // 1024) * 1024
    return (1024 + stages * (tiles * a_bytes + _FW_B_BYTES)
            + tiles * (npos + th * tw) * ld + 16 * stages + 16)


def int8_chain_smem(tiles: int, stages: int, th: int, tw: int,
                    cm: int) -> int:
    """Dynamic shared memory of the int8 "wgmma" variant (cw_smem in
    csrc/fused_chain.cu, which refuses a plan whose count differs): 1024
    bytes of alignment slack; the ring, each stage two tiles' x halos
    (1024-aligned, 128 bytes a pixel) and a 128 x 128-byte weight tile
    (``tiles`` 2) or one halo and two weight tiles (1: the consumers split
    the columns); per tile y1 over the halo and y2 over the tile, rows of
    Cm + 16 bytes; each consumer's staged output rows (64 columns of bf16
    or int8 plus 16 bytes); two barriers per stage; a 16-byte zero
    chunk."""
    npos = (th + 2) * (tw + 2)
    a_bytes = -(-npos * 128 // 1024) * 1024
    return (1024 + stages * (tiles * a_bytes + (3 - tiles) * _FW_B_BYTES)
            + tiles * (npos + th * tw) * (cm + 16)
            + 2 * th * tw * _CW_SPITCH + 16 * stages + 16)


def _int8_plan(n, h, w, c, cm, aligned, per_cta):
    def tiles(t):
        return n * -(-h // t) * -(-w // t)

    def cost(t):
        return -(-h // t) * -(-w // t) * (t + 2) ** 2
    reason = ("C or Cm not a multiple of 16" if c % 16 or cm % 16 else
              "" if aligned else "a pointer not 16-byte aligned")
    if reason:
        th, tw = tile_plan(h, w, cm, 1)
        return ChainPlan("mma_sync", th, tw, 1, 3, 0, False,
                         smem_bytes(th, tw, cm, 1), tiles(th), reason)

    def pick(k):
        fits = [t for t in (8, 7)
                if int8_chain_smem(k, 2, t, t, cm) <= _SMEM_LIMIT]
        return min(fits, key=lambda t: (cost(t), -t)) if fits else None
    if per_cta:
        k, t = per_cta, pick(per_cta)
    else:
        t = pick(2)
        k = 2 if t is not None and tiles(t) >= _PAIR_MIN_TILES else 1
        if k == 1:
            t = pick(1)
    if t is None:
        raise ValueError(f"fused_chain: no int8 tile of H={h} W={w} Cm={cm} "
                         f"with {k} tile(s) per block fits {_SMEM_LIMIT} "
                         f"bytes of shared memory")
    stages = max(st for st in range(2, _FW_MAX_STAGES + 1)
                 if int8_chain_smem(k, st, t, t, cm) <= _SMEM_LIMIT)
    return ChainPlan("wgmma", t, t, k, stages, 0, False,
                     int8_chain_smem(k, stages, t, t, cm),
                     min(-(-tiles(t) // k), H100_SMS))


@functools.lru_cache(maxsize=None)
def chain_plan(n: int, h: int, w: int, c: int, cm: int, itemsize: int,
               aligned: bool = True, per_cta: int = 0) -> ChainPlan:
    """The plan of one chain launch (one block), made on the host.

    int8 x (``itemsize`` 1) takes "wgmma" unless C or Cm is not a multiple
    of 16 (TMA's 16-byte rows, whole 16-byte K chunks per tap) or a pointer
    is not 16-byte aligned (``aligned``): then "mma_sync" at
    :func:`tile_plan`'s tile.  "wgmma" takes two tiles per thread block
    (one per consumer) where they fit shared memory and the launch has at
    least 8 x 132 tiles, else one tile whose columns the two consumers
    split (ResNet-50's stages 4 and 5 at b128; at stage 5's 128 tiles pairs
    would leave 68 SMs idle); ``per_cta`` (1 or 2) asks for the other, to
    time it.  Then the 8x8 or 7x7 tile with the fewer conv1 halo pixels
    over the image, as many stages as fit (at most 4), and a persistent
    grid.  The float modes take no ``per_cta``.

    f32 x (``itemsize`` 4) takes "fma_f32" at :func:`tile_plan`'s tile
    (and its ``ValueError`` where none fits).  bf16 x takes "wgmma" unless
    C or Cm is not a multiple of 8 (TMA's 16-byte rows) or a pointer is not
    16-byte aligned (``aligned``): then "mma_sync" at :func:`tile_plan`'s
    tile.  "wgmma" takes two tiles per thread block where both tiles'
    y1 and y2 and two ring stages fit shared memory, else one; among those,
    the 8x8 or 7x7 tile with the fewer conv1 halo pixels over the image;
    then as many stages as fit (at most 4).  Its grid is persistent: one
    block per SM (shared memory holds one), each walking over pairs of
    tiles, so the ring runs on from one pair into the next.  Its
    rounded-add step is one of :data:`FLOAT_ADD_STEPS`, by Cm."""
    if itemsize == 1:
        return _int8_plan(n, h, w, c, cm, aligned, per_cta)
    if per_cta:
        raise ValueError("per_cta is an int8 plan's option")

    def tiles(t):
        return n * -(-h // t) * -(-w // t)
    if itemsize == 4:
        th, tw = tile_plan(h, w, cm, 4)
        return ChainPlan("fma_f32", th, tw, 1, 3, 0, False,
                         smem_bytes(th, tw, cm, 4), tiles(th), "f32 x")
    reason = ("C or Cm not a multiple of 8" if c % 8 or cm % 8 else
              "" if aligned else "a pointer not 16-byte aligned")
    if reason:
        th, tw = tile_plan(h, w, cm, 2)
        return ChainPlan("mma_sync", th, tw, 1, 3, 0, False,
                         smem_bytes(th, tw, cm, 2), tiles(th), reason)
    fits = [(t, k) for k in (2, 1) for t in (8, 7)
            if wgmma_chain_smem(k, 2, t, t, cm) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"fused_chain: no tile of H={h} W={w} Cm={cm} "
                         f"fits {_SMEM_LIMIT} bytes of shared memory")
    t, k = min(fits, key=lambda f: (-f[1], -(-h // f[0]) * -(-w // f[0])
                                    * (f[0] + 2) ** 2, -f[0]))
    stages = max(st for st in range(2, _FW_MAX_STAGES + 1)
                 if wgmma_chain_smem(k, st, t, t, cm) <= _SMEM_LIMIT)
    return ChainPlan("wgmma", t, t, k, stages, *FLOAT_ADD_STEPS[cm > 256],
                     wgmma_chain_smem(k, stages, t, t, cm),
                     min(-(-tiles(t) // k), H100_SMS))


def _check(x, w1, b1, w2, b2, w3, b3, w_scales, scales, out_dtype):
    """Raise on shapes, types or devices the function does not take."""
    if x.dim() != 4 or w1.dim() != 3:
        raise ValueError(f"x must be NHWC and w1 (nb, C, Cm), got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    n, h, w, c = x.shape
    nb, c1, cm = w1.shape
    want = {"w1": (w1, (nb, c, cm)), "w2": (w2, (nb, 9 * cm, cm)),
            "w3": (w3, (nb, cm, c)), "b1": (b1, (nb, cm)),
            "b2": (b2, (nb, cm)), "b3": (b3, (nb, c))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("b1", b1), ("b2", b2), ("b3", b3)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dtype == torch.int8:
        if w_scales is None or scales is None:
            raise ValueError("the int8 mode needs w_scales and scales")
        for name, wt in (("w1", w1), ("w2", w2), ("w3", w3)):
            if wt.dtype != torch.int8:
                raise TypeError(f"int8 x needs int8 {name}, got {wt.dtype}")
        for name, t, shape in zip(("w1s", "w2s", "w3s"), w_scales,
                                  ((nb, cm), (nb, cm), (nb, c))):
            if (t.dtype != torch.float32 or tuple(t.shape) != shape
                    or t.device != x.device):
                raise ValueError(f"{name} must be float32 {shape} on "
                                 f"{x.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        _scale_args(nb, scales)
        if _out_dtype(x, out_dtype, scales) not in _DTYPE_CODES:
            raise TypeError(f"bad out_dtype {out_dtype}")
        return
    if x.dtype not in _FLOAT:
        raise TypeError(f"x must be int8, float32 or bfloat16, got {x.dtype}")
    if w_scales is not None or scales is not None:
        raise ValueError("w_scales and scales go with an int8 x only")
    for name, wt in (("w1", w1), ("w2", w2), ("w3", w3)):
        if wt.dtype != x.dtype:
            raise TypeError(f"{x.dtype} x needs {x.dtype} {name}, got "
                            f"{wt.dtype}")
    if _out_dtype(x, out_dtype, scales) not in _FLOAT:
        raise TypeError(f"the float mode's out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")


def fused_chain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                b3: torch.Tensor, w_scales=None,
                scales: Optional[Sequence] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Run ``nb`` chained identity bottlenecks over ``x``.

    x: (N, H, W, C) int8 (the int8 mode) or float32/bfloat16 (the float
    mode).  w1: (nb, C, Cm); w2: (nb, 9*Cm, Cm), rows tap-major (kh, kw,
    c_in); w3: (nb, Cm, C); b1, b2, b3: (nb, Cm), (nb, Cm), (nb, C)
    float32.  The int8 mode takes int8 weights, ``w_scales = (w1s, w2s,
    w3s)`` of shapes (nb, Cm), (nb, Cm), (nb, C) float32, and ``scales =
    (sx, sy1, sy2, s_out)``: three sequences of nb floats and the output's
    int8 scale, or None for a bf16 output.  The float mode takes weights of
    x's type and an ``out_dtype`` (bf16 or f32) for the last block.

    A CPU ``x`` takes :func:`fused_chain_plain`.  A CUDA ``x`` launches its
    mode's kernel once per block, its weights stored as
    :func:`kernel_layout` gives them, or raises."""
    _check(x, w1, b1, w2, b2, w3, b3, w_scales, scales, out_dtype)
    out_dtype = _out_dtype(x, out_dtype, scales)
    if x.device.type == "cpu":
        return fused_chain_plain(x, w1, b1, w2, b2, w3, b3, w_scales, scales,
                                 out_dtype)
    for name, wt in (("w1", w1), ("w2", w2), ("w3", w3)):
        if not wt.transpose(1, 2).is_contiguous():
            raise ValueError(f"{name} must be stored as kernel_layout() "
                             f"gives it: (nb, N, K) with K contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_contiguous({"x": x, "b1": b1, "b2": b2, "b3": b3,
                      **({} if w_scales is None else dict(
                          zip(("w1s", "w2s", "w3s"), w_scales)))})
    return _launch_blocks(x, w1, b1, w2, b2, w3, b3, w_scales, scales,
                          out_dtype, chain_plan, count=True)


def _launch_blocks(x, w1, b1, w2, b2, w3, b3, w_scales, scales, out_dtype,
                   plan_of, count):
    """The CUDA side of :func:`fused_chain`: one launch per block, each on
    the plan ``plan_of(n, h, w, c, cm, itemsize, aligned)`` gives it
    (``aligned``: every pointer of the launch 16-byte aligned).  ``count``:
    each launch adds one to its wrapper's count and variant (the wrapper's
    own calls; ``chip_smoke.py`` times other plans on the same tensors
    uncounted)."""
    n, h, w, c = x.shape
    nb, _, cm = w1.shape
    int8 = x.dtype == torch.int8
    plan = plan_of(n, h, w, c, cm, x.element_size(), True)
    if x.numel() == 0:
        return torch.empty_like(x, dtype=out_dtype)
    from .build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if int8:
        sx, sy1, sy2, r, out_int8 = _scale_args(nb, scales)
        w1s, w2s, w3s = w_scales
    act = x
    spare = None
    for j in range(nb):
        last = j == nb - 1
        odt = out_dtype if last else x.dtype
        if spare is not None and not last:
            out = spare
        else:
            out = torch.empty((n, h, w, c), dtype=odt, device=x.device)
        ptrs = (act, out, w1[j], w2[j], w3[j])
        plan = plan_of(n, h, w, c, cm, x.element_size(),
                       all(t.data_ptr() % 16 == 0 for t in ptrs))
        if int8:
            rc = lib.fcnn_fused_block(
                act.data_ptr(), out.data_ptr(),
                w1[j].data_ptr(), b1[j].data_ptr(), w1s[j].data_ptr(),
                w2[j].data_ptr(), b2[j].data_ptr(), w2s[j].data_ptr(),
                w3[j].data_ptr(), b3[j].data_ptr(), w3s[j].data_ptr(),
                n, h, w, c, cm, plan.th, plan.tw,
                _f32(sx[j]), _f32(sy1[j]), _f32(sy2[j]),
                _f32(1.0 / sy1[j]), _f32(1.0 / sy2[j]), _f32(r[j]),
                int(j == 0), _DTYPE_CODES[odt], *plan.int8_args(), stream)
        else:
            rc = lib.fcnn_fused_block_float(
                act.data_ptr(), out.data_ptr(),
                w1[j].data_ptr(), b1[j].data_ptr(), w2[j].data_ptr(),
                b2[j].data_ptr(), w3[j].data_ptr(), b3[j].data_ptr(),
                n, h, w, c, cm, plan.th, plan.tw, _DTYPE_CODES[x.dtype],
                _DTYPE_CODES[odt], *plan.args(), stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_chain launch failed: CUDA error {rc} (block {j} of "
                f"{nb}, x={tuple(x.shape)} {x.dtype} Cm={cm} {plan})")
        if count:
            fn = fused_chain if int8 else fused_chain_float
            fn.launches += 1
            fn.variants[plan.variant] += 1
        # the buffer this block read is free for block j + 2's output
        spare = act if act is not x else None
        act = out
    return act


def fused_chain_float(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                      b3: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """:func:`fused_chain` in the float mode alone: ``x`` float32 or
    bfloat16, weights of its type.  Its ``launches`` count the float
    kernel's launches, wherever they come from (``fused_chain.launches``
    counts the int8 kernel's)."""
    if x.dtype not in _FLOAT:
        raise TypeError(f"fused_chain_float takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    return fused_chain(x, w1, b1, w2, b2, w3, b3, out_dtype=out_dtype)


fused_chain.launches = 0
fused_chain.variants = dict.fromkeys(INT8_VARIANTS, 0)
fused_chain_float.launches = 0
fused_chain_float.variants = dict.fromkeys(FLOAT_VARIANTS, 0)
