"""``matmul_epilogue``: GEMM with a fused epilogue — the engine's GEMM.

Counterpart of ``feathercnn_tpu/kernels/matmul.py`` (the Pallas kernel
``matmul_epilogue``, :96).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/matmul_epilogue.cu`` (whose header note says
what bounds it on an H100 and what its design does about that); on a CPU
tensor it computes the same function with :func:`matmul_epilogue_plain`.

Variants (main loops of one kernel; :func:`gemm_plan` picks one per
launch, on the host, from the shapes, types and pointers):
  int8 x int8 (+ both scales) -> float or int8 out, int32 sums:
      "wgmma"     wgmma with a TMA ring and a staged epilogue
      "mma_sync"  mma.sync, for a row pitch that is not a multiple of 16
                  bytes, a misaligned pointer, or a conv's C < 16
  bf16 x int8 (weight-only int8, + w_scale) -> f32 sums:
      "wgmma_w8"  bf16 wgmma, the int8 weight tile converted to bf16 in
                  shared memory; a matrix whose tiles leave SMs idle splits
                  K (the slices added in a fixed order by a second pass)
      "simt"      for a row pitch that is not a multiple of 16 bytes (K or
                  C not a multiple of 8) or a misaligned pointer
  bf16 x bf16                 -> "mma_bf16" (mma.sync m16n8k16, f32 sums)
  f32 x f32, f32 x int8       -> "simt"     (f32 FMAs: f32 on the tensor
                                             cores would be TF32)

On the GPU the weight must be stored as :func:`gemm_layout` gives it
((N, K) with K contiguous; the lowering makes it once per node).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

__all__ = ["matmul_epilogue", "matmul_epilogue_plain", "epilogue_plain",
           "matmul_epilogue_split_plain", "fma_f32", "gemm_layout",
           "is_gemm_layout", "gemm_plan", "GemmPlan", "VARIANTS"]

_ACT_CODES = {None: 0, "relu": 1, "relu6": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# The main loops, in the order of their codes in the C interface.
VARIANTS = ("simt", "mma_sync", "wgmma", "mma_bf16", "wgmma_w8")
# Shared memory a thread block can use on an H100, and its SM count.
SMEM_LIMIT = 227 * 1024
H100_SMS = 132
WG_BM = 128             # rows of a "wgmma" output tile
MAX_STAGES = 6
PANEL_LIMIT = 144 * 1024   # the largest weight panel kept resident
W8_BK = 64              # K elements (bf16) of a "wgmma_w8" step: 128 bytes
W8_MIN_STEPS = 4        # the fewest K steps of a "wgmma_w8" split-K slice


def gemm_layout(w: torch.Tensor) -> torch.Tensor:
    """``w`` with the same values and logical shape, stored as the GEMM
    kernels read a weight: a (K, N) matrix as (N, K) with K contiguous, an
    HWIO (KH, KW, C, Co) conv weight as (Co, KH, KW, C), so that each
    output channel's K row runs over (kh, kw, c) as the im2col row does.
    wgmma takes an int8 B operand only K-major.  The lowering makes it once
    per node; on a CUDA tensor the wrappers take no other layout."""
    if w.dim() == 2:
        return w.t().contiguous().t()
    if w.dim() == 4:
        return w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    raise ValueError(f"gemm_layout takes a (K, N) or HWIO weight, got "
                     f"shape {tuple(w.shape)}")


def is_gemm_layout(w: torch.Tensor) -> bool:
    """Whether ``w`` is stored as :func:`gemm_layout` stores it."""
    if w.dim() == 2:
        return w.t().is_contiguous()
    return w.dim() == 4 and w.permute(3, 0, 1, 2).is_contiguous()


class GemmPlan(NamedTuple):
    """One launch's plan: the variant and, for "wgmma" and "wgmma_w8", the
    output tile's width ``bn``, the K step ``bk`` in bytes, the ring's
    ``stages``, whether the block's weight panel (all of K for its BN
    columns) stays resident in shared memory (``bres``, "wgmma" only), the
    persistent grid and the dynamic shared memory; ``split``, the K slices
    of a "wgmma_w8" matrix (1: none); ``th`` x ``tw``, the rectangle of
    output pixels of a "wgmma_w8" conv whose A tile comes by TMA, one box
    per tap (0 x 0: gathered by cp.async); ``reason`` says why an int8 or
    bf16 x int8 launch does not take its tensor-core variant ("" where it
    does)."""
    variant: str
    bn: int = 0
    bk: int = 0
    stages: int = 0
    bres: bool = False
    grid: int = 0
    smem: int = 0
    reason: str = ""
    split: int = 1
    th: int = 0
    tw: int = 0

    def args(self):
        """The plan's integers as the C entry points take them."""
        return (VARIANTS.index(self.variant), self.bn, self.bk, self.stages,
                int(self.bres), self.grid, self.smem, self.split, self.th,
                self.tw)


def wgmma_smem(bn: int, bk: int, stages: int, k_steps: int, bres: bool,
               out_itemsize: int, conv: bool) -> int:
    """Dynamic shared memory of the "wgmma" kernel (``wgemm_smem`` in
    csrc/gemm_common.cuh, which refuses a plan whose count differs): 1024
    bytes of alignment slack; the ring of (A, B) stages, or of A stages and
    the resident weight panel; two barriers per stage and the panel's; each
    consumer's column constants (48 bytes per column pair) and staged
    64-row output tile; the conv's 128-row table."""
    return (1024 + stages * (WG_BM + (0 if bres else bn)) * bk
            + (k_steps * bn * bk if bres else 0) + 16 * stages + 16
            + 2 * 24 * bn + 2 * 64 * (bn * out_itemsize + 16)
            + (WG_BM * 16 if conv else 0))


def w8_smem(bn: int, stages: int, conv: bool) -> int:
    """Dynamic shared memory of the "wgmma_w8" kernel (``w8gemm_smem`` in
    csrc/gemm_common.cuh, which refuses a plan whose count differs): 1024
    bytes of alignment slack; per stage the 128 x 64 bf16 A tile, the
    BN x 64 bf16 weight tile, its int8 staging slot and two barriers; each
    consumer's column constants; the conv's 128-row table (the outputs
    leave from the registers)."""
    return (1024 + stages * (WG_BM * 2 * W8_BK + bn * 3 * W8_BK + 16)
            + 2 * 24 * bn + (WG_BM * 16 if conv else 0))


def _w8_refusal(k: int, conv_c: Optional[int], x_ptr: int,
                w_ptr: int) -> str:
    pitch = conv_c if conv_c is not None else k
    if pitch % 8:
        what = "C" if conv_c is not None else "K"
        return (f"row pitch {2 * pitch} bytes ({what} = {pitch} bf16) not a "
                f"multiple of 16")
    if x_ptr % 16:
        return "x not 16-byte aligned"
    if w_ptr % 16:
        return "w not 16-byte aligned"
    return ""


def w8_split(m: int, k: int, bn: int, n: int, sms: int) -> int:
    """The K slices of a "wgmma_w8" matrix launch: where its 128 x ``bn``
    tiles leave SMs idle, as many slices as fill them, each at least
    :data:`W8_MIN_STEPS` K steps, then as few as keep the steps per slice
    (no slice empty); else 1."""
    k_steps = -(-k // W8_BK)
    tiles = -(-m // WG_BM) * -(-n // bn)
    split = max(1, min(sms // tiles, k_steps // W8_MIN_STEPS))
    per = -(-k_steps // split)
    return -(-k_steps // per)


def conv_tile(oh: int, ow: int):
    """The rectangle (th, tw) of at most 128 output pixels that a "wgmma_w8"
    conv tile covers when its A comes by TMA: the fewest rectangles per
    image, then the widest."""
    def key(tw):
        th = min(WG_BM // tw, oh)
        return (-(-oh // th) * -(-ow // tw), -tw)
    tw = min(range(1, min(ow, WG_BM) + 1), key=key)
    return min(WG_BM // tw, oh), tw


def _w8_plan(m: int, k: int, n: int, conv_c: Optional[int], conv_out,
             stride: int, sms: int) -> GemmPlan:
    conv = conv_c is not None
    bn = next((b for b in (32, 64) if n <= b), 128)
    split = 1 if conv else w8_split(m, k, bn, n, sms)
    row_tiles, th, tw = -(-m // WG_BM), 0, 0
    if conv and conv_out is not None and stride == 1 and conv_c % W8_BK == 0:
        images, oh, ow = conv_out
        th, tw = conv_tile(oh, ow)
        row_tiles = images * -(-oh // th) * -(-ow // tw)
    n_tiles = -(-n // bn)
    units = row_tiles * n_tiles * split
    grid = units if units <= sms else max(sms // n_tiles, 1) * n_tiles
    free = SMEM_LIMIT - w8_smem(bn, 0, conv)
    stages = min(MAX_STAGES, free // (WG_BM * 2 * W8_BK + bn * 3 * W8_BK + 16))
    return GemmPlan("wgmma_w8", bn, 2 * W8_BK, stages, False, grid,
                    w8_smem(bn, stages, conv), split=split, th=th, tw=tw)


def _tile_n(m: int, k: int, n: int, sms: int, conv: bool) -> int:
    """The output tile's width.  A conv gathers its A tile again for every
    column tile, so it takes the narrowest width that covers N, at most
    256.  A matrix takes the one of 256, 128, 64, 32 with the least
    estimated time: the waves of tiles over the SMs times a tile's cost,
    its width plus 16 columns (the epilogue's work grows with the width,
    padding included) plus K * (128 + width) / 512 for the bytes its main
    loop brings in; the wider on a tie."""
    if conv:
        return next((bn for bn in (32, 64, 128) if n <= bn), 256)
    m_tiles = -(-m // WG_BM)

    def cost(bn):
        return (-(-m_tiles * -(-n // bn) // sms)
                * (bn + 16 + k * (WG_BM + bn) / 512))
    return min((256, 128, 64, 32), key=lambda bn: (cost(bn), -bn))


def _wgmma_refusal(k: int, conv_c: Optional[int], x_ptr: int,
                   w_ptr: int) -> str:
    if conv_c is not None and conv_c < 16:
        return "C < 16"
    pitch = conv_c if conv_c is not None else k
    if pitch % 16:
        what = "C" if conv_c is not None else "K"
        return f"row pitch {pitch} bytes ({what}) not a multiple of 16"
    if x_ptr % 16:
        return "x not 16-byte aligned"
    if w_ptr % 16:
        return "w not 16-byte aligned"
    return ""


def gemm_plan(m: int, k: int, n: int, x_dtype, w_dtype, out_dtype, *,
              conv_c: Optional[int] = None, conv_out=None, stride: int = 1,
              x_ptr: int = 0, w_ptr: int = 0,
              sms: int = H100_SMS) -> GemmPlan:
    """The main loop, tile and stages of one launch of either GEMM kernel
    at GEMM shape (M, K, N), chosen before the launch from the shapes, the
    types and the pointers (``conv_c``: the conv's C, None for a matrix;
    ``conv_out``: the conv's (images, OH, OW), and ``stride``).

    int8 x int8 takes "wgmma" unless its rows are not 16-byte pieces (K, or
    the conv's C, not a multiple of 16; C < 16) or a pointer is not 16-byte
    aligned ("mma_sync", with the reason).  Its K step is 64 bytes at
    K <= 64, else 128; its tile width by :func:`_tile_n`; the weight panel
    resident where it is at most :data:`PANEL_LIMIT` and three A stages fit
    beside it; its stages as many as fit :data:`SMEM_LIMIT` (at most
    :data:`MAX_STAGES`, the tile narrowed until two fit); one persistent
    block per SM, the grid a multiple of the column tiles.

    bf16 x int8 (weight-only int8) takes "wgmma_w8" unless its rows are not
    16-byte pieces (K, or the conv's C, not a multiple of 8) or a pointer is
    not 16-byte aligned ("simt", with the reason).  Its K step is 64 bf16;
    its tile width the narrowest of 32, 64, 128 that covers N (128 past
    it); a matrix splits K by :func:`w8_split`; a conv at stride 1 with C a
    multiple of 64 takes its A by TMA over :func:`conv_tile`'s rectangles
    of output pixels (else the cp.async gather); its stages as many as fit
    (at most :data:`MAX_STAGES`); the grid as for "wgmma".  bf16 x bf16
    matrices with K a multiple of 8 and 16-byte aligned pointers take
    "mma_bf16"; the rest (f32 x) "simt"."""
    if x_dtype == torch.int8 and w_dtype == torch.int8:
        why = _wgmma_refusal(k, conv_c, x_ptr, w_ptr)
        if why:
            return GemmPlan("mma_sync", reason=why)
        bk = 64 if k <= 64 else 128
        bn = _tile_n(m, k, n, sms, conv_c is not None)
        osize = torch.empty((), dtype=out_dtype).element_size()
        conv = conv_c is not None
        k_steps = -(-k // bk)
        while True:
            # the weight panel resident where it fits beside >= 3 A stages
            bres = k_steps * bn * bk <= PANEL_LIMIT
            if bres:
                free = SMEM_LIMIT - wgmma_smem(bn, bk, 0, k_steps, True, osize,
                                               conv)
                stages = min(MAX_STAGES, free // (WG_BM * bk + 16))
                bres = stages >= 3
            if not bres:
                free = SMEM_LIMIT - wgmma_smem(bn, bk, 0, k_steps, False,
                                               osize, conv)
                stages = min(MAX_STAGES, free // ((WG_BM + bn) * bk + 16))
            if stages >= 2 or bn == 32:
                break
            bn //= 2
        n_tiles = -(-n // bn)
        tiles = -(-m // WG_BM) * n_tiles
        # a multiple of the column tiles: each block keeps one column tile
        grid = tiles if tiles <= sms else max(sms // n_tiles, 1) * n_tiles
        return GemmPlan("wgmma", bn, bk, stages, bres, grid,
                        wgmma_smem(bn, bk, stages, k_steps, bres, osize,
                                   conv))
    if x_dtype == torch.bfloat16 and w_dtype == torch.int8:
        why = _w8_refusal(k, conv_c, x_ptr, w_ptr)
        if why:
            return GemmPlan("simt", reason=why)
        return _w8_plan(m, k, n, conv_c, conv_out, stride, sms)
    if (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and conv_c is None and k % 8 == 0 and x_ptr % 16 == 0
            and w_ptr % 16 == 0):
        return GemmPlan("mma_bf16")
    return GemmPlan("simt")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(m, k, n, x, w, out_dtype, conv_c=None, conv_out=None,
             stride=1) -> GemmPlan:
    """:func:`gemm_plan` for CUDA operands ``x`` and ``w``."""
    return gemm_plan(m, k, n, x.dtype, w.dtype, out_dtype, conv_c=conv_c,
                     conv_out=conv_out, stride=stride, x_ptr=x.data_ptr(),
                     w_ptr=w.data_ptr(), sms=_sm_count(x.device.index or 0))


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


def matmul_epilogue_split_plain(x, w, split: int, bias=None, w_scale=None,
                                activation=None, out_dtype=None,
                                x_scale: float = 1.0, out_scale: float = 1.0,
                                lo=None, hi=None):
    """:func:`matmul_epilogue_plain` of a float ``x`` in the order of a
    "wgmma_w8" plan that splits K into ``split`` slices: each slice of
    ``ceil(k_steps / split)`` K steps of :data:`W8_BK` summed in f32, the
    slices then added one by one in index order with f32 rounding (the
    split-K pass), then the epilogue."""
    out_dtype = _default_out_dtype(x, out_dtype)
    k = x.shape[1]
    k_steps = -(-k // W8_BK)
    per = -(-k_steps // split) * W8_BK
    acc = None
    for k0 in range(0, k, per):
        part = x[:, k0:k0 + per].float() @ w[k0:k0 + per].to(x.dtype).float()
        acc = part if acc is None else acc + part
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
    Raises unless x and the vectors are contiguous and w is stored as
    :func:`gemm_layout` stores it."""
    check_contiguous({"x": x, **vecs})
    if not is_gemm_layout(w):
        raise ValueError("w must be stored as gemm_layout(w) gives it: "
                         "(N, K) with K contiguous")
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

    x: (M, K) float32/bfloat16/int8;  w: (K, N) same type or int8, on the
    GPU stored as :func:`gemm_layout` gives it; bias, w_scale, lo, hi: (N,)
    float32.  Ragged M/N/K are masked in the kernel.  A CPU ``x`` takes the
    plain version; a CUDA ``x`` launches the variant :func:`gemm_plan`
    picks, counted in ``matmul_epilogue.variants``, or raises."""
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
    plan = plan_for(M, K, N, x, w, out_dtype)
    # the split-K slices' f32 sums ("wgmma_w8" with split > 1)
    ws = (torch.empty((plan.split, M, N), dtype=torch.float32,
                      device=x.device) if plan.split > 1 else None)
    from .build import load_library
    rc = load_library().fcnn_matmul_epilogue(
        *ptrs, M, K, N, *codes, float(x_scale), float(out_scale),
        *plan.args(), None if ws is None else ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_epilogue launch failed: CUDA error {rc} "
                           f"(M={M} K={K} N={N} x={x.dtype} w={w.dtype} "
                           f"{plan})")
    matmul_epilogue.launches += 1
    matmul_epilogue.variants[plan.variant] += 1
    return out


matmul_epilogue.launches = 0
matmul_epilogue.variants = dict.fromkeys(VARIANTS, 0)
