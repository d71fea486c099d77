"""``matmul_epilogue``: GEMM with a fused epilogue — the engine's GEMM.

Counterpart of ``feathercnn_tpu/kernels/matmul.py`` (the Pallas kernel
``matmul_epilogue``, :96).  On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/matmul_epilogue.cu`` (whose header note says
what bounds it on an H100 and what its design does about that); on a CPU
tensor it computes the same function with :func:`matmul_epilogue_plain`.

Variants (main loops of one kernel; :func:`gemm_plan` picks one per
launch, on the host, from the shapes, types and pointers):
  int8 x int8 (+ both scales) -> float or int8 out, int32 sums:
      "wgmma"     wgmma with a TMA ring and a staged epilogue; a launch
                  whose tiles leave SMs idle splits K (``split``; the
                  int32 slices added exactly by a second pass, which
                  applies the epilogue)
      "wgmma_ragged"  the same ring, consumers and epilogue for rows that
                  are not whole 16-byte pieces (K or C not a multiple of
                  16, or a matrix's x not 16-byte aligned): a matrix's A
                  tile staged by a bulk copy and re-laid in shared memory
                  (K <= 256), a conv's gathered in 8-byte pieces (C a
                  multiple of 8); the weight's rows padded to 16 bytes
      "mma_sync"  mma.sync (the first body), for what neither takes: C
                  not a multiple of 8, a conv x not 8-byte aligned, a
                  ragged K past 256
      "wgmma_halo"  a grouped 3x3 conv's super-groups (32 output
                  channels a column tile reading 32 input channels): each
                  tile's input halo by one TMA box, the nine taps by
                  ldmatrix into register-A wgmma
  bf16 x int8 (weight-only int8, + w_scale) -> f32 sums:
      "wgmma_w8"  bf16 wgmma, the int8 weight tile converted to bf16 in
                  shared memory; a matrix whose tiles leave SMs idle splits
                  K (the slices added in a fixed order by a second pass)
      "simt"      for a row pitch that is not a multiple of 16 bytes (K or
                  C not a multiple of 8) or a misaligned pointer
  bf16 x bf16 (a matrix), f32 sums:
      "wgmma_bf16"  the "wgmma_w8" kernel with the bf16 weight tile brought
                  by TMA (no conversion), K split the same way
  f32 x f32, f32 x int8       -> "simt"     (f32 FMAs: f32 on the tensor
                                             cores would be TF32)

On the GPU the weight must be stored as :func:`gemm_layout` gives it
((N, K) with K contiguous, an int8 weight's rows padded to a multiple of
16 bytes; the lowering makes it once per node).  A grouped int8 3x3 conv
(1 < group < C) runs on "wgmma_halo" as super-groups (:func:`supergroup`):
a column tile of q whole groups reads only their q * C/group = 32 input
channels, its weight compacted by :func:`grouped_layout`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..numerics import apply_activation, fma_f32, requantize, scale_tensor

__all__ = ["matmul_epilogue", "matmul_epilogue_plain", "epilogue_plain",
           "matmul_epilogue_split_plain", "gemm_layout",
           "is_gemm_layout", "gemm_pitch", "gemm_plan", "GemmPlan",
           "VARIANTS", "split_workspace", "supergroup", "grouped_layout"]

_ACT_CODES = {None: 0, "relu": 1, "relu6": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# The main loops, in the order of their codes in the C interface.
VARIANTS = ("simt", "mma_sync", "wgmma", "wgmma_w8", "wgmma_ragged",
            "wgmma_bf16", "wgmma_halo")
# Shared memory a thread block can use on an H100, and its SM count.
SMEM_LIMIT = 227 * 1024
H100_SMS = 132
WG_BM = 128             # rows of a "wgmma" output tile
MAX_STAGES = 6
PANEL_LIMIT = 144 * 1024   # the largest weight panel kept resident
W8_BK = 64              # K elements (bf16) of a "wgmma_w8" step: 128 bytes
SPLIT_MIN_STEPS = 4     # the fewest K steps of a split-K slice
# ... of a "wgmma_bf16" slice: its second pass reads split x M x N f32,
# which at M = 128 costs more than shorter slices save
BF16_MIN_STEPS = 8
# An int8 launch splits K only where its tiles fill at most a third of the
# SMs and each block's unsplit main loop loads at least this many bytes
# (k_steps x (128 + BN) x BK): shorter loops, or tiles that already fill
# half the SMs (a split of 2), do not win back the second pass and its
# workspace (chip_smoke.py's split launches lines)
SPLIT_MIN_BYTES = 384 * 1024
RAGGED_K_MAX = 256      # a "wgmma_ragged" matrix's K at most (staged tiles)
ROW_BYTES = 16          # an int8 weight's rows are padded to this multiple
HALO_S = 32             # a super-group's input and output channels
HALO_MAX_STAGES = 8     # halos a "wgmma_halo" ring holds at most
# a "wgmma_halo" tile's fixed cost in bytes of halo, for halo_tile's
# choice: its epilogue over all 128 rows, whatever the rectangle leaves
# of them, took ~3 times a 20 KB halo's time at ResNeXt-50's stage 2
# (chip_smoke.py's and the tile's parts, H100)
HALO_TILE_BYTES = 60 * 1024


def gemm_layout(w: torch.Tensor) -> torch.Tensor:
    """``w`` with the same values and logical shape, stored as the GEMM
    kernels read a weight: a (K, N) matrix as (N, K) with K contiguous, an
    HWIO (KH, KW, C, Co) conv weight as (Co, KH, KW, C), so that each
    output channel's K row runs over (kh, kw, c) as the im2col row does.
    wgmma takes an int8 B operand only K-major.  An int8 weight whose K is
    not a multiple of :data:`ROW_BYTES` keeps its rows that many bytes
    apart, the bytes past K zero (a strided view: the logical shape and
    values stay), so that TMA can bring its tiles ("wgmma_ragged").  The
    lowering makes it once per node; on a CUDA tensor the wrappers take no
    other layout."""
    if w.dim() not in (2, 4):
        raise ValueError(f"gemm_layout takes a (K, N) or HWIO weight, got "
                         f"shape {tuple(w.shape)}")
    n, k = w.shape[-1], math.prod(w.shape[:-1])
    pitch = k
    if w.dtype == torch.int8 and k % ROW_BYTES:
        pitch = -(-k // ROW_BYTES) * ROW_BYTES
    rows = w.new_zeros((n, pitch))
    rows[:, :k] = w.reshape(k, n).t()
    k_rows = rows[:, :k]
    if w.dim() == 2:
        return k_rows.t()
    return k_rows.view(n, *w.shape[:3]).permute(1, 2, 3, 0)


def stride_pair(stride) -> tuple:
    """(sh, sw) of a conv's stride given as an int or an (sh, sw) pair."""
    return (stride, stride) if isinstance(stride, int) else (
        int(stride[0]), int(stride[1]))


def supergroup(c: int, co: int, group: int, kernel=(3, 3),
               stride=1) -> tuple:
    """(q, reason) of a grouped int8 conv (``group`` groups, C input and Co
    output channels, ``kernel`` = (KH, KW), ``stride`` an int or an (sh,
    sw) pair) on the super-group route: its column tiles are q whole
    groups, BN = q * Co/group output channels reading the same S = q *
    C/group input channels.  The route's kernel ("wgmma_halo") is built for
    3x3 convs at a square stride and BN = S = :data:`HALO_S` alone, the
    one form ResNeXt-50's cardinality-32 convs take (q = 32 / (C/32)), so
    q = 32 / (C/group) where C/group = Co/group divides 32 and q divides
    ``group``.  (0, why) where no q fits: the conv keeps its
    block-diagonal weight (``kernels/dispatch.py::block_diagonal``)."""
    kh, kw = kernel
    sh, sw = stride_pair(stride)
    if sh != sw:
        return 0, (f"stride ({sh}, {sw}) (the super-group kernel's halo "
                   f"takes a square stride)")
    if (kh, kw) == (1, 1):
        return 0, "a grouped 1x1 conv is a B1 matrix"
    if (kh, kw) != (3, 3):
        return 0, f"a {kh}x{kw} kernel (the super-group kernel is 3x3)"
    cgi, cgo = c // group, co // group
    q = HALO_S // cgi if cgi and HALO_S % cgi == 0 else 0
    if cgi != cgo or not q or group % q:
        return 0, (f"C/g = {cgi}, Co/g = {cgo}: no q dividing g = {group} "
                   f"makes a {HALO_S} x {HALO_S} super-group (the kernel's "
                   f"one form)")
    return q, ""


def grouped_layout(w: torch.Tensor, group: int, q: int) -> torch.Tensor:
    """A grouped conv's HWIO weight (KH, KW, C/group, Co) as the super-group
    route reads it: the (KH, KW, S, Co) weight, S = q * C/group, in which
    output channel o of group j keeps its weights on the input channels
    (j % q) * C/group .. + C/group - 1 of its super-group (groups j // q *
    q .. + q - 1) and is zero on the other S - C/group, stored as
    :func:`gemm_layout` stores it: row o is the (KH*KW*S) K row of column
    tile o // BN, tap-major, padded to :data:`ROW_BYTES`.  At q = group it
    is the block-diagonal dense weight."""
    kh, kw, cgi, co = w.shape
    if group < 1 or co % group or group % q:
        raise ValueError(f"grouped_layout: Co = {co}, group = {group}, "
                         f"q = {q}")
    cgo = co // group
    dense = w.new_zeros((kh, kw, q * cgi, co))
    for j in range(group):
        jl = j % q
        dense[:, :, jl * cgi:(jl + 1) * cgi, j * cgo:(j + 1) * cgo] = \
            w[..., j * cgo:(j + 1) * cgo]
    return gemm_layout(dense)


def _k_rows(w: torch.Tensor) -> torch.Tensor:
    """The (N, K...) view of a weight: its output channels first."""
    return w.t() if w.dim() == 2 else w.permute(3, 0, 1, 2)


def gemm_pitch(w: torch.Tensor) -> int:
    """Elements between the (N, K) rows of a weight stored as
    :func:`gemm_layout` stores it: K, or K padded to :data:`ROW_BYTES`."""
    rows = _k_rows(w)
    k = rows[0].numel()
    # one row: its stride is the layout's where gemm_layout made it
    return rows.stride(0) if rows.shape[0] > 1 or rows.stride(0) > k else k


def is_gemm_layout(w: torch.Tensor) -> bool:
    """Whether ``w`` is stored as :func:`gemm_layout` stores it: each
    output channel's K row contiguous, the rows K apart or a multiple of
    :data:`ROW_BYTES` apart past K."""
    if w.dim() not in (2, 4):
        return False
    rows = _k_rows(w)
    if rows.shape[0] == 0 or not rows[0].is_contiguous():
        return False
    k, pitch = rows[0].numel(), gemm_pitch(w)
    return pitch == k or (pitch > k and pitch % ROW_BYTES == 0)


class GemmPlan(NamedTuple):
    """One launch's plan: the variant and, for the wgmma variants, the
    output tile's width ``bn``, the K step ``bk`` in bytes, the ring's
    ``stages``, whether the block's weight panel (all of K for its BN
    columns) stays resident in shared memory (``bres``, "wgmma" only), the
    persistent grid and the dynamic shared memory; ``split``, the K slices
    whose sums a second pass adds (1: none; :func:`split_workspace` holds
    them); ``th`` x ``tw``, the rectangle of
    output pixels of a "wgmma_w8" conv whose A tile comes by TMA, one box
    per tap (0 x 0: gathered by cp.async); ``reason`` says why an int8
    launch does not take "wgmma" (why it takes "wgmma_ragged", or why
    neither), or a bf16 x int8 one "wgmma_w8" ("" where it does);
    ``ldw``, the weight's row pitch (:func:`gemm_pitch`; 0: K); ``sst``,
    the A tiles a "wgmma_ragged" matrix stages at once (else 0)."""
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
    ldw: int = 0
    sst: int = 0

    def args(self):
        """The plan's integers as the C entry points take them."""
        return (VARIANTS.index(self.variant), self.bn, self.bk, self.stages,
                int(self.bres), self.grid, self.smem, self.split, self.th,
                self.tw, self.ldw, self.sst)


def ragged_stage_bytes(k: int) -> int:
    """One staging buffer of a "wgmma_ragged" matrix (``ragged_stage_bytes``
    in csrc/gemm_common.cuh): a 128-row tile's 128 * K bytes at the run's
    own offset mod 16, and the bytes the re-lay's last loads read past it,
    in 128-byte units."""
    return -(-(WG_BM * k + 48) // 128) * 128


def wgmma_smem(bn: int, bk: int, stages: int, k_steps: int, bres: bool,
               out_itemsize: int, conv: bool, sb: int = 0,
               sst: int = 0) -> int:
    """Dynamic shared memory of the "wgmma" and "wgmma_ragged" kernel
    (``wgemm_smem`` in csrc/gemm_common.cuh, which refuses a plan whose
    count differs): 1024 bytes of alignment slack; the ring of (A, B)
    stages, or of A stages and the resident weight panel; a ragged
    matrix's ``sst`` staging buffers of ``sb`` bytes; two barriers per
    stage and the panel's, and one per staging buffer; each consumer's
    column constants (48 bytes per column pair) and staged 64-row output
    tile; the conv's 128-row table."""
    return (1024 + stages * (WG_BM + (0 if bres else bn)) * bk
            + (k_steps * bn * bk if bres else 0) + sst * (sb + 16)
            + 16 * stages + 16 + 2 * 24 * bn + 2 * 64 * (bn * out_itemsize
                                                        + 16)
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


def bf16_smem(bn: int, stages: int) -> int:
    """Dynamic shared memory of the "wgmma_bf16" kernel (``bf16gemm_smem``
    in csrc/gemm_common.cuh): as :func:`w8_smem` for a matrix, with a stage
    of the A tile and the bf16 weight tile alone (both by TMA)."""
    return (1024 + stages * (WG_BM * 2 * W8_BK + bn * 2 * W8_BK + 16)
            + 2 * 24 * bn)


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


def split_k(tiles: int, k_steps: int, sms: int,
            min_steps: int = SPLIT_MIN_STEPS) -> int:
    """The K slices of a launch of ``tiles`` output tiles and ``k_steps``
    K steps: where its tiles leave SMs idle, as many slices as fill them,
    each at least ``min_steps`` K steps, then as few as keep the steps per
    slice (no slice empty); else 1."""
    split = max(1, min(sms // tiles, k_steps // min_steps))
    per = -(-k_steps // split)
    return -(-k_steps // per)


def w8_split(m: int, k: int, bn: int, n: int, sms: int,
             min_steps: int = SPLIT_MIN_STEPS) -> int:
    """The K slices (:func:`split_k`) of a "wgmma_w8" matrix launch on
    128 x ``bn`` tiles (a "wgmma_bf16" one's with ``min_steps``
    :data:`BF16_MIN_STEPS`)."""
    return split_k(-(-m // WG_BM) * -(-n // bn), -(-k // W8_BK), sms,
                   min_steps)


def split_workspace(plan: GemmPlan, m: int, n: int, x_dtype,
                    device) -> Optional[torch.Tensor]:
    """The (split, M, N) sums of a plan that splits K, uninitialised (each
    slice writes all of its own): int32 for an int8 x, f32 for a float one;
    None for a plan that does not split."""
    if plan.split == 1:
        return None
    dtype = torch.int32 if x_dtype == torch.int8 else torch.float32
    return torch.empty((plan.split, m, n), dtype=dtype, device=device)


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
             stride: int, sms: int, w16: bool = False) -> GemmPlan:
    """The plan of a "wgmma_w8" launch, or with ``w16`` of a "wgmma_bf16"
    matrix (see :func:`gemm_plan`)."""
    conv = conv_c is not None
    # a bf16 weight tile is twice an int8 one's bytes: at most 64 wide, so
    # that twice the blocks share the loads
    bn = next((b for b in (32, 64) if n <= b), 64 if w16 else 128)
    split = 1 if conv else w8_split(m, k, bn, n, sms,
                                    BF16_MIN_STEPS if w16 else
                                    SPLIT_MIN_STEPS)
    row_tiles, th, tw = -(-m // WG_BM), 0, 0
    if conv and conv_out is not None and stride == 1 and conv_c % W8_BK == 0:
        images, oh, ow = conv_out
        th, tw = conv_tile(oh, ow)
        row_tiles = images * -(-oh // th) * -(-ow // tw)
    n_tiles = -(-n // bn)
    units = row_tiles * n_tiles * split
    grid = units if units <= sms else max(sms // n_tiles, 1) * n_tiles
    smem = (lambda st: bf16_smem(bn, st)) if w16 else (
        lambda st: w8_smem(bn, st, conv))
    stages = min(MAX_STAGES, (SMEM_LIMIT - smem(0)) // (smem(1) - smem(0)))
    return GemmPlan("wgmma_bf16" if w16 else "wgmma_w8", bn, 2 * W8_BK,
                    stages, False, grid, smem(stages), split=split, th=th,
                    tw=tw)


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
                   w_ptr: int, ldw: int) -> str:
    if conv_c is not None and conv_c < 16:
        return "C < 16"
    pitch = conv_c if conv_c is not None else k
    if pitch % 16:
        what = "C" if conv_c is not None else "K"
        return f"row pitch {pitch} bytes ({what}) not a multiple of 16"
    if x_ptr % 16:
        return "x not 16-byte aligned"
    if w_ptr % 16 or ldw % 16:
        return "w not 16-byte aligned"
    return ""


def _ragged_refusal(k: int, conv_c: Optional[int], x_ptr: int, w_ptr: int,
                    ldw: int) -> str:
    if conv_c is not None:
        if conv_c % 8:
            return f"C = {conv_c} not a multiple of 8 (8-byte pieces)"
        if x_ptr % 8:
            return "x not 8-byte aligned"
    elif k > RAGGED_K_MAX:
        return f"K = {k} > {RAGGED_K_MAX} (the staged A tiles do not fit)"
    if ldw % ROW_BYTES:
        return f"w rows {ldw} bytes apart: not padded by gemm_layout"
    if w_ptr % 16:
        return "w not 16-byte aligned"
    return ""


def _wgmma_plan(variant: str, m: int, k: int, n: int, osize: int,
                conv: bool, sms: int, ldw: int, reason: str = "",
                split: bool = True) -> GemmPlan:
    """The tile, K step, ring, K slices and grid of a "wgmma" or
    "wgmma_ragged" launch (see :func:`gemm_plan`); with ``split`` False,
    the plan without K slices (the one such a launch took before K was
    split, timed beside the rule's by chip_smoke.py)."""
    bk = 64 if k <= 64 else 128
    bn = _tile_n(m, k, n, sms, conv)
    k_steps = -(-k // bk)
    # a ragged matrix's staging ring: 4 tiles in flight where 3 A stages
    # fit beside them, else 2
    sb = ragged_stage_bytes(k) if variant == "wgmma_ragged" and not conv \
        else 0
    while True:
        tiles = -(-m // WG_BM) * -(-n // bn)
        worth = (split and variant == "wgmma" and 3 * tiles <= sms
                 and k_steps * (WG_BM + bn) * bk >= SPLIT_MIN_BYTES)
        sp = split_k(tiles, k_steps, sms) if worth else 1
        for sst in ((4, 2) if sb else (0,)):
            # the weight panel resident where it fits beside >= 3 A stages
            # (not with a split: a block then runs one slice of one tile)
            bres = sp == 1 and k_steps * bn * bk <= PANEL_LIMIT
            if bres:
                free = SMEM_LIMIT - wgmma_smem(bn, bk, 0, k_steps, True,
                                               osize, conv, sb, sst)
                stages = min(MAX_STAGES, free // (WG_BM * bk + 16))
                bres = stages >= 3
            if not bres:
                free = SMEM_LIMIT - wgmma_smem(bn, bk, 0, k_steps, False,
                                               osize, conv, sb, sst)
                stages = min(MAX_STAGES, free // ((WG_BM + bn) * bk + 16))
            if stages >= 3:
                break
        if stages >= 2 or bn == 32:
            break
        bn //= 2
    n_tiles = -(-n // bn)
    units = -(-m // WG_BM) * n_tiles * sp
    # a multiple of the column tiles: each block keeps one column tile
    grid = units if units <= sms else max(sms // n_tiles, 1) * n_tiles
    return GemmPlan(variant, bn, bk, stages, bres, grid,
                    wgmma_smem(bn, bk, stages, k_steps, bres, osize, conv,
                               sb, sst), reason, split=sp, ldw=ldw, sst=sst)


def halo_images(th: int, tw: int, oh: int, ow: int) -> int:
    """Images a "wgmma_halo" tile holds (``halo_images`` in
    csrc/gemm_common.cuh): as many as 128 rows take where the th x tw
    rectangle is the whole output map and two fit, else 1."""
    return WG_BM // (th * tw) if (th, tw) == (oh, ow) and \
        2 * th * tw <= WG_BM else 1


def halo_group(n_tiles: int, stride: int = 1, osize: int = 1) -> int:
    """Column tiles whose channels one "wgmma_halo" halo holds
    (``halo_group`` in csrc/gemm_common.cuh): four (rows of 128 bytes) at
    stride 1 with an int8 output where they divide the launch's
    ``n_tiles``, else 1 (32-byte rows).  TMA brings a box one row (pixel)
    at a time, so 128-byte rows move four times the bytes of 32-byte ones
    in the same time; a stride-2 halo of 128-byte rows leaves room for
    small tiles only, a wider output for few stages."""
    return 4 if stride == 1 and osize == 1 and n_tiles % 4 == 0 else 1


def halo_smem(stages: int, halo_bytes: int, osize: int, g: int = 1) -> int:
    """Dynamic shared memory of the "wgmma_halo" kernel (``hgemm_smem`` in
    csrc/gemm_common.cuh): 1024 bytes of alignment slack; the ring of
    halos in 1024-byte steps; the resident weight panel (``g`` column
    tiles' 9 * 32 bytes of K in 32 x 128-byte tiles); two barriers and a
    tile origin per stage, the panel's barrier; the tile's row -> pixel
    table; each of the four consumer warpgroups' column constants and
    staged 64-row output tile (g * 32 columns each)."""
    k_tiles = -(-(9 * HALO_S // 32) // 4)
    return (1024 + stages * -(-halo_bytes // 1024) * 1024
            + g * k_tiles * HALO_S * 128 + 32 * stages + 16 + 4 * WG_BM
            + 4 * (24 * g * HALO_S + 64 * (g * HALO_S * osize + 16)))


def halo_tile(oh: int, ow: int, stride: int, row_bytes: int,
              fits=lambda halo_bytes: True):
    """The "wgmma_halo" tile (th, tw) of a 3x3 conv's OH x OW map at
    ``stride``, halo rows of ``row_bytes``: at most 128 output pixels
    (several whole maps where they fit, ``halo_images``), its halo
    ((th-1)*stride+3) x ((tw-1)*stride+3) within TMA's 256 a side and
    within ``fits`` (of its bytes); the one whose halos cost least per
    image, each halo's bytes plus :data:`HALO_TILE_BYTES`, then the one
    with more rows, then the wider (a warp's rows then stay on one row of
    the halo)."""
    best = None
    for tw in range(1, min(ow, WG_BM) + 1):
        for th in range(1, min(oh, WG_BM // tw) + 1):
            hh, hw = (th - 1) * stride + 3, (tw - 1) * stride + 3
            ti = halo_images(th, tw, oh, ow)
            if hh > 256 or hw > 256 or not fits(ti * hh * hw * row_bytes):
                continue
            rects = -(-oh // th) * -(-ow // tw)
            cost = rects * (ti * hh * hw * row_bytes + HALO_TILE_BYTES) / ti
            key = (cost, -ti * th * tw, -tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return best[1]


@functools.lru_cache(maxsize=None)
def _halo_plan(c: int, n: int, osize: int, sms: int, conv_out,
               stride: int, ldw: int) -> GemmPlan:
    """The "wgmma_halo" plan of a super-group launch (see
    :func:`supergroup_plan`), made once per shape: its tile search takes
    milliseconds of Python."""
    images, oh, ow = conv_out
    n_tiles = c // HALO_S
    g = halo_group(n_tiles, stride, osize)

    def stages_for(hb):
        def smem(st):
            return halo_smem(st, hb, osize, g)
        # a multiple of the two consumer pairs
        return min(HALO_MAX_STAGES, (SMEM_LIMIT - smem(0))
                   // (smem(1) - smem(0))) // 2 * 2
    # at least four halos in flight
    th, tw = halo_tile(oh, ow, stride, g * HALO_S,
                       lambda hb: stages_for(hb) >= 4)
    ti = halo_images(th, tw, oh, ow)
    hb = ti * ((th - 1) * stride + 3) * ((tw - 1) * stride + 3) * g * HALO_S
    stages = stages_for(hb)
    n_groups = n_tiles // g
    units = -(-images // ti) * -(-oh // th) * -(-ow // tw) * n_groups
    grid = units if units <= sms else max(sms // n_groups, 1) * n_groups
    return GemmPlan("wgmma_halo", HALO_S, 128, stages, True, grid,
                    halo_smem(stages, hb, osize, g), th=th, tw=tw, ldw=ldw)


def supergroup_plan(m: int, c: int, n: int, osize: int, conv_out,
                    stride: int = 1, sms: int = H100_SMS, x_ptr: int = 0,
                    w_ptr: int = 0, ldw: int = 9 * HALO_S) -> GemmPlan:
    """The "wgmma_halo" plan of a super-group launch (a 3x3 conv over C
    channels, its N = C outputs in C/32 column tiles of 32 reading 32
    channels each; :func:`supergroup`): halos of :func:`halo_group`'s
    column tiles over :func:`halo_tile`'s tile of the ``conv_out`` =
    (images, OH, OW) map, with at least four in flight; the ring as deep
    as fits, at most :data:`HALO_MAX_STAGES`, a multiple of the two
    consumer pairs; the grid a multiple of the column tile groups.  Raises
    where the pointers are not 16-byte aligned: nothing falls back."""
    if (conv_out is None or n != c or c % HALO_S
            or m != conv_out[0] * conv_out[1] * conv_out[2]):
        raise ValueError(f"super-group launch M = {m}, C = {c}, N = {n}, "
                         f"map {conv_out}")
    if x_ptr % 16 or w_ptr % 16 or ldw % ROW_BYTES:
        raise ValueError(f"super-group launch (C = {c}): x or w not 16-byte "
                         f"aligned, or w rows {ldw} bytes apart")
    return _halo_plan(c, n, osize, sms, tuple(conv_out), stride, ldw)


def gemm_plan(m: int, k: int, n: int, x_dtype, w_dtype, out_dtype, *,
              conv_c: Optional[int] = None, conv_out=None, stride: int = 1,
              x_ptr: int = 0, w_ptr: int = 0, w_pitch: Optional[int] = None,
              sms: int = H100_SMS, group: int = 1,
              conv_s: Optional[int] = None, kernel=(1, 1)) -> GemmPlan:
    """The main loop, tile and stages of one launch of either GEMM kernel
    at GEMM shape (M, K, N), chosen before the launch from the shapes, the
    types, the pointers and the weight's row pitch (``conv_c``: the conv's
    C, None for a matrix; ``conv_out``: the conv's (images, OH, OW), and
    ``stride``, an int or an (sh, sw) pair; ``w_pitch``:
    :func:`gemm_pitch` of the weight, None for the pitch
    :func:`gemm_layout` gives it).

    int8 x int8 takes "wgmma" unless its rows are not 16-byte pieces (K, or
    the conv's C, not a multiple of 16; C < 16) or a pointer is not 16-byte
    aligned.  Its K step is 64 bytes at K <= 64, else 128; its tile width
    by :func:`_tile_n`; the weight panel resident where it is at most
    :data:`PANEL_LIMIT` and three A stages fit beside it; its stages as
    many as fit :data:`SMEM_LIMIT` (at most :data:`MAX_STAGES`, the tile
    narrowed until two fit); where its tiles fill at most a third of the
    SMs and a block's K loop loads at least :data:`SPLIT_MIN_BYTES`, K
    split into :func:`split_k`'s slices ("wgmma" alone) (no resident panel then, one slice
    of one tile per block); one persistent block per SM, the grid a
    multiple of the column tiles.  What "wgmma" refuses takes
    "wgmma_ragged" (the refusal its ``reason``), planned the same way,
    where the weight's rows are padded to 16 bytes and: a matrix's K is at
    most :data:`RAGGED_K_MAX` (x at any alignment: its staging ring holds
    4 tiles, or 2 where 3 A stages do not fit beside 4); a conv's C is a
    multiple of 8 and x is 8-byte aligned.  The rest takes
    "mma_sync", both refusals its reason.

    bf16 x int8 (weight-only int8) takes "wgmma_w8" unless its rows are not
    16-byte pieces (K, or the conv's C, not a multiple of 8) or a pointer is
    not 16-byte aligned ("simt", with the reason).  Its K step is 64 bf16;
    its tile width the narrowest of 32, 64, 128 that covers N (128 past
    it); a matrix splits K by :func:`w8_split`; a conv at stride 1 with C a
    multiple of 64 takes its A by TMA over :func:`conv_tile`'s rectangles
    of output pixels (else the cp.async gather); its stages as many as fit
    (at most :data:`MAX_STAGES`); the grid as for "wgmma".  bf16 x bf16
    matrices with K a multiple of 8 and 16-byte aligned pointers take
    "wgmma_bf16", planned as a "wgmma_w8" matrix but for its tile, at most
    64 wide, its slices, at least :data:`BF16_MIN_STEPS` K steps, and its
    stages (:func:`bf16_smem`); the rest (f32 x) "simt".

    A grouped int8 conv (``group`` > 1, its weight ``conv_s`` channels
    wide, ``kernel`` = (KH, KW); K = KH * KW * conv_s) whose weight is
    :func:`grouped_layout`'s at :func:`supergroup`'s q takes
    :func:`supergroup_plan`; where no q fits, its block-diagonal weight
    (conv_s = C) is planned as an ungrouped conv's, the reason saying why
    no super-group fits."""
    sh, sw = stride_pair(stride)
    stride = sh if sh == sw else (sh, sw)
    ldw = k if w_pitch is None else w_pitch
    if w_pitch is None and w_dtype == torch.int8 and k % ROW_BYTES:
        ldw = -(-k // ROW_BYTES) * ROW_BYTES
    if x_dtype == torch.int8 and w_dtype == torch.int8:
        osize = torch.empty((), dtype=out_dtype).element_size()
        conv = conv_c is not None
        if conv and group > 1:
            q, why = supergroup(conv_c, n, group, kernel, stride)
            if q and conv_s == q * conv_c // group:
                return supergroup_plan(m, conv_c, n, osize, conv_out,
                                       stride, sms, x_ptr, w_ptr, ldw)
            if q or conv_s != conv_c:
                raise ValueError(
                    f"a grouped conv's weight {conv_s} channels wide: "
                    f"grouped_layout's is {q * conv_c // group if q else conv_c}")
            plan = gemm_plan(m, k, n, x_dtype, w_dtype, out_dtype,
                             conv_c=conv_c, x_ptr=x_ptr, w_ptr=w_ptr,
                             w_pitch=w_pitch, sms=sms)
            return plan._replace(reason="; ".join(
                r for r in (f"block-diagonal: {why}", plan.reason) if r))
        why = _wgmma_refusal(k, conv_c, x_ptr, w_ptr, ldw)
        if not why:
            return _wgmma_plan("wgmma", m, k, n, osize, conv, sms, ldw)
        why_not = _ragged_refusal(k, conv_c, x_ptr, w_ptr, ldw)
        if not why_not:
            return _wgmma_plan("wgmma_ragged", m, k, n, osize, conv, sms,
                               ldw, why)
        return GemmPlan("mma_sync", reason=f"{why}; {why_not}", ldw=ldw)
    if x_dtype == torch.bfloat16 and w_dtype == torch.int8:
        why = _w8_refusal(k, conv_c, x_ptr, w_ptr)
        if not why and ldw % 8:
            why = f"w rows {ldw} bytes apart, not a multiple of 8"
        if why:
            return GemmPlan("simt", reason=why, ldw=ldw)
        return _w8_plan(m, k, n, conv_c, conv_out, stride, sms)._replace(
            ldw=ldw)
    if (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and conv_c is None and k % 8 == 0 and x_ptr % 16 == 0
            and w_ptr % 16 == 0 and ldw % 8 == 0):
        return _w8_plan(m, k, n, None, None, 1, sms, w16=True)._replace(
            ldw=ldw)
    return GemmPlan("simt", ldw=ldw)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(m, k, n, x, w, out_dtype, conv_c=None, conv_out=None,
             stride=1, group=1) -> GemmPlan:
    """:func:`gemm_plan` for CUDA operands ``x`` and ``w`` (a conv's
    ``group``: its weight's width and taps from ``w``'s HWIO shape)."""
    grouped = {}
    if group > 1:
        grouped = dict(group=group, conv_s=w.shape[2],
                       kernel=(w.shape[0], w.shape[1]))
    return gemm_plan(m, k, n, x.dtype, w.dtype, out_dtype, conv_c=conv_c,
                     conv_out=conv_out, stride=stride, x_ptr=x.data_ptr(),
                     w_ptr=w.data_ptr(), w_pitch=gemm_pitch(w),
                     sms=_sm_count(x.device.index or 0), **grouped)


def epilogue_plain(acc: torch.Tensor, w_scale=None, x_scale: float = 1.0,
                   bias=None, activation: Optional[str] = None,
                   lo=None, hi=None, out_dtype=torch.float32,
                   out_scale: float = 1.0) -> torch.Tensor:
    """The kernels' epilogue on an f32 accumulator (last axis = output
    channel), step for step: ``acc * w_scale * x_scale + bias`` with the
    last multiply and the bias add rounding once (as the reference's
    compiled epilogue contracts them), activation, lo/hi clamp, then the
    store (int8: round half to even of ``y * out_scale``, saturated).  The
    dispatcher passes ``x_scale`` and ``out_scale`` as its nodes' kept
    ``numerics.Scale`` values: their device tensors, made once."""
    y = acc
    last = None
    if w_scale is not None:
        last = w_scale
    if x_scale != 1.0:
        if last is not None:
            y = y * last
        last = scale_tensor(x_scale, acc.device)
    if bias is not None:
        y = fma_f32(y, last, bias) if last is not None else y + bias
    elif last is not None:
        y = y * last
    y = apply_activation(y, activation)
    if lo is not None:
        y = torch.minimum(torch.maximum(y, lo), hi)
    if out_dtype == torch.int8:
        return requantize(y, out_scale)
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
    "wgmma_w8" or "wgmma_bf16" plan that splits K into ``split`` slices
    (the gate of both variants on the card): each slice of
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
    ws = split_workspace(plan, M, N, x.dtype, x.device)
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
