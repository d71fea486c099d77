"""Winograd F(6x6,3x3) convolution — the "winograd" algo of the dispatcher.

Counterpart of ``feathercnn_tpu/kernels/winograd.py``.  The reference
computes it in plain jnp, outside any Pallas kernel, so the port computes
it in plain PyTorch ops (no hand kernel), in the reference's steps:

  - 8x8 input tiles at stride 6, the input transform ``B^T d B`` in f32;
  - 64 per-position GEMMs (one ``torch.bmm``, batch 64) over operands in
    the compute dtype, with f32 products, f32 sums and an f32 result: a
    bf16 operand is rounded to bf16 and held in f32, so the product of two
    of them is exact, as ``preferred_element_type=float32`` gives it in
    the reference;
  - the output transform ``A^T m A`` in f32, then bias and activation.

F(6,3)'s transform magnitudes force f32 transforms even for bf16
activations.  A weight-only int8 weight is dequantized before the weight
transform (exact: the transform is linear).  The weight transform
``G g G^T`` runs once per weight (``transform_weights``, in f32 as the
reference's); the dispatcher keeps it per graph node, with the input and
output transform matrices on the device (``transform_matrices``), and
calls ``winograd_conv2d_transformed``.

The card's and the CPU's f32 sums differ in order, so a bf16 rounding of
a transformed tile or of an output may fall the other way on each, and
F(6,3) carries such a step into many outputs: over VGG-16's 13 convs the
card's probabilities drift from the CPU's (``tools/winograd_probe.py``
measures it, with the input transform summed in f64 and the weight
transform made on the CPU for comparison: neither removes the drift).

On the GPU the matrix products run through cuBLAS on f32 operands.  They
follow ``torch.backends.cuda.matmul.allow_tf32`` (off by default), as the
port's float convs follow cuDNN's flag: with TF32 on, an f32 x would lose
precision in the GEMMs (a bf16-valued operand is exact in TF32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import apply_activation

__all__ = ["winograd_conv2d", "winograd_conv2d_transformed",
           "transform_weights", "transform_matrices", "BT", "G", "AT"]

# F(6x6, 3x3) transform matrices, interpolation points {0, ±1, ±2, ±1/2, ∞}
# (Lavin & Gray convention), the reference's.
BT = np.array([
    [1, 0, -21 / 4, 0, 21 / 4, 0, -1, 0],
    [0, 1, 1, -17 / 4, -17 / 4, 1, 1, 0],
    [0, -1, 1, 17 / 4, -17 / 4, -1, 1, 0],
    [0, 1 / 2, 1 / 4, -5 / 2, -5 / 4, 2, 1, 0],
    [0, -1 / 2, 1 / 4, 5 / 2, -5 / 4, -2, 1, 0],
    [0, 2, 4, -5 / 2, -5, 1 / 2, 1, 0],
    [0, -2, 4, 5 / 2, -5, -1 / 2, 1, 0],
    [0, -1, 0, 21 / 4, 0, -21 / 4, 0, 1],
], dtype=np.float64)

G = np.array([
    [1, 0, 0],
    [-2 / 9, -2 / 9, -2 / 9],
    [-2 / 9, 2 / 9, -2 / 9],
    [1 / 90, 1 / 45, 2 / 45],
    [1 / 90, -1 / 45, 2 / 45],
    [32 / 45, 16 / 45, 8 / 45],
    [32 / 45, -16 / 45, 8 / 45],
    [0, 0, 1],
], dtype=np.float64)

AT = np.array([
    [1, 1, 1, 1, 1, 1, 1, 0],
    [0, 1, -1, 2, -2, 1 / 2, -1 / 2, 0],
    [0, 1, 1, 4, 4, 1 / 4, 1 / 4, 0],
    [0, 1, -1, 8, -8, 1 / 8, -1 / 8, 0],
    [0, 1, 1, 16, 16, 1 / 16, 1 / 16, 0],
    [0, 1, -1, 32, -32, 1 / 32, -1 / 32, 1],
], dtype=np.float64)

_M = 6   # output tile
_A = 8   # input tile (m + r - 1)


def _mat(m, device) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """``G g G^T``: (3, 3, C, Co) -> (64, C, Co), f32."""
    g = _mat(G, w.device)
    t = torch.einsum("ai,ijco->ajco", g, w.float())
    v = torch.einsum("bj,ajco->abco", g, t)
    return v.reshape(_A * _A, w.shape[2], w.shape[3])


def transform_matrices(device) -> tuple:
    """``(B^T, A^T)`` as f32 tensors on ``device``, for a caller that keeps
    them (the input and output transforms of every call)."""
    return _mat(BT, device), _mat(AT, device)


def _tiles(x: torch.Tensor, pad_h: int, pad_w: int, bt: torch.Tensor):
    """The input transform: ``B^T d B`` of the 8x8 tiles at stride 6 of the
    padded x, in f32 (64, tiles, C), and the output grid (OH, OW, tile
    rows, tile columns)."""
    n, h, wd, c = x.shape
    oh, ow = h + 2 * pad_h - 2, wd + 2 * pad_w - 2
    nth, ntw = -(-oh // _M), -(-ow // _M)
    hp, wp = nth * _M + 2, ntw * _M + 2
    xp = F.pad(x.float(), (0, 0, pad_w, wp - wd - pad_w, pad_h,
                           hp - h - pad_h))
    # the 8x8 tiles at stride 6: d[n, th, tw, c, a, b] = xp[n, 6th+a, 6tw+b, c]
    d = xp.unfold(1, _A, _M).unfold(2, _A, _M)
    t = torch.einsum("ai,ntwcib->antwcb", bt, d)
    del xp, d
    u = torch.einsum("bj,antwcj->abntwc", bt, t)
    return u.reshape(_A * _A, n * nth * ntw, c), (oh, ow, nth, ntw)


def _untile(m: torch.Tensor, n: int, grid, at: torch.Tensor) -> torch.Tensor:
    """The output transform ``A^T m A`` of the (64, tiles, Co) products, in
    f32, reassembled as (N, OH, OW, Co)."""
    oh, ow, nth, ntw = grid
    co = m.shape[-1]
    m = m.reshape(_A, _A, n, nth, ntw, co)
    t = torch.einsum("ai,ijntwc->ajntwc", at, m)
    del m
    y = torch.einsum("bj,ajntwc->abntwc", at, t)
    # (6, 6, N, nth, ntw, Co) -> (N, 6 nth, 6 ntw, Co), cut to the output
    y = y.permute(2, 3, 0, 4, 1, 5).reshape(n, nth * _M, ntw * _M, co)
    return y[:, :oh, :ow, :]


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    w_scale: Optional[torch.Tensor] = None,
                    pad_h: int = 1, pad_w: int = 1,
                    activation: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3x3 stride-1 conv via F(6x6,3x3).  x: (N, H, W, C) f32/bf16;
    w: (3, 3, C, Co) float, or int8 with its per-channel ``w_scale``
    (weight-only: dequantized before the transform).  Returns (N, OH, OW,
    Co) in ``out_dtype`` (default x's type)."""
    kh, kw = w.shape[0], w.shape[1]
    if (kh, kw) != (3, 3):
        raise ValueError(f"the winograd path is 3x3 only, got {kh}x{kw}")
    if w.dtype == torch.int8:
        w = w.float() * w_scale.reshape(1, 1, 1, -1)
    return winograd_conv2d_transformed(x, transform_weights(w), bias,
                                       pad_h, pad_w, activation, out_dtype)


def winograd_conv2d_transformed(x: torch.Tensor, v: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                pad_h: int = 1, pad_w: int = 1,
                                activation: Optional[str] = None,
                                out_dtype: Optional[torch.dtype] = None,
                                mats: Optional[tuple] = None
                                ) -> torch.Tensor:
    """``winograd_conv2d`` on the transformed weight ``v`` (64, C, Co) that
    ``transform_weights`` gives, for a caller that keeps it, and on
    ``mats``, ``transform_matrices`` on x's device (made here where
    None)."""
    out_dtype = out_dtype or x.dtype
    bt, at = mats if mats is not None else transform_matrices(x.device)
    u, grid = _tiles(x, pad_h, pad_w, bt)
    if x.dtype == torch.bfloat16:
        # the compute dtype's operands, held in f32: their products are exact
        u = u.to(torch.bfloat16).float()
        v = v.to(torch.bfloat16).float()
    m = torch.bmm(u, v)                            # (64, tiles, Co), f32
    del u
    y = _untile(m, x.shape[0], grid, at)
    if bias is not None:
        y = y + bias.float()
    return apply_activation(y, activation).to(out_dtype).contiguous()
