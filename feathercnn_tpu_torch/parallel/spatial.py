"""Spatial partitioning with halo exchange — counterpart of
``feathercnn_tpu/parallel/spatial.py``: a feature map's H split over the
ranks of a group, each conv preceded by an exchange of the boundary rows
its window reads across the split (neighbour-only traffic, the CNN analog
of ring context parallelism).  Per rank, with a process group in place of
the reference's ``(mesh, axis)``: ``x`` is this rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..numerics import apply_activation, nchw_conv
from .dist import start_exchange

__all__ = ["halo_exchange", "spatial_conv2d"]


def halo_exchange(x: torch.Tensor, group, halo_lo: int,
                  halo_hi: int) -> torch.Tensor:
    """This rank's rows (N, H_local, W, C) with ``halo_lo`` rows of the
    rank above in front and ``halo_hi`` rows of the rank below behind;
    the edge ranks get zero rows there (a conv's padding at the image's
    border).  Returns (N, halo_lo + H_local + halo_hi, W, C)."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    me = dist.get_rank(group) if n > 1 else 0
    h = x.shape[1]
    if halo_lo > h or halo_hi > h:
        raise ValueError(f"halo ({halo_lo}, {halo_hi}) rows over {h} local "
                         "rows: a halo comes from the neighbour alone")
    sends, recvs = [], []
    row = x.shape[:1] + x.shape[2:]
    if halo_lo and me < n - 1:        # my bottom rows: the top halo below
        sends.append((x[:, h - halo_lo:].contiguous(), me + 1))
    if halo_hi and me > 0:            # my top rows: the bottom halo above
        sends.append((x[:, :halo_hi].contiguous(), me - 1))
    if halo_lo and me > 0:
        recvs.append(((row[0], halo_lo) + row[1:], x.dtype, x.device,
                      me - 1))
    if halo_hi and me < n - 1:
        recvs.append(((row[0], halo_hi) + row[1:], x.dtype, x.device,
                      me + 1))
    got = start_exchange(sends, recvs, group).wait() if (sends or recvs) \
        else []
    parts = []
    if halo_lo:
        parts.append(got.pop(0) if me > 0
                     else x.new_zeros((row[0], halo_lo) + row[1:]))
    parts.append(x)
    if halo_hi:
        parts.append(got.pop(0) if me < n - 1
                     else x.new_zeros((row[0], halo_hi) + row[1:]))
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def halo_rows(kh: int, stride: int, pad: int):
    """(rows from above, rows from below) a conv's output rows on one
    phase-aligned shard read beyond it."""
    return pad, max(kh - stride - pad, 0)


def spatial_conv2d(group, x, w, bias=None, stride: int = 1, pad: int = 0,
                   activation: Optional[str] = None):
    """A conv over an H-split input: halo exchange, then a local conv
    valid in H with the global pad in W.  ``x`` this rank's rows (each
    rank's H_local a multiple of ``stride``, for per-shard phase
    alignment); ``w`` HWIO whole.  Returns this rank's H_local / stride
    output rows."""
    kh = w.shape[0]
    h_local = x.shape[1]
    assert h_local % stride == 0, (
        f"spatial_conv2d: H_local {h_local} must be divisible by stride "
        f"{stride} for per-shard phase alignment")
    lo, hi = halo_rows(kh, stride, pad)
    xh = halo_exchange(x, group, lo, hi)
    y = nchw_conv(xh.float(), w.float(), stride, (0, pad)).to(x.dtype)
    # when stride + pad > KH the bottom halo cannot go negative and the
    # valid conv may give one extra row: crop to the shard's own rows
    y = y[:, :h_local // stride]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)
