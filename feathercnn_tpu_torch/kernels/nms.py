"""Exact greedy NMS — the detection heads' shared suppression step.

Counterpart of ``feathercnn_tpu/kernels/nms.py``, whose four forms
(``greedy_nms``, ``_fixpoint``, ``_bitpack``, ``_blocked``) are TPU
formulations of one function: box i survives iff it is a valid candidate
and no surviving box of higher rank overlaps it by IoU > ``thresh``.  The
port computes that one function in PyTorch ops, as the reference's is
plain jnp (no Pallas kernel): the suppression matrix, then fixpoint sweeps

    keep <- valid & ~any_j(sup[i, j] & keep[j])

from ``keep = valid``.  Box i's verdict is settled after i sweeps (the
greedy recurrence is triangular in rank), so the sweeps end when a sweep
changes nothing; each sweep costs one host sync, never one per box.

The IoU follows the reference's f32 op order exactly (a different order
flips boxes that sit at the threshold): ``w = max(x2 - x1 + plus_one,
0)``, ``inter = max(min(x2) - max(x1) + plus_one, 0) * (the same in y)``,
``iou = inter / max(area_i + area_j - inter, 1e-10)``, the threshold
rounded to f32.
"""

from __future__ import annotations

import torch

__all__ = ["greedy_nms"]

# rows of the suppression matrix computed at a time (bounds the (rows, K,
# 2) temporaries at Proposal's K = 6000)
_ROWS = 1024


def _suppression(boxes: torch.Tensor, thresh: float,
                plus_one: float = 0.0) -> torch.Tensor:
    """(..., K, K) bool: ``sup[..., i, j]`` iff box j ranks above box i
    (j < i: the rows are score-descending, ties by index) and their IoU
    exceeds ``thresh``."""
    f32 = torch.float32
    boxes = boxes.to(f32)
    k = boxes.shape[-2]
    one = torch.tensor(plus_one, dtype=f32, device=boxes.device)
    zero = torch.zeros((), dtype=f32, device=boxes.device)
    th = torch.tensor(thresh, dtype=f32, device=boxes.device)
    floor = torch.tensor(1e-10, dtype=f32, device=boxes.device)
    wh = torch.maximum(boxes[..., 2:] - boxes[..., :2] + one, zero)
    area = wh[..., 0] * wh[..., 1]
    col = torch.arange(k, device=boxes.device)
    out = torch.empty(boxes.shape[:-1] + (k,), dtype=torch.bool,
                      device=boxes.device)
    for r0 in range(0, k, _ROWS):
        r1 = min(r0 + _ROWS, k)
        rows = boxes[..., r0:r1, None, :]
        lt = torch.maximum(rows[..., :2], boxes[..., None, :, :2])
        rb = torch.minimum(rows[..., 2:], boxes[..., None, :, 2:])
        side = torch.maximum(rb - lt + one, zero)
        inter = side[..., 0] * side[..., 1]
        iou = inter / torch.maximum(
            area[..., r0:r1, None] + area[..., None, :] - inter, floor)
        out[..., r0:r1, :] = (iou > th) & (col[None, :] < col[r0:r1, None])
    return out


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
               plus_one: float = 0.0) -> torch.Tensor:
    """Boolean keep mask of exact greedy NMS over the last two axes.

    ``boxes``: (..., K, 4) [x1, y1, x2, y2], score-descending within each
    leading slice with ties by index (a stable descending sort: then
    position is the reference's score rank, j above i iff s_j > s_i, or
    s_j == s_i and j < i); ``valid``: (..., K) candidates; ``plus_one``:
    1.0 for the Caffe/py-faster-rcnn pixel convention (w = x2 - x1 + 1),
    0.0 for normalized coordinates."""
    sup = _suppression(boxes, thresh, plus_one)
    keep = valid.clone()
    for _ in range(boxes.shape[-2]):
        new = valid & ~(sup & keep[..., None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep
