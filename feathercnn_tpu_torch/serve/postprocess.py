"""Host-side detection postprocess for the two-stage models — a copy of
``feathercnn_tpu/serve/postprocess.py``.

The reference pipeline (py-faster-rcnn test.py, R-FCN's test.py fork)
runs the final per-class decode OUTSIDE the network: apply the ROI
head's bbox deltas to the proposal boxes, clip to the image, then
per-class score threshold + greedy NMS.  The on-device graphs
(models/zoo.py faster_rcnn_vgg16 / rfcn_resnet101) emit exactly that
pipeline's inputs — cls_prob, bbox_pred, rois — and this module is the
numpy tail (runs per request on the serving host; tiny: 300 boxes).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["decode_detections", "nms"]


def _bbox_transform_inv(boxes: np.ndarray, deltas: np.ndarray
                        ) -> np.ndarray:
    """py-faster-rcnn bbox_transform_inv: apply (dx, dy, dw, dh) deltas
    to (x1, y1, x2, y2) boxes with the +1 width convention."""
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dx, dy, dw, dh = (deltas[:, 0::4], deltas[:, 1::4],
                      deltas[:, 2::4], deltas[:, 3::4])
    pcx = dx * w[:, None] + cx[:, None]
    pcy = dy * h[:, None] + cy[:, None]
    pw = np.exp(dw) * w[:, None]
    ph = np.exp(dh) * h[:, None]
    out = np.zeros_like(deltas)
    out[:, 0::4] = pcx - 0.5 * pw
    out[:, 1::4] = pcy - 0.5 * ph
    out[:, 2::4] = pcx + 0.5 * pw
    out[:, 3::4] = pcy + 0.5 * ph
    return out


def nms(boxes: np.ndarray, scores: np.ndarray,
        thresh: float) -> List[int]:
    """Greedy NMS (py-faster-rcnn nms, +1 area convention)."""
    order = np.argsort(-scores)
    area = ((boxes[:, 2] - boxes[:, 0] + 1)
            * (boxes[:, 3] - boxes[:, 1] + 1))
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        lt = np.maximum(boxes[i, :2], boxes[rest, :2])
        rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        inter = np.prod(np.maximum(rb - lt + 1, 0), axis=1)
        iou = inter / (area[i] + area[rest] - inter)
        order = rest[iou <= thresh]
    return keep


def decode_detections(cls_prob: np.ndarray, bbox_pred: np.ndarray,
                      rois: np.ndarray, im_shape,
                      score_thresh: float = 0.05,
                      nms_thresh: float = 0.3,
                      max_per_image: int = 100,
                      class_agnostic: bool = False) -> Dict[int, np.ndarray]:
    """The test.py tail: class -> (N, 5) [x1, y1, x2, y2, score] arrays.

    ``cls_prob`` (R, C) softmax scores (class 0 = background),
    ``bbox_pred`` (R, 4C) per-class deltas — or (R, 8) with
    ``class_agnostic`` (R-FCN's 2-class bg/fg form, deltas[4:8] apply
    to every class), ``rois`` (R, 5) [batch_idx, x1, y1, x2, y2],
    ``im_shape`` (height, width)."""
    cls_prob = np.asarray(cls_prob, np.float32).reshape(
        cls_prob.shape[0], -1)
    bbox_pred = np.asarray(bbox_pred, np.float32).reshape(
        bbox_pred.shape[0], -1)
    rois = np.asarray(rois, np.float32)
    # The Proposal lowering pads to post_nms_top_n with batch_idx = -1
    # rows; drop them before decoding (a padded row would otherwise
    # score as a real near-origin box).
    real = rois[:, 0] >= 0
    cls_prob, bbox_pred, rois = cls_prob[real], bbox_pred[real], rois[real]
    n_classes = cls_prob.shape[1]
    boxes = _bbox_transform_inv(rois[:, 1:5], bbox_pred)
    h, w = im_shape
    boxes[:, 0::4] = np.clip(boxes[:, 0::4], 0, w - 1)
    boxes[:, 1::4] = np.clip(boxes[:, 1::4], 0, h - 1)
    boxes[:, 2::4] = np.clip(boxes[:, 2::4], 0, w - 1)
    boxes[:, 3::4] = np.clip(boxes[:, 3::4], 0, h - 1)

    results: Dict[int, np.ndarray] = {}
    all_scores = []
    for c in range(1, n_classes):                     # skip background
        col = 1 if class_agnostic else c
        cb = boxes[:, 4 * col:4 * col + 4]
        cs = cls_prob[:, c]
        keep = cs > score_thresh
        cb, cs = cb[keep], cs[keep]
        if not len(cs):
            continue
        k = nms(cb, cs, nms_thresh)
        dets = np.concatenate([cb[k], cs[k, None]], axis=1)
        results[c] = dets
        all_scores.extend(dets[:, 4])
    if max_per_image and len(all_scores) > max_per_image:
        floor = np.sort(all_scores)[-max_per_image]
        results = {c: d[d[:, 4] >= floor] for c, d in results.items()}
        results = {c: d for c, d in results.items() if len(d)}
    return results
