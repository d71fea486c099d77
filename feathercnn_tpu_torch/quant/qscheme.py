"""Quantization schemes — a copy of ``feathercnn_tpu/quant/qscheme.py``:
per-output-channel symmetric int8 weights, per-tensor activation scales.
The dequantization is folded into the kernels' epilogue
(kernels/matmul.py, kernels/conv.py) rather than materialized.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["quantize_weight_per_channel", "quantize_tensor_scale"]

_EPS = 1e-12


def quantize_weight_per_channel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8.  The output-channel axis is the
    trailing axis for every weight layout in this IR (HWIO conv, (in,out)
    FC).  Returns (int8 weights, f32 scales[Cout])."""
    flat = np.abs(w.reshape(-1, w.shape[-1]))
    scale = flat.max(axis=0) / 127.0
    scale = np.maximum(scale, _EPS).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_tensor_scale(amax: float) -> float:
    """Per-tensor symmetric activation scale from a calibrated abs-max."""
    return max(float(amax), _EPS) / 127.0
