"""Image preprocessing for the serving ingest path — counterpart of
``feathercnn_tpu/serve/preprocess.py``.

Bilinear resize (half-pixel centers) + per-channel normalize, with an
optional fused symmetric int8 quantize so images enter the batch queue
already in the engine's w8a8 transfer dtype.  C++ by default
(``native_csrc/preprocess.cc`` via ctypes, built at first use; a failed
build raises); ``prefer_native=False`` takes the numpy path, the same
math (the C++ path lerps in f32, the numpy path in f64).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from .. import native

__all__ = ["preprocess", "native_available"]

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)


def native_available() -> bool:
    """Whether the native library is built (``native.available``)."""
    return native.available()


def _resize_bilinear_np(img: np.ndarray, h_out: int, w_out: int
                        ) -> np.ndarray:
    h_in, w_in, _ = img.shape
    fy = np.clip((np.arange(h_out) + 0.5) * (h_in / h_out) - 0.5,
                 0, h_in - 1)
    fx = np.clip((np.arange(w_out) + 0.5) * (w_in / w_out) - 0.5,
                 0, w_in - 1)
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h_in - 1)
    x1 = np.minimum(x0 + 1, w_in - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] + (im[y0][:, x1] - im[y0][:, x0]) * wx
    bot = im[y1][:, x0] + (im[y1][:, x1] - im[y1][:, x0]) * wx
    return top + (bot - top) * wy


def preprocess(img: np.ndarray, size: Sequence[int],
               mean: Sequence[float] = (0.0, 0.0, 0.0),
               std: Sequence[float] = (1.0, 1.0, 1.0),
               quant_scale: Optional[float] = None,
               prefer_native: bool = True) -> np.ndarray:
    """uint8 HWC image -> (H,W,C) float32 (or int8 when ``quant_scale``).

    ``out = (resize(img)/255 - mean) / std`` then optionally
    ``clip(round(out / quant_scale))`` to int8.
    """
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError("expected HWC uint8 image")
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in, c = img.shape
    mean_a = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    if mean_a.size != c or inv_std.size != c:
        raise ValueError("mean/std must have one entry per channel")
    img = np.ascontiguousarray(img)

    if prefer_native:
        lib = native.load_library()
        src = img.ctypes.data_as(_U8P)
        mean_p, inv_p = mean_a.ctypes.data_as(_F32P), inv_std.ctypes.data_as(
            _F32P)
        if quant_scale is not None:
            out = np.empty((h_out, w_out, c), np.int8)
            lib.fcnn_preprocess_i8(src, h_in, w_in, c,
                                   out.ctypes.data_as(_I8P), h_out, w_out,
                                   mean_p, inv_p,
                                   ctypes.c_float(1.0 / float(quant_scale)))
            return out
        out = np.empty((h_out, w_out, c), np.float32)
        lib.fcnn_preprocess_f32(src, h_in, w_in, c, out.ctypes.data_as(_F32P),
                                h_out, w_out, mean_p, inv_p)
        return out

    x = _resize_bilinear_np(img, h_out, w_out) / np.float32(255.0)
    x = (x - mean_a) * inv_std
    if quant_scale is not None:
        return np.clip(np.round(x / np.float32(quant_scale)),
                       -127, 127).astype(np.int8)
    return x.astype(np.float32)
