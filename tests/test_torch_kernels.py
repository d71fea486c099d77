"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers (``feathercnn_tpu_torch.kernels``) take
their plain PyTorch versions; the reference runs its Pallas kernels in
interpret mode.  Both get the same numpy inputs, made from a seed.

Each test loops over its cases and names the failing one, so this file
adds few test items: the suite's scheduler (``--dist loadfile``) orders
files by their number of tests, and a short file runs after every file of
the JAX package's, whose ``test_ssd.py`` depends on the order of the
session ``rng`` draws (ROADMAP.md, queue C).

Tolerances: int8 outputs are equal (0 LSB).  Float sums are taken in
another order by the two, so a float32 output agrees within 1e-5 relative
to the magnitude of its sum (the sum of |x*w| terms, scales and |bias|):
plain rtol would not hold where terms cancel.  A bfloat16 output agrees
within 1 bf16 ulp of the reference value plus that same f32 sum-order
bound (one rounding of an f32 sum that may differ in its last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feathercnn_tpu.kernels.conv import conv2d_implicit_gemm as jconv
from feathercnn_tpu.kernels.matmul import matmul_epilogue as jmm
from feathercnn_tpu.ops.lowering import apply_act_segments as japply_segs
from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
from feathercnn_tpu_torch.kernels.matmul import matmul_epilogue
from feathercnn_tpu_torch.numerics import (act_segment_bounds,
                                           apply_act_segments)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(_TDT[dtype]) if dtype else t


def _np(x):
    """A JAX or torch result as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _bf16_ulp(ref):
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _check(got, want, out_dtype, mag=None, case=""):
    """``mag``: the magnitude of each output's sum (see the module note);
    the float tolerances scale with it.  ``case`` names the case."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (case, g.shape, w.shape)
    if out_dtype == "int8":
        assert (g != w).sum() == 0, f"{case}: {(g != w).sum()} int8 differ"
        return
    sum_order = 1e-5 * (np.abs(w) if mag is None else mag)
    if out_dtype == "bfloat16":
        excess = np.abs(g - w) - _bf16_ulp(w) - sum_order
        assert excess.max() <= 0, f"{case}: off by > 1 ulp: {excess.max()}"
    else:
        excess = np.abs(g - w) - sum_order
        assert excess.max() <= 0, f"{case}: off by > rtol 1e-5: {excess.max()}"


def _mag_mm(x, w, ws, xs, bias):
    m = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))
    if ws is not None:
        m = m * ws * xs
    return m + np.abs(bias)


def _mag_conv(x, w, ws, xs, bias, stride, pad):
    m = F.conv2d(torch.from_numpy(np.abs(x.astype(np.float64))
                                  ).permute(0, 3, 1, 2),
                 torch.from_numpy(np.abs(w.astype(np.float64))
                                  ).permute(3, 2, 0, 1),
                 stride=stride, padding=pad).permute(0, 2, 3, 1).numpy()
    if ws is not None:
        m = m * ws * xs
    return m + np.abs(bias)


def _quant_w(w, axis=0):
    """Per-output-channel symmetric int8 (output channel = last axis)."""
    red = tuple(range(w.ndim - 1))
    ws = np.abs(w).max(axis=red) / 127.0
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    return wq, ws.astype(np.float32)


def _operands(rng, x_shape, w_shape, kind):
    """(x, w, w_scale, x_scale) numpy operands for one variant:
    "f32", "bf16", "w8" (f32 x int8 weights), "w8a8" (int8 x int8)."""
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=w_shape).astype(np.float32)
    if kind in ("f32", "bf16"):
        return x, w, None, 1.0
    wq, ws = _quant_w(w)
    if kind == "w8":
        return x, wq, ws, 1.0
    xs = float(np.abs(x).max() / 127.0)
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
    return xq, wq, ws, xs


_VARIANTS = [
    # (kind, activation, out dtype)
    ("f32", "relu", "float32"),
    ("bf16", None, "bfloat16"),
    ("w8", "relu6", "float32"),
    ("w8a8", None, "float32"),
    ("w8a8", "relu", "int8"),
    ("w8a8", None, "bfloat16"),
]


def _x_dtype(kind):
    return {"f32": "float32", "bf16": "bfloat16", "w8": "float32",
            "w8a8": "int8"}[kind]


def _w_dtype(kind):
    return {"f32": "float32", "bf16": "bfloat16"}.get(kind, "int8")


def _matmul_case(shape, variant):
    kind, act, out_dtype = variant
    M, K, N = shape
    rng = np.random.default_rng(M * 7919 + K * 31 + N)
    x, w, ws, xs = _operands(rng, (M, K), (K, N), kind)
    bias = rng.normal(size=(N,)).astype(np.float32)
    out_scale = 0.9 if out_dtype == "int8" else 1.0
    xd, wd = _x_dtype(kind), _w_dtype(kind)
    want = jmm(jnp.asarray(x, _JDT[xd]), jnp.asarray(w, _JDT[wd]),
               jnp.asarray(bias),
               w_scale=None if ws is None else jnp.asarray(ws),
               activation=act, out_dtype=_JDT[out_dtype], x_scale=xs,
               out_scale=out_scale, interpret=True)
    got = matmul_epilogue(_t(x, xd), _t(w, wd), _t(bias),
                          w_scale=None if ws is None else _t(ws),
                          activation=act, out_dtype=_TDT[out_dtype],
                          x_scale=xs, out_scale=out_scale)
    assert got.dtype == _TDT[out_dtype]
    _check(got, want, out_dtype, _mag_mm(x, w, ws, xs, bias),
           case=f"matmul {shape} {variant}")


def test_matmul_epilogue_matches_pallas():
    for shape in [(64, 64, 64), (200, 300, 170), (1, 131, 1000),
                  (257, 128, 129)]:
        for variant in _VARIANTS:
            _matmul_case(shape, variant)


def test_matmul_requant_exact_vs_integer_reference():
    """int8 in, int8 out against the integer reference of
    tests/test_kernels.py, at the reference kernel's own output."""
    rng = np.random.default_rng(5)
    M, K, N = 64, 128, 64
    xq = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    ws = (rng.random(N).astype(np.float32) + 0.5) * 1e-2
    xs, os_ = 3e-2, 0.7
    want = jmm(jnp.asarray(xq), jnp.asarray(wq), w_scale=jnp.asarray(ws),
               x_scale=xs, out_dtype=jnp.int8, out_scale=os_,
               activation="relu", interpret=True)
    got = matmul_epilogue(_t(xq), _t(wq), w_scale=_t(ws), x_scale=xs,
                          out_dtype=torch.int8, out_scale=os_,
                          activation="relu")
    _check(got, want, "int8")


def _segments(n):
    a = n // 4
    return [("relu", a), (None, a), ("relu6", n - 2 * a)]


def _matmul_lohi_case(shape, out_dtype):
    """The lo/hi clamp carries the merged sibling convs.  Reference: the
    JAX package's XLA int8 branch for them (dispatch.py), int32 dot, one
    multiply by (w_scale * x_scale), + bias, apply_act_segments, requant,
    compiled as the engine compiles it.  The port passes the folded scale
    as w_scale with x_scale 1.0."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    xq, wq, ws, xs = _operands(rng, (M, K), (K, N), "w8a8")
    bias = rng.normal(size=(N,)).astype(np.float32)
    segs = _segments(N)
    out_scale = np.float32(1.0 / 0.05)
    jout = _JDT[out_dtype]

    @jax.jit
    def ref(x, w, b):
        acc = jax.lax.dot(x, w, preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * (jnp.asarray(ws) * np.float32(xs))
        y = japply_segs(y + b, segs)
        if jout == jnp.int8:
            return jnp.clip(jnp.round(y * out_scale), -127, 127
                            ).astype(jnp.int8)
        return y.astype(jout)

    want = ref(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bias))
    lo, hi = act_segment_bounds(segs)
    got = matmul_epilogue(_t(xq), _t(wq), _t(bias),
                          w_scale=_t(ws * np.float32(xs)),
                          out_dtype=_TDT[out_dtype],
                          out_scale=float(out_scale), lo=_t(lo), hi=_t(hi))
    _check(got, want, out_dtype, _mag_mm(xq, wq, ws, xs, bias),
           case=f"matmul lo/hi {shape} {out_dtype}")


def test_lohi_clamp_matches_act_segments():
    """apply_act_segments itself, then the clamp in both kernels."""
    rng = np.random.default_rng(11)
    y = (rng.normal(size=(5, 7, 48)) * 8).astype(np.float32)
    segs = [("relu", 16), (None, 8), ("relu6", 24)]
    want = np.asarray(japply_segs(jnp.asarray(y), segs))
    lo, hi = (torch.from_numpy(b) for b in act_segment_bounds(segs))
    got = apply_act_segments(_t(y), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    for shape in [(96, 64, 320), (61, 136, 40)]:
        for out_dtype in ["int8", "bfloat16"]:
            _matmul_lohi_case(shape, out_dtype)
    _conv_lohi_case()


# (N, H, W, C, Co, KH, stride, pad): the 3x3 s1 case of the main path at a
# small size, stride 2 with odd H/W and C % 16 != 0, a 7x7 s2 stem with
# C = 3, and C % 128 != 0 with Co not a multiple of the tile.
_CONV_SHAPES = [
    (2, 9, 9, 16, 16, 3, 1, 1),
    (2, 11, 7, 72, 40, 3, 2, 1),
    (1, 13, 13, 3, 24, 7, 2, 3),
    (1, 8, 10, 136, 130, 3, 1, 1),
]


def _conv_case(shape, variant):
    kind, act, out_dtype = variant
    N, H, W, C, Co, KH, stride, pad = shape
    rng = np.random.default_rng(N * 1000 + H * 100 + C + Co)
    x, w, ws, xs = _operands(rng, (N, H, W, C), (KH, KH, C, Co), kind)
    bias = rng.normal(size=(Co,)).astype(np.float32)
    out_scale = 0.5 if out_dtype == "int8" else 1.0
    xd, wd = _x_dtype(kind), _w_dtype(kind)
    want = jconv(jnp.asarray(x, _JDT[xd]), jnp.asarray(w, _JDT[wd]),
                 jnp.asarray(bias),
                 w_scale=None if ws is None else jnp.asarray(ws),
                 stride=stride, pad_h=pad, pad_w=pad, activation=act,
                 out_dtype=_JDT[out_dtype], x_scale=xs,
                 out_scale=out_scale, interpret=True)
    got = conv2d_implicit_gemm(_t(x, xd), _t(w, wd), _t(bias),
                               w_scale=None if ws is None else _t(ws),
                               stride=stride, pad_h=pad, pad_w=pad,
                               activation=act, out_dtype=_TDT[out_dtype],
                               x_scale=xs, out_scale=out_scale)
    assert got.dtype == _TDT[out_dtype]
    _check(got, want, out_dtype,
           _mag_conv(x, w, ws, xs, bias, stride, pad),
           case=f"conv {shape} {variant}")


def test_conv_implicit_gemm_matches_pallas():
    for shape in _CONV_SHAPES:
        for variant in _VARIANTS:
            _conv_case(shape, variant)


def _conv_lohi_case():
    """A 3x3 conv with per-channel segments, as the XLA int8 branch runs
    it (one folded scale, + bias, segments, requant)."""
    rng = np.random.default_rng(23)
    xq, wq, ws, xs = _operands(rng, (2, 9, 11, 32), (3, 3, 32, 48), "w8a8")
    bias = rng.normal(size=(48,)).astype(np.float32)
    segs = _segments(48)

    @jax.jit
    def ref(x, w, b):
        acc = jax.lax.conv_general_dilated(
            x, w, (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * (jnp.asarray(ws) * np.float32(xs))
        y = japply_segs(y + b, segs)
        return jnp.clip(jnp.round(y * 4.0), -127, 127).astype(jnp.int8)

    want = ref(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bias))
    lo, hi = act_segment_bounds(segs)
    got = conv2d_implicit_gemm(_t(xq), _t(wq), _t(bias),
                               w_scale=_t(ws * np.float32(xs)), stride=2,
                               pad_h=1, pad_w=1, out_dtype=torch.int8,
                               out_scale=4.0, lo=_t(lo), hi=_t(hi))
    _check(got, want, "int8", case="conv lo/hi")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        matmul_epilogue(x, torch.zeros(8, 3))            # int8 x f32
    with pytest.raises(ValueError):
        matmul_epilogue(torch.zeros(4, 8), torch.zeros(7, 3))
    with pytest.raises(ValueError):
        matmul_epilogue(torch.zeros(4, 8), torch.zeros(8, 3),
                        lo=torch.zeros(3))               # lo without hi
    with pytest.raises(ValueError):
        matmul_epilogue(torch.zeros(4, 8), torch.zeros(8, 3),
                        bias=torch.zeros(4))             # wrong length
    with pytest.raises(ValueError):
        conv2d_implicit_gemm(torch.zeros(1, 4, 4, 3),
                             torch.zeros(3, 3, 2, 5))    # C mismatch
