"""The PyTorch port's depthwise kernels against the JAX package, on the CPU.

On the CPU the port's wrappers (``feathercnn_tpu_torch.kernels.depthwise``)
take their plain PyTorch versions.  The float variant is held against the
Pallas kernel ``feathercnn_tpu.kernels.depthwise.depthwise_conv2d`` in
interpret mode, the int8 variant against the reference's "xla" int8 branch
(XLA's int8 grouped conv and its epilogue), alone and inside a small
MobileNet-like graph through both engines.  Every input is made from a seed
with numpy.

Tolerance: equality, for every output type.
- float variant: the reference's kernel body, compiled on the CPU, contracts
  each tap's multiply and add into one FMA (with a separate product and
  sum, about a third of the f32 outputs of these cases differ in their
  last bit).  The kernel accumulates with one ``__fmaf_rn`` per tap in the
  same order (kh outer, kw inner, from 0), the plain version with an exact
  FMA (``fma_f32``), and the bias add and the output rounding are single
  IEEE operations on both sides.  So f32 and bf16 outputs are equal, not
  merely within 1 ulp.
- int8 variant: both accumulate the int8 products exactly and apply the
  same f32 epilogue (one FMA for ``acc * w_scale + bias``, as XLA contracts
  it), so int8 outputs are equal (0 LSB) and float outputs equal.

Each test loops over its cases and names the failing one (few test items
per file: see tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.kernels.depthwise import depthwise_conv2d as jdw
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels.depthwise import (depthwise_conv2d,
                                                    depthwise_conv2d_int8)
from feathercnn_tpu_torch.weights import graph_from_reference

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _equal(got, want, case):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (case, g.shape, w.shape)
    n = int((g != w).sum())
    assert n == 0, f"{case}: {n} of {g.size} differ, max {np.abs(g - w).max()}"


# (N, H, W, C, stride, pad, activation, bias, x type); an int8 x carries an
# x_scale and dequantizes to bfloat16 (or float32, the last case).
_FLOAT_CASES = [
    (2, 9, 11, 8, 1, 1, "relu", True, "float32"),
    (2, 9, 11, 24, 2, 1, "relu6", False, "bfloat16"),
    (1, 7, 7, 64, 2, 0, None, True, "float32"),
    (1, 8, 10, 64, 1, 0, "relu6", True, "bfloat16"),
    (2, 13, 9, 24, 2, 1, None, True, "bfloat16"),
    (1, 5, 5, 1024, 2, 1, "relu", True, "bfloat16"),
    (2, 9, 9, 24, 1, 1, "relu", True, "int8"),
    (1, 11, 11, 64, 2, 1, "relu6", True, "int8"),
    (1, 6, 7, 8, 2, 1, None, False, "int8/float32"),
]


def test_depthwise_float_matches_pallas():
    for case in _FLOAT_CASES:
        n, h, w_, c, stride, pad, act, has_bias, kind = case
        rng = np.random.default_rng(n * 1000 + h * 100 + c + stride)
        x = rng.normal(size=(n, h, w_, c)).astype(np.float32)
        w = rng.normal(size=(3, 3, c)).astype(np.float32)
        bias = rng.normal(size=(c,)).astype(np.float32) if has_bias else None
        jb = None if bias is None else jnp.asarray(bias)
        tb = None if bias is None else _t(bias)
        if kind.startswith("int8"):
            out = kind.split("/")[1] if "/" in kind else "bfloat16"
            xs = float(np.abs(x).max() / 127.0)
            xq = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
            # the reference's dispatcher dequantizes the edge first
            xj = (jnp.asarray(xq).astype(jnp.float32) * xs).astype(_JDT[out])
            want = jdw(xj, jnp.asarray(w), jb, stride=stride, pad_h=pad,
                       pad_w=pad, activation=act, interpret=True)
            got = depthwise_conv2d(_t(xq), _t(w), tb, stride=stride,
                                   pad_h=pad, pad_w=pad, activation=act,
                                   x_scale=xs, out_dtype=_TDT[out])
        else:
            out = kind
            want = jdw(jnp.asarray(x, _JDT[kind]), jnp.asarray(w), jb,
                       stride=stride, pad_h=pad, pad_w=pad, activation=act,
                       interpret=True)
            got = depthwise_conv2d(_t(x).to(_TDT[kind]), _t(w), tb,
                                   stride=stride, pad_h=pad, pad_w=pad,
                                   activation=act)
        assert got.dtype == _TDT[out], (case, got.dtype)
        _equal(got, want, f"float variant {case}")


# (N, H, W, C, stride, pad, activation, out type)
_INT8_CASES = [
    (2, 9, 11, 8, 1, 1, "relu", "int8"),
    (2, 9, 11, 24, 2, 1, "relu6", "int8"),
    (1, 7, 7, 64, 2, 0, None, "bfloat16"),
    (1, 8, 10, 64, 1, 1, "relu", "float32"),
    (1, 5, 5, 1024, 2, 1, "relu", "int8"),
]


def test_depthwise_int8_matches_xla_int8_branch():
    """The reference's "xla" int8 branch on a depthwise conv
    (feathercnn_tpu/kernels/dispatch.py:221-253): XLA's int8 grouped conv
    with int32 accumulation, one multiply by (w_scale * x_scale), + bias,
    act, requant; compiled as the engine compiles it.  The port passes the
    folded scale as w_scale."""
    for case in _INT8_CASES:
        n, h, w_, c, stride, pad, act, out = case
        rng = np.random.default_rng(n + h + c + stride)
        xq = rng.integers(-127, 128, size=(n, h, w_, c)).astype(np.int8)
        wq = rng.integers(-127, 128, size=(3, 3, 1, c)).astype(np.int8)
        ws = ((rng.random(c) + 0.5) * 1e-3).astype(np.float32)
        xs = np.float32(0.02)
        bias = rng.normal(size=(c,)).astype(np.float32)
        out_scale = np.float32(1.0 / 0.05)

        @jax.jit
        def ref(x, w, b):
            acc = jax.lax.conv_general_dilated(
                x, w, (stride, stride), ((pad, pad), (pad, pad)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=c, preferred_element_type=jnp.int32)
            y = acc.astype(jnp.float32) * (jnp.asarray(ws) * xs) + b
            if act == "relu":
                y = jnp.maximum(y, 0)
            elif act == "relu6":
                y = jnp.clip(y, 0, 6)
            if out == "int8":
                return jnp.clip(jnp.round(y * out_scale), -127, 127
                                ).astype(jnp.int8)
            return y.astype(_JDT[out])

        want = ref(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bias))
        got = depthwise_conv2d_int8(_t(xq), _t(wq), _t(bias), _t(ws * xs),
                                    stride=stride, pad_h=pad, pad_w=pad,
                                    activation=act, out_dtype=_TDT[out],
                                    out_scale=float(out_scale))
        assert got.dtype == _TDT[out], (case, got.dtype)
        _equal(got, want, f"int8 variant {case}")


def small_mobilenet(batch=2):
    """A stem, two depthwise-separable blocks (stride 1 and 2) and one with
    ReLU6, global AVE pool, FC and Softmax, at widths 16-32 on a 33x33
    input (C = 24 is not a multiple of the int8 kernel's 16-channel
    vector)."""
    b = JBuilder("small_mobilenet", seed=5)
    x = b.input("data", (batch, 33, 33, 3))

    def conv_bn(name, x, ch, k=1, stride=1, pad=0, group=1, act="relu"):
        x = b.conv(name, x, ch, k, stride, pad, group=group, bias=False)
        x = b.bn_scale(name + "_bnsc", x)
        if act == "relu":
            return b.relu(name + "/relu", x)
        return b.relu6(name + "/relu6", x) if act == "relu6" else x

    x = conv_bn("conv1", x, 16, 3, 2, 1)
    for i, (ch, stride, act) in enumerate(
            [(24, 1, "relu"), (32, 2, "relu"), (32, 1, "relu6")], start=2):
        c = b._channels[x]
        x = conv_bn(f"conv{i}/dw", x, c, 3, stride, 1, group=c, act=act)
        x = conv_bn(f"conv{i}/sep", x, ch, act=act)
    x = b.pool("pool6", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc7", x, 10)
    return b.finish([b.softmax("prob", x)])


def test_small_mobilenet_edges_equal_reference_on_both_routes():
    """The JAX engine (Pallas kernels in interpret mode) and the port on
    the CPU, w8a8, on the default route (the depthwise convs take the "xla"
    int8 branch: the int8 variant) and with every depthwise conv overridden
    to "depthwise" (the float variant, int8 in); and with int8_grouped off,
    where the override route takes a bf16 input.  Every int8 edge and every
    depthwise output is equal."""
    g = small_mobilenet()
    rng = np.random.default_rng(0)
    jcalibrate(g, [rng.normal(size=(2, 33, 33, 3)).astype(np.float32)
                   for _ in range(2)], method="max")
    x = rng.normal(size=(2, 33, 33, 3)).astype(np.float32)
    dw = [n.name for n in g.nodes if n.attrs.get("group", 1) > 1]
    assert len(dw) == 3
    override = tuple((name, "depthwise") for name in dw)
    # route, config, the int8 edges the reference's engine gives
    for route, extra, n_int8 in [
            ("default", {}, 6),
            ("override", {"algo_overrides": override}, 3),
            ("override, int8_grouped off",
             {"algo_overrides": override, "int8_grouped": False}, 0)]:
        jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                                  compute_dtype="bfloat16", interpret=True,
                                  **extra))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", quant="w8a8",
                                   compute_dtype="bfloat16", **extra),
                      device="cpu")
        names = [o for n in jeng.graph.nodes for o in n.outputs]
        want = {k: np.asarray(v.astype(jnp.float32)) if v.dtype != jnp.int8
                else np.asarray(v)
                for k, v in jeng.run(x, extract=names).items()}
        int8 = [k for k, v in want.items() if v.dtype == np.int8]
        check = sorted(set(int8) | set(dw))
        assert len(int8) == n_int8, (route, int8)
        got = teng.extract(x, check)
        for name in check:
            t = got[name]
            assert (t.dtype == torch.int8) == (want[name].dtype == np.int8), \
                (route, name, t.dtype)
            _equal(t, want[name], f"{route}: {name}")
        np.testing.assert_allclose(teng(x).float().numpy(),
                                   np.asarray(jeng(x), np.float32), rtol=0,
                                   atol=1e-6, err_msg=route)


def test_depthwise_wrappers_refuse_bad_operands():
    x = torch.zeros(1, 5, 5, 8)
    w = torch.zeros(3, 3, 8)
    xq = torch.zeros(1, 5, 5, 8, dtype=torch.int8)
    wq = torch.zeros(3, 3, 8, dtype=torch.int8)
    ws = torch.ones(8)
    bad = [
        (TypeError, lambda: depthwise_conv2d(x.double(), w)),      # type
        (TypeError, lambda: depthwise_conv2d(x, w.bfloat16())),
        (ValueError, lambda: depthwise_conv2d(xq, w)),             # no scale
        (ValueError, lambda: depthwise_conv2d(x, w, x_scale=0.1)),
        (TypeError, lambda: depthwise_conv2d(xq, w, x_scale=0.1,
                                             out_dtype=torch.int8)),
        (ValueError, lambda: depthwise_conv2d(x, torch.zeros(3, 3, 7))),
        (ValueError, lambda: depthwise_conv2d(x, w, torch.zeros(7))),
        (ValueError, lambda: depthwise_conv2d(x, w, activation="gelu")),
        (ValueError, lambda: depthwise_conv2d(x, w, pad_h=-1)),
        (ValueError, lambda: depthwise_conv2d(x[:, :1, :1], w)),   # 1x1 < 3x3
        (ValueError, lambda: depthwise_conv2d(x, w.to("meta"))),   # devices
        (TypeError, lambda: depthwise_conv2d_int8(x, wq, None, ws)),
        (TypeError, lambda: depthwise_conv2d_int8(xq, w, None, ws)),
        (ValueError, lambda: depthwise_conv2d_int8(xq, wq, None, None)),
        (ValueError, lambda: depthwise_conv2d_int8(xq, wq, None,
                                                   torch.ones(7))),
        (ValueError, lambda: depthwise_conv2d_int8(xq, wq, None, ws.double())),
        (ValueError, lambda: depthwise_conv2d_int8(xq, wq, None, ws,
                                                   activation="tanh")),
        (ValueError, lambda: depthwise_conv2d_int8(xq, wq, None,
                                                   ws.to("meta"))),
        (TypeError, lambda: depthwise_conv2d_int8(xq, wq, None, ws,
                                                  out_dtype=torch.int32)),
    ]
    for i, (exc, call) in enumerate(bad):
        with pytest.raises(exc):
            call()
        assert depthwise_conv2d.launches == 0 and \
            depthwise_conv2d_int8.launches == 0, i
