"""The dilated int8 conv of the PyTorch port (``kernels/dispatch.py`` sends
an ungrouped int8 conv with ``dilation`` > 1 to ``conv2d_implicit_gemm``,
whose taps the dilation spaces) against the JAX package's dispatcher, which
leaves it to XLA's int8 conv (``feathercnn_tpu/kernels/dispatch.py:221-252``),
on the CPU (the wrapper takes its plain version there).

Both engines get the same calibrated graph and the same numpy inputs, made
from a seed.  The int8 edges are held equal (0 LSB), node by node and end
to end, at dilations 2, 4, 6 and 12, each with pad equal to the dilation
(the zoo's) and pad 0, at C_in 16, 32 and 64.

Few test items per file: see tests/test_torch_kernels.py.  Two torch
intra-op threads while the module runs (``_two_threads``, as
tests/test_torch_zoo_rest.py says why).
"""

import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ir import Node
from feathercnn_tpu_torch.kernels import conv, dispatch
from feathercnn_tpu_torch.ops.lowering import LoweringCtx
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _hold_int8_edges
from test_torch_zoo_rest import _two_threads  # noqa: F401

DILATIONS = (2, 4, 6, 12)


def _dilated_graph(c, size=29, batch=2):
    """A float stem to ``c`` channels, then a 3x3 int8 conv at each
    dilation with pad equal to it and with pad 0 (the latter at stride 2
    for d = 2), each read by an int8 1x1 conv (so the dilated conv emits
    an int8 edge)."""
    b = JBuilder(f"dilated{c}", seed=c)
    x = b.input("data", (batch, size, size, 3))
    x = b.conv("stem", x, c, 3, pad=1, relu=True)
    outs = []
    for d in DILATIONS:
        for pad in (d, 0):
            stride = 2 if (d == 2 and pad == 0) else 1
            y = b.conv(f"d{d}p{pad}", x, 48, 3, stride=stride, pad=pad,
                       dilation=d, relu=True)
            outs.append(b.conv(f"d{d}p{pad}_head", y, 16, 1))
    return b.finish(outs)


def test_dilated_int8_convs_match_reference_dispatcher():
    """Every dilated conv of the graph takes an int8 edge and emits one,
    runs on ``conv2d_implicit_gemm`` with its dilation, and every int8 edge
    equals the reference's, node by node and end to end, at C_in 16, 32
    and 64."""
    rng = np.random.default_rng(7)
    for c in (16, 32, 64):
        g = _dilated_graph(c)
        jcalibrate(g, [rng.normal(size=(2, 29, 29, 3)).astype(np.float32)],
                   method="max")
        x = rng.normal(size=(2, 29, 29, 3)).astype(np.float32)
        kw = dict(quant="w8a8", compute_dtype="bfloat16")
        jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", **kw), device="cpu")
        seen = []
        orig = dispatch.conv2d_implicit_gemm

        def spy(*a, **k):
            seen.append(k.get("dilation", 1))
            return orig(*a, **k)

        dispatch.conv2d_implicit_gemm = spy
        try:
            n_int8, _, ref, _ = _hold_int8_edges(f"dilated C={c}", jeng,
                                                  teng, x)
        finally:
            dispatch.conv2d_implicit_gemm = orig
        dilated = [n for n in teng.graph.nodes
                   if n.attrs.get("dilation", 1) > 1]
        assert len(dilated) == 2 * len(DILATIONS)
        for n in dilated:
            assert ref[n.inputs[0]].dtype == np.int8, n.name
            assert ref[n.outputs[0]].dtype == np.int8, n.name
        # every dilated conv went through the kernel's wrapper with its
        # dilation, in the forwards of _hold_int8_edges
        assert sorted(set(seen) - {1}) == list(DILATIONS), seen


def test_plain_version_is_pytorchs_dilated_conv():
    """``conv2d_implicit_gemm`` on CPU tensors (its plain version) at each
    dilation, pad d and 0, stride 1 and 2: the int32 sums of
    ``F.conv2d(dilation=d)`` in f64 through the same epilogue; int8 out
    equal to a requantization of those sums done here."""
    gen = torch.Generator().manual_seed(3)
    for d in DILATIONS:
        for pad in (d, 0):
            for stride in (1, 2):
                x = torch.randint(-127, 128, (2, 31, 27, 16),
                                  dtype=torch.int8, generator=gen)
                w = torch.randint(-127, 128, (3, 3, 16, 24),
                                  dtype=torch.int8, generator=gen)
                ws = torch.rand(24, generator=gen) * 1e-3
                y = conv.conv2d_implicit_gemm(x, w, None, ws, stride=stride,
                                              pad_h=pad, pad_w=pad,
                                              out_dtype=torch.int8,
                                              out_scale=0.5, dilation=d)
                acc = torch.nn.functional.conv2d(
                    x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1), stride=stride,
                    padding=pad, dilation=d).permute(0, 2, 3, 1).float()
                want = torch.clamp(torch.round(acc * ws * 0.5), -127, 127)
                assert torch.equal(y, want.to(torch.int8)), (d, pad, stride)


def test_dispatcher_still_refuses_what_no_model_has():
    """No int8 conv form that the reference's XLA int8 conv runs is
    refused any more: an ungrouped dilated conv, a conv at a non-square
    stride and a group = C conv with a channel multiplier > 1 all run on
    the implicit-GEMM kernel, each equal to the float64 grouped conv of
    the same int8 grids times the folded scale."""
    from feathercnn_tpu_torch.ir import Graph, TensorSpec
    g = Graph(name="g", inputs={"x": TensorSpec((1, 9, 9, 16))},
              outputs=[], nodes=[], params={}, meta={})
    q = {"x_scale": 0.1, "w_scale": np.full(16, 0.01, np.float32),
         "y_scale": 0.2}
    ctx = LoweringCtx(g, EngineConfig(backend="cuda"), torch.device("cpu"))
    ctx.qinfo = lambda node: q
    x = torch.randint(-127, 128, (1, 9, 9, 16), dtype=torch.int8)

    def run(**attrs):
        group = attrs.get("group", 1)
        co = attrs.pop("co", 16)
        w = torch.randint(-127, 128, (3, 3, 16 // group, co),
                          dtype=torch.int8)
        node = Node("c", "Convolution", ["x"], ["c"],
                    dict({"num_output": co, "kernel_size": 3, "pad": 2,
                          "bias_term": False}, **attrs))
        return dispatch.conv_forward(node, x, w, None, ctx)

    assert run(dilation=2).shape == (1, 9, 9, 16)

    def held(**attrs):
        torch.manual_seed(3)
        group = attrs.get("group", 1)
        co = attrs.get("co", 16)
        w = torch.randint(-127, 128, (3, 3, 16 // group, co),
                          dtype=torch.int8)
        torch.manual_seed(3)
        ctx._consts.clear()         # node "c"'s weight, laid out per run
        q["w_scale"] = np.full(co, 0.01, np.float32)
        got = run(**attrs)
        sh, sw = attrs.get("stride_h", 1), attrs.get("stride_w", 1)
        acc = torch.nn.functional.conv2d(
            x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
            stride=(sh, sw), padding=2, groups=group)
        ws = torch.from_numpy(q["w_scale"] * np.float32(q["x_scale"]))
        want = (acc.permute(0, 2, 3, 1).float() * ws).to(torch.bfloat16)
        assert torch.equal(got, want), attrs

    held(stride_h=1, stride_w=2)
    held(stride_h=2, stride_w=3)
    held(group=16, co=32)
