"""The two int8 conv forms the reference runs through XLA's int8 conv
(``feathercnn_tpu/kernels/dispatch.py:221-253``) that the port's
dispatcher used to refuse, now on the GEMM kernels (their plain versions on
the CPU), against the JAX engine:

- a non-square stride: a 3x3 conv at (1, 2), (2, 1) and (2, 3) on
  ``conv2d_implicit_gemm``'s (sh, sw), a 1x1 one at (2, 1) on
  ``matmul_epilogue`` (its input strided per axis);
- a group = C conv that is not plain depthwise: a channel multiplier of 2
  (the block-diagonal weight), a depthwise conv at stride 3 and one with
  ``act_segments`` (ReLU on half of the channels, none on the rest; as
  the lo/hi clamp), both as super-groups of 32 channels.

Each case is one conv between a float stem and an int8 1x1 head in a
small graph, calibrated once; every int8 edge equals the reference's
(``backend="pallas", interpret=True``), node by node and end to end
(0 LSB).  Few test items per file: see tests/test_torch_kernels.py.
"""

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import conv, dispatch
from feathercnn_tpu_torch.kernels.matmul import gemm_plan, supergroup
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _hold_int8_edges

SIZE = 15


def _case_graph(name, c, co, kernel, stride=(1, 1), group=1, pad=1,
                segments=None):
    """data -> stem (3x3 float conv to ``c`` channels, ReLU) -> the case
    conv -> an int8 1x1 head, so that the case conv reads and emits int8."""
    b = JBuilder(name, seed=len(name) + c)
    x = b.input("data", (2, SIZE, SIZE, 3))
    x = b.conv("stem", x, c, 3, pad=1, relu=True)
    y = b.conv("case", x, co, kernel, pad=pad, group=group,
               relu=segments is None)
    y = b.conv("head", y, 8, 1)
    g = b.finish([y])
    node = g.node_map()["case"]
    node.attrs.update(stride_h=stride[0], stride_w=stride[1])
    node.attrs.pop("stride", None)
    if segments is not None:
        node.attrs["act_segments"] = segments
    return g


def _held(g, seed):
    """Calibrate ``g``, run both engines and hold every int8 edge (the
    case conv's input and output among them); returns the calls of the
    port's two GEMM wrappers as (kernel, stride, groups)."""
    rng = np.random.default_rng(seed)
    jcalibrate(g, [rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(quant="w8a8", compute_dtype="bfloat16")
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", **kw), device="cpu")
    calls = []
    orig = {k: getattr(dispatch, k)
            for k in ("conv2d_implicit_gemm", "matmul_epilogue")}

    def spy(kernel):
        def run(*a, **k):
            calls.append((kernel, k.get("stride"), k.get("groups", 1)))
            return orig[kernel](*a, **k)
        return run

    for k in orig:
        setattr(dispatch, k, spy(k))
    try:
        _, _, ref, _ = _hold_int8_edges(g.name, jeng, teng, x)
    finally:
        for k, fn in orig.items():
            setattr(dispatch, k, fn)
    case = teng.graph.node_map()["case"]
    assert ref[case.inputs[0]].dtype == np.int8
    assert ref[case.outputs[0]].dtype == np.int8
    return calls


def test_non_square_strides_match_the_reference():
    """3x3 at (1, 2), (2, 1), (2, 3) and 1x1 at (2, 1): the 3x3 ones on
    ``conv2d_implicit_gemm`` with their (sh, sw), the 1x1 one on
    ``matmul_epilogue``; int8 edges equal to the JAX engine's."""
    for i, stride in enumerate(((1, 2), (2, 1), (2, 3))):
        calls = _held(_case_graph(f"s{stride[0]}{stride[1]}", 16, 16, 3,
                                  stride), i)
        assert ("conv2d_implicit_gemm", stride, 1) in calls, calls
    calls = _held(_case_graph("pw21", 32, 16, 1, (2, 1), pad=0), 5)
    assert calls and all(c[0] == "matmul_epilogue" for c in calls), calls


def test_group_c_convs_match_the_reference():
    """group = C, not plain depthwise: a channel multiplier of 2 on the
    block-diagonal weight, a depthwise conv at stride 3 and one with
    ``act_segments`` as super-groups (q = 32 groups of one channel);
    int8 edges equal to the JAX engine's."""
    calls = _held(_case_graph("mult2", 16, 32, 3, group=16), 11)
    assert ("conv2d_implicit_gemm", 1, 16) in calls, calls
    assert supergroup(16, 32, 16)[0] == 0
    calls = _held(_case_graph("dw_s3", 32, 32, 3, (3, 3), group=32), 12)
    assert ("conv2d_implicit_gemm", 3, 32) in calls, calls
    assert supergroup(32, 32, 32, (3, 3), 3)[0] == 32
    segs = (("relu", 16), (None, 16))
    calls = _held(_case_graph("dw_segs", 32, 32, 3, group=32,
                              segments=segs), 13)
    assert ("conv2d_implicit_gemm", 1, 32) in calls, calls


def test_plain_version_takes_a_stride_pair():
    """``conv2d_implicit_gemm`` on CPU tensors at (sh, sw) = (1, 2), (2, 1)
    and (2, 3): the int32 sums of ``F.conv2d(stride=(sh, sw))`` in f64
    through the epilogue; a square pair is the int stride."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (2, 13, 17, 16), dtype=torch.int8,
                      generator=gen)
    w = torch.randint(-127, 128, (3, 3, 16, 24), dtype=torch.int8,
                      generator=gen)
    ws = torch.rand(24, generator=gen) * 1e-3
    for stride in ((1, 2), (2, 1), (2, 3), (2, 2)):
        y = conv.conv2d_implicit_gemm(x, w, None, ws, stride=stride,
                                      pad_h=1, pad_w=1,
                                      out_dtype=torch.int8, out_scale=0.5)
        acc = torch.nn.functional.conv2d(
            x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
            stride=stride, padding=1).permute(0, 2, 3, 1).float()
        want = torch.clamp(torch.round(acc * ws * 0.5), -127, 127)
        assert torch.equal(y, want.to(torch.int8)), stride
    assert torch.equal(y, conv.conv2d_implicit_gemm(
        x, w, None, ws, stride=2, pad_h=1, pad_w=1, out_dtype=torch.int8,
        out_scale=0.5))


def test_plans_of_the_new_forms():
    """The host plans of the new launches: an int8 conv at a non-square
    stride takes "wgmma" (the gather strides each axis); a weight-only one
    the cp.async gather (no TMA rectangles, which assume stride 1); a
    grouped conv at a non-square stride keeps its block-diagonal weight
    (the super-group kernel's halo is square), at stride 3 the super-group
    route."""
    i8 = torch.int8
    for stride in ((1, 2), (2, 1), (2, 3)):
        p = gemm_plan(128 * 56 * 28, 576, 64, i8, i8, i8, conv_c=64,
                      conv_out=(128, 56, 28), stride=stride)
        assert p.variant == "wgmma", (stride, p)
        p = gemm_plan(128 * 56 * 28, 576, 64, torch.bfloat16, i8,
                      torch.bfloat16, conv_c=64, conv_out=(128, 56, 28),
                      stride=stride)
        assert p.variant == "wgmma_w8" and p.th == p.tw == 0, (stride, p)
    q, why = supergroup(64, 64, 64, (3, 3), (1, 2))
    assert q == 0 and "stride" in why
    p = gemm_plan(128 * 112 * 56, 9 * 64, 64, i8, i8, i8, conv_c=64,
                  conv_out=(128, 112, 56), stride=(1, 2), group=64,
                  conv_s=64, kernel=(3, 3))
    assert p.variant == "wgmma" and "block-diagonal" in p.reason, p
    p = gemm_plan(128 * 38 * 38, 9 * 32, 64, i8, i8, i8, conv_c=64,
                  conv_out=(128, 38, 38), stride=3, group=64, conv_s=32,
                  kernel=(3, 3))
    assert p.variant == "wgmma_halo", p
