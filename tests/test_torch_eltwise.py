"""The port's int8-edge Eltwise (``kernels/eltwise.py``) against the JAX
package's, on the CPU.

The reference's int8 Eltwise is plain jnp inside its lowering
(``feathercnn_tpu/ops/lowering.py:1837-1851``); it runs here through that
lowering under ``jax.jit``, as its engine compiles it (XLA contracts the
first dequantizing product into the add).  On the CPU the port's wrapper
``eltwise_int8`` takes ``eltwise_int8_plain``.  Both get the same numpy
inputs, made from a seed.  Tolerance: int8 outputs equal (0 LSB), on
random values, on quotients that land on .5 (rounded half to even) and on
sums that saturate at +-127, for every activation.

Few test items per file: see tests/test_torch_kernels.py.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.ir import Node as JNode
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.ops import lowering as jlowering
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ir import Node
from feathercnn_tpu_torch.kernels import dispatch as kdispatch
from feathercnn_tpu_torch.kernels.eltwise import (eltwise_int8,
                                                  eltwise_int8_plain,
                                                  eltwise_int8_sum,
                                                  kernel_operands,
                                                  takes_kernel)
from feathercnn_tpu_torch.numerics import reciprocal
from feathercnn_tpu_torch.ops.lowering import LoweringCtx, lower_node
from feathercnn_tpu_torch.weights import graph_from_reference

# (s0, s1, y_scale): calibration-like scales (amax / 127); quotients on .5
# ((x0 + x1) / 2, and 0.5 x0 + 1.5 x1); sums far past the grid; a range
# around relu6's 6
SCALES = ((2.71 / 127, 4.05 / 127, 5.32 / 127), (0.5, 0.5, 1.0),
          (0.25, 0.75, 0.5), (1.0, 1.0, 0.25), (0.05, 0.05, 0.05))
ACTS = (None, "relu", "relu6")


def _reference(a, b, s0, s1, y, act):
    """The JAX lowering's int8 Eltwise, compiled, on numpy int8 a and b."""
    attrs = {"operation": "SUM", **({"activation": act} if act else {})}
    node = JNode("e", "Eltwise", ["a", "b"], ["e"], attrs)
    q = {"eltwise_int8": True, "in_scales": [s0, s1], "y_scale": y}
    ctx = SimpleNamespace(qinfo=lambda n: q)
    fn = jax.jit(lambda u, v: jlowering.lower_node(node, [u, v], [], ctx)[0])
    return np.asarray(fn(a, b))


def test_plain_equals_the_reference_int8_eltwise():
    """``eltwise_int8_plain`` and the wrapper on CPU tensors give the
    reference's int8 output bit for bit, at every scale triple and
    activation, on an NHWC shape and an odd one; the .5 and saturating
    triples do hit ties and the clamp."""
    rng = np.random.default_rng(0)
    ties = clamped = 0
    for shape in ((2, 5, 7, 48), (3, 3, 3, 5)):
        a = rng.integers(-128, 128, size=shape, dtype=np.int8)
        b = rng.integers(-128, 128, size=shape, dtype=np.int8)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        for s0, s1, y in SCALES:
            acc = (np.float64(s0) * a + np.float64(s1) * b) / y
            ties += int((np.abs(acc - np.trunc(acc)) == 0.5).sum())
            clamped += int((np.abs(acc) > 127.5).sum())
            for act in ACTS:
                want = _reference(a, b, s0, s1, y, act)
                for fn in (eltwise_int8_plain, eltwise_int8):
                    got = fn(ta, tb, s0, s1, reciprocal(y), act)
                    assert got.dtype == torch.int8
                    diff = int((got.numpy() != want).sum())
                    assert diff == 0, (fn.__name__, shape, (s0, s1, y), act,
                                       diff)
    assert ties > 1000 and clamped > 1000, (ties, clamped)


def _ctx(backend, q):
    graph = SimpleNamespace(meta={"quant": {"e": q}})
    return LoweringCtx(graph, EngineConfig(backend=backend), torch.device(
        "cpu"))


def test_route_kernel_or_fallback(monkeypatch):
    """``takes_kernel`` decides without launching: two int8 operands of one
    shape, in any layout, and nothing else.  ``kernel_operands`` hands the
    kernel each operand as it is where it reads it so (contiguous, or rows
    of a multiple of 16 channels at a pitch of 16-byte multiples: a merged
    sibling conv's channel slice) and a contiguous copy of any other (a
    misaligned view, a row shard, a slice of 24 channels), equal in value.
    The lowering follows ``takes_kernel`` on the "cuda" backend (the wrapper
    called, or the PyTorch ops and one count in ``eltwise_int8.fallbacks``)
    and never on the "torch" backend (the float oracle: PyTorch's ops);
    every route gives ``eltwise_int8_sum``'s output.  The wrapper refuses
    what has no kernel."""
    gen = torch.Generator().manual_seed(1)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, generator=gen)

    shape = (2, 5, 7, 48)
    a, b, wide = i8(*shape), i8(*shape), i8(2, 5, 7, 80)
    misaligned = i8(a.numel() + 1)[1:].view(shape)
    # (what, operands, kernel, (c, ld0, ld1) and which operands are copied)
    cases = (
        ("two contiguous int8", (a, b), True, (0, 0, 0, [])),
        ("a channel slice at pitch 80", (wide[..., 16:64], b), True,
         (48, 80, 48, [])),
        ("two slices", (wide[..., 32:], wide[..., :48]), True,
         (48, 80, 80, [])),
        ("a row shard of a batch", (i8(2, 9, 7, 48)[:, 2:7], b), True,
         (0, 0, 0, [0])),
        ("a misaligned view", (misaligned, b), True, (0, 0, 0, [0])),
        ("a slice of 24 channels", (i8(2, 5, 7, 40)[..., 8:32],
                                    i8(2, 5, 7, 24)), True, (0, 0, 0, [0])),
        ("a channel slice beside a misaligned view",
         (wide[..., 16:64], misaligned), True, (48, 80, 48, [1])),
        ("a float operand", (a, b.float() * 0.3), False, None),
        ("three operands", (a, b, a), False, None),
        ("shapes that broadcast", (a, i8(2, 5, 7, 1)), False, None),
    )
    for what, xs, kernel, form in cases:
        assert takes_kernel(xs) is kernel, what
        if not kernel:
            continue
        *ys, c, ld0, ld1 = kernel_operands(*xs)
        copied = [i for i in (0, 1) if ys[i] is not xs[i]]
        assert (c, ld0, ld1, copied) == form, what
        for x, y in zip(xs, ys):
            assert torch.equal(x, y) and y.data_ptr() % 16 == 0, what
        for i in copied:
            assert ys[i].is_contiguous(), what
    calls = []
    orig = kdispatch.eltwise_int8

    def rec(*args):
        calls.append(args)
        return orig(*args)
    monkeypatch.setattr(kdispatch, "eltwise_int8", rec)
    monkeypatch.setattr(eltwise_int8, "fallbacks", 0)
    for what, xs, kernel, _ in cases:
        scales = [0.02 if x.dtype == torch.int8 else None for x in xs]
        q = {"eltwise_int8": True, "in_scales": scales, "y_scale": 0.03}
        node = Node("e", "Eltwise", ["x%d" % i for i in range(len(xs))],
                    ["e"], {"operation": "SUM", "activation": "relu"})
        want = eltwise_int8_sum(xs, scales, reciprocal(0.03), "relu")
        for backend in ("cuda", "torch"):
            n_calls, n_fall = len(calls), eltwise_int8.fallbacks
            (got,) = lower_node(node, list(xs), [], _ctx(backend, q))
            assert torch.equal(got, want), (what, backend)
            on_kernel = backend == "cuda" and kernel
            assert len(calls) - n_calls == on_kernel, (what, backend)
            assert eltwise_int8.fallbacks - n_fall == (
                backend == "cuda" and not kernel), (what, backend)
    # no fallback inside the wrapper: off the CPU it launches or raises
    with pytest.raises(ValueError, match="no kernel for device meta"):
        eltwise_int8(torch.empty(4, dtype=torch.int8, device="meta"),
                     torch.empty(4, dtype=torch.int8, device="meta"),
                     0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="int8 operands"):
        eltwise_int8(a, b.float(), 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="unknown activation"):
        eltwise_int8(a, b, 0.1, 0.1, 0.1, "tanh")


def _residual_graph(batch=2):
    """A stem, a projection bottleneck and two identity ones, the second's
    add with relu6 fused in place of relu, and a conv, at widths 16-160 on
    a 24x24 input.  Branch1 (128 wide) merges beside branch2a (32) into one
    conv of 160 (``passes.merge_sibling_convs`` splits on 128 lanes), so
    the projection block's add reads a channel slice at pitch 160."""
    b = JBuilder("residual", seed=5)
    x = b.input("data", (batch, 24, 24, 3))

    def conv_bn(name, x, ch, k, stride=1, pad=0, relu=True):
        x = b.conv(name, x, ch, k, stride, pad, bias=False)
        x = b.bn_scale("bn" + name, x)
        return b.relu(name + "_relu", x) if relu else x

    x = conv_bn("conv1", x, 16, 3, 2, 1)
    s = conv_bn("a_b1", x, 128, 1, relu=False)
    y = conv_bn("a_b2a", x, 32, 1)
    y = conv_bn("a_b2b", y, 32, 3, pad=1)
    y = conv_bn("a_b2c", y, 128, 1, relu=False)
    x = b.relu("a_relu", b.eltwise("a", [s, y]))
    for blk, act in (("b", b.relu), ("c", b.relu6)):
        y = conv_bn(f"{blk}_b2a", x, 32, 1)
        y = conv_bn(f"{blk}_b2b", y, 32, 3, pad=1)
        y = conv_bn(f"{blk}_b2c", y, 128, 1, relu=False)
        x = act(f"{blk}_act", b.eltwise(blk, [x, y]))
    # a conv after the last add reads it as an int8 edge (a float reader,
    # the pool, would keep every add before it float)
    x = conv_bn("d", x, 32, 1)
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc", x, 10)
    return b.finish([b.softmax("prob", x)])


def test_residual_block_int8_edges_unchanged(monkeypatch):
    """Three residual adds of a small ResNet under w8a8, the port on the
    CPU against the JAX engine: every int8 edge equal, each add taking the
    kernel's route (the projection block's on its merged channel slice)
    with no fallback, and each add's output equal to the PyTorch ops it
    took before (``eltwise_int8_sum``) on the same inputs."""
    g = _residual_graph()
    rng = np.random.default_rng(2)
    jcalibrate(g, [rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
                   for _ in range(2)], method="max")
    x = rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
    jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8", interpret=True))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", quant="w8a8"), device="cpu")
    adds = [n for n in teng.graph.nodes if n.op == "Eltwise"]
    q = teng.graph.meta["quant"]
    assert [n.name for n in adds] == ["a", "b", "c"]
    assert all(q[n.name].get("eltwise_int8") for n in adds)
    assert [n.attrs.get("activation") for n in adds] == ["relu", "relu",
                                                         "relu6"]
    calls = []
    orig = kdispatch.eltwise_int8

    def rec(*args):
        calls.append(args)
        return orig(*args)
    monkeypatch.setattr(kdispatch, "eltwise_int8", rec)
    monkeypatch.setattr(eltwise_int8, "fallbacks", 0)
    names = [o for n in jeng.graph.nodes for o in n.outputs]
    want = {k: np.asarray(v) for k, v in jeng.run(x, extract=names).items()
            if np.asarray(v).dtype == np.int8}
    assert {n.name for n in adds} <= set(want)
    got = teng.extract(x, sorted(want))
    assert len(calls) == len(adds) and eltwise_int8.fallbacks == 0
    assert calls[0][0].stride()[-2] == 160      # the merged channel slice
    for name, ref in want.items():
        diff = int((got[name].numpy().astype(np.int32) != ref).sum())
        assert diff == 0, f"{name}: {diff} of {ref.size} int8 values differ"
    for n, (x0, x1, s0, s1, inv, act) in zip(adds, calls):
        assert torch.equal(got[n.name], eltwise_int8_sum(
            (x0, x1), q[n.name]["in_scales"],
            reciprocal(q[n.name]["y_scale"]), act))
        assert (s0, s1, inv) == (*q[n.name]["in_scales"],
                                 reciprocal(q[n.name]["y_scale"]))
