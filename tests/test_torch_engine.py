"""The PyTorch port's engine against the JAX package's, on the CPU.

Both engines get the same graph (built with the JAX zoo or builder, carried
across with ``graph_from_reference``), the same calibrated scales and the
same numpy inputs, made from a seed.  The port runs on the CPU, where its
kernel wrappers take their plain versions.

Tolerances, with their reasons:

- int8 edges are equal: both accumulate the int8 products exactly and apply
  the same f32 epilogue in the same order.
- float32 outputs agree within rtol 1e-4 of the output's largest magnitude:
  the two frameworks sum convolutions in different orders.
- the full-int8 ResNet-50 holds top-1 equal and the prob cosine >= 0.999:
  a last-bit difference in a float edge (the stem runs in bf16 on float
  activations) may move an int8 value by one step downstream.

Each test covers several cases, so the file adds few test items (see
tests/test_torch_kernels.py for why).
"""

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models import resnet50 as jresnet50
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.models import resnet50
from feathercnn_tpu_torch.quant import calibrate
from feathercnn_tpu_torch.weights import graph_from_reference


def small_graph(batch=2):
    """Stem, ceil-mode MAX pool, one projection and one identity
    bottleneck, global AVE pool, FC and Softmax, at widths 16-64 on a
    33x33 input (the pool's ceil mode adds a row and a column)."""
    b = JBuilder("small", seed=3)
    x = b.input("data", (batch, 33, 33, 3))

    def conv_bn(name, x, ch, k, stride=1, pad=0, relu=True):
        x = b.conv(name, x, ch, k, stride, pad, bias=False)
        x = b.bn_scale("bn" + name, x)
        return b.relu(name + "_relu", x) if relu else x

    x = conv_bn("conv1", x, 16, 7, 2, 3)
    x = b.pool("pool1", x, 3, 2)
    s = conv_bn("a_b1", x, 64, 1, stride=2, relu=False)
    y = conv_bn("a_b2a", x, 16, 1, stride=2)
    y = conv_bn("a_b2b", y, 16, 3, pad=1)
    y = conv_bn("a_b2c", y, 64, 1, relu=False)
    x = b.relu("a_relu", b.eltwise("a", [s, y]))
    y = conv_bn("b_b2a", x, 32, 1)
    y = conv_bn("b_b2b", y, 32, 3, pad=1)
    y = conv_bn("b_b2c", y, 64, 1, relu=False)
    x = b.relu("b_relu", b.eltwise("b", [x, y]))
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc", x, 10)
    return b.finish([b.softmax("prob", x)])


def _inputs(seed, shape, n=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * scale).astype(np.float32)
            for _ in range(n)]


def _int8_edges(jeng, x):
    """Every value of the optimized reference graph that is int8, fetched
    with ``extract``: name -> numpy array."""
    names = [o for n in jeng.graph.nodes for o in n.outputs]
    got = jeng.run(x, extract=names)
    return {k: np.asarray(v) for k, v in got.items()
            if np.asarray(v).dtype == np.int8}


def test_small_graph_int8_edges_equal_pallas_interpret():
    g = small_graph()
    jcalibrate(g, _inputs(0, (2, 33, 33, 3), n=2), method="max")
    x = _inputs(1, (2, 33, 33, 3))[0]
    jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                              interpret=True))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", quant="w8a8"), device="cpu")
    assert [n.name for n in teng.graph.nodes] == \
        [n.name for n in jeng.graph.nodes]
    want = _int8_edges(jeng, x)
    assert len(want) >= 6, sorted(want)
    got = teng.extract(x, sorted(want))
    for name, ref in want.items():
        t = got[name]
        assert t.dtype == torch.int8, (name, t.dtype)
        diff = int((t.numpy().astype(np.int32) != ref).sum())
        assert diff == 0, f"{name}: {diff} of {ref.size} int8 values differ"
    np.testing.assert_allclose(teng(x).float().numpy(),
                               np.asarray(jeng(x), np.float32),
                               rtol=0, atol=1e-6)


def test_small_graph_float_paths_match():
    """Without quantization: the "torch" oracle against the reference's
    "xla" oracle in f32 and bf16 (the passes, pools in ceil mode, the Slice
    of the merged convs, Eltwise and Softmax); and the "cuda" backend,
    which sends the float convs to the reference's "xla" branch as its
    dispatcher does, against the "torch" backend."""
    g = small_graph()
    tg = graph_from_reference(g)
    x = _inputs(2, (2, 33, 33, 3))[0]
    for compute_dtype, atol in (("float32", 1e-6), ("bfloat16", 1e-2)):
        want = np.asarray(
            JEngine(g, JConfig(compute_dtype=compute_dtype))(x), np.float32)
        got = Engine(tg, EngineConfig(compute_dtype=compute_dtype),
                     device="cpu")(x).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=compute_dtype)
    a = Engine(tg, EngineConfig(backend="torch"), device="cpu")(x)
    b = Engine(tg, EngineConfig(backend="cuda"), device="cpu")(x)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def _fingerprint(arr):
    """tests/test_goldens.py's fingerprint of an output tensor."""
    out = np.asarray(arr, np.float32).ravel()
    v = np.random.default_rng(20260820 + out.size).standard_normal(
        out.size).astype(np.float32)
    return {"first8": [round(float(v_), 6) for v_ in out[:8]],
            "argmax": int(out.argmax()),
            "sum": round(float(out.sum()), 5),
            "proj": round(float(np.dot(out, v)), 5)}


def test_resnet50_fp32_matches_golden_and_jax():
    import json
    import os
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        ref = json.load(f)["resnet50"]["fc1000"]
    x = np.random.default_rng(42).normal(
        size=(1, 224, 224, 3)).astype(np.float32)
    got = Engine(resnet50(with_softmax=False), device="cpu")(x).numpy()
    fp = _fingerprint(got)
    # the tolerances of tests/test_goldens.py
    assert fp["argmax"] == ref["argmax"]
    np.testing.assert_allclose(fp["first8"], ref["first8"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(fp["sum"], ref["sum"], rtol=1e-4)
    np.testing.assert_allclose(
        fp["proj"], ref["proj"], rtol=1e-3,
        atol=1e-3 * (1.0 + max(abs(v) for v in fp["first8"])))
    want = np.asarray(JEngine(jresnet50(with_softmax=False))(x))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_resnet50_w8a8_matches_reference():
    """Full-width ResNet-50, full int8, 1x64x64x3, against the reference
    of the small-graph test: the JAX engine's Pallas kernels in interpret
    mode (its merged sibling convs take its XLA int8 branch)."""
    g = jresnet50(with_softmax=True)
    x = _inputs(1, (1, 64, 64, 3))[0]
    jcalibrate(g, [x], method="max")
    jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                              interpret=True))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", quant="w8a8"), device="cpu")
    want = _int8_edges(jeng, x)
    assert len(want) > 40
    got = teng.extract(x, sorted(want))
    off1 = total = 0
    for name, ref in want.items():
        d = np.abs(got[name].numpy().astype(np.int32) - ref)
        assert d.max() <= 1, (name, int(d.max()))
        off1 += int((d == 1).sum())
        total += ref.size
    print(f"int8 edges: {off1} of {total} elements off by 1 LSB "
          f"({off1 / total:.2e})")
    jp = np.asarray(jeng(x), np.float64).ravel()
    tp = teng(x).double().numpy().ravel()
    assert jp.argmax() == tp.argmax()
    cos = jp @ tp / (np.linalg.norm(jp) * np.linalg.norm(tp))
    assert cos >= 0.999, cos


def test_calibrate_matches_reference_scales():
    """The port's calibrate over its own engine gives the reference's
    scales within rtol 1e-5 (the float convs sum in another order)."""
    xs = _inputs(4, (1, 64, 64, 3), n=2)
    jg = jresnet50(with_softmax=True)
    jcalibrate(jg, xs, method="max")
    tg = resnet50(with_softmax=True)
    scales = calibrate(tg, xs, method="max", device="cpu")
    assert scales.keys() == jg.meta["act_scales"].keys()
    for key in ("act_scales", "value_scales"):
        a, b = jg.meta[key], tg.meta[key]
        assert a.keys() == b.keys(), key
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       err_msg=f"{key}[{k}]")
