"""The classic zoo models — SqueezeNet v1.0/v1.1, VGG-16/19, GoogLeNet and
AlexNet — and their ops (Concat, LRN, the float grouped conv, the int8 MAX
3x3 s1 pool) through the PyTorch port against the JAX package, on the CPU
(the port's kernel wrappers take their plain versions there).

Both engines get the same graph and weights (each builds its own zoo model
from the same seed, or the JAX one is carried across with
``graph_from_reference``), the same calibrated scales and the same numpy
inputs, made from a seed.

Tolerances, with their reasons:

- fp32: the fingerprints of ``tests/goldens.json`` with the tolerances of
  ``tests/test_goldens.py:104-118``, and the JAX engine's full output
  within rtol 1e-4 of its largest magnitude (the two frameworks sum
  convolutions in different orders).
- w8a8 int8 edges: equal, with one exception.  The reference computes an
  LRN's ``rsqrt`` and ``sqrt`` with XLA's CPU approximations (within 1 ulp
  of f32, not correctly rounded); the port computes ``1 / sqrt(b)`` and
  ``sqrt`` with IEEE rounding.  An LRN's int8 output may therefore differ
  by 1 LSB where ``y / y_scale`` lies within an ulp of a rounding boundary;
  the test allows that at LRN outputs only and prints how many elements
  differ.  To keep such a step from spreading, each node is also run on
  the reference's own input edges (node by node), where every other int8
  edge must be equal and every float edge within 1 bf16 ulp (or 1e-5 of
  its largest value); end to end, every int8 edge must be equal wherever
  no LRN output differed.  The reference's ``lrn_band`` form rounds the
  squares to bf16 under a bf16 compute dtype (a TPU formulation); the port
  computes the exact f32 window sum for every ``lrn_band`` value, so the
  reference runs with ``lrn_band=False``, its exact form.
- w8 (bf16 activations, no int8 edge): every float edge within 2e-2 of its
  largest magnitude and the probabilities within 1e-2: bf16 x int8 GEMMs
  sum in f32 in other orders, and a bf16 store may round the other way,
  layer after layer.  On the Winograd route each Winograd conv is held
  node by node within 1e-2 of its largest output (F(6,3) on bf16-rounded
  transformed operands, see tests/test_torch_winograd.py): end to end
  those errors compound from layer to layer (up to ~7% of the largest
  value at the last edges of the 7-conv graph), so the end-to-end
  differences are printed, not held.

Few test items per file: see tests/test_torch_kernels.py.
"""

import functools
import json
import os

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import models as jmodels
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch import models
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ops.lowering import lower_node
from feathercnn_tpu_torch.weights import graph_from_reference

_MODELS = ("squeezenet_v10", "squeezenet_v11", "vgg16", "vgg19",
           "googlenet", "alexnet")
# the models also held to the JAX engine's full fp32 output
_FULL_OUTPUT = ("squeezenet_v10", "squeezenet_v11", "googlenet", "alexnet")


def _fingerprint(arr):
    """tests/test_goldens.py's fingerprint of an output tensor."""
    out = np.asarray(arr, np.float32).ravel()
    v = np.random.default_rng(20260820 + out.size).standard_normal(
        out.size).astype(np.float32)
    return {"first8": [round(float(v_), 6) for v_ in out[:8]],
            "argmax": int(out.argmax()),
            "sum": round(float(out.sum()), 5),
            "proj": round(float(np.dot(out, v)), 5)}


def _nodes(g):
    return [(n.name, n.op, n.inputs, n.outputs, n.params, n.attrs)
            for n in g.nodes]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The reference's and the port's zoo model at batch 1, seed 0."""
    return getattr(jmodels, name)(), models.build_model(name)


def _same_graph(jg, tg, what):
    assert _nodes(tg) == _nodes(jg), what
    assert tg.inputs.keys() == jg.inputs.keys() and tg.outputs == jg.outputs
    assert {k: s.shape for k, s in tg.specs.items()} == \
        {k: s.shape for k, s in jg.specs.items()}, what
    assert tg.params.keys() == jg.params.keys(), what
    for k, v in jg.params.items():
        np.testing.assert_array_equal(tg.params[k], v, err_msg=k)
    assert tg.meta == jg.meta, what


def test_builders_build_the_reference_graphs():
    """Nodes, attrs, params (bit-equal), shapes and the baked
    ``meta["config_overrides"]`` of the six builders; at another batch and
    seed too for the three whose weights are quick to draw."""
    for name in _MODELS:
        assert name in models.MODEL_BUILDERS, name
        _same_graph(*_pair(name), name)
        if name in ("squeezenet_v10", "squeezenet_v11", "googlenet"):
            _same_graph(getattr(jmodels, name)(batch=3, seed=1,
                                               with_softmax=False),
                        models.build_model(name, batch=3, seed=1,
                                           with_softmax=False), name)
    assert _pair("googlenet")[1].meta["config_overrides"] == {
        "merge_siblings": False}
    assert _pair("alexnet")[1].meta["config_overrides"] == {
        "quant_overrides": {"norm2": "fp"}, "int8_grouped": False}


def test_fp32_goldens_and_full_output():
    """The golden blob of each model (the logits before the Softmax) meets
    its fingerprint.  SqueezeNet, GoogLeNet and AlexNet meet
    tests/test_goldens.py's tolerances and the JAX engine's full output.
    VGG-16/19 meet them in argmax and the projection; their first8 and sum
    take an absolute floor scaled by the output's magnitude (first8:
    5e-6 x max|y|; sum: 1e-6 x sum|y|), because 16 and 19 plain conv
    layers of f32 sums in another order than XLA's leave differences up to
    ~3e-6 x max|y| in the logits (1.8e-5 on logits near 7), above the
    golden's 1e-6 floor on its small elements."""
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        goldens = json.load(f)
    for name in _MODELS:
        jg, tg = _pair(name)
        spec = next(iter(tg.inputs.values()))
        x = np.random.default_rng(42).normal(size=spec.shape).astype(
            np.float32)
        ((blob, ref),) = goldens[name].items()
        got = Engine(tg, device="cpu").run(x, extract=[blob])[blob].numpy()
        fp = _fingerprint(got)
        deep = name.startswith("vgg")
        atol8 = 5e-6 * np.abs(got).max() if deep else 1e-6
        atol_sum = 1e-6 * np.abs(got).sum() if deep else 0.0
        # the tolerances of tests/test_goldens.py
        assert fp["argmax"] == ref["argmax"], name
        np.testing.assert_allclose(fp["first8"], ref["first8"], rtol=1e-4,
                                   atol=atol8, err_msg=name)
        np.testing.assert_allclose(fp["sum"], ref["sum"], rtol=1e-4,
                                   atol=atol_sum, err_msg=name)
        np.testing.assert_allclose(
            fp["proj"], ref["proj"], rtol=1e-3,
            atol=1e-3 * (1.0 + max(abs(v) for v in fp["first8"])),
            err_msg=name)
        if name in _FULL_OUTPUT:
            want = np.asarray(JEngine(jg).run(x, extract=[blob])[blob])
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _reference_edges(jeng, teng, x):
    """Every value of the reference's optimized graph (which must be the
    port's) as numpy, and each port node's outputs when the node runs on
    the reference's own input values: (ref, {value: port tensor})."""
    assert _nodes(teng.graph) == _nodes(jeng.graph)
    names = [o for n in jeng.graph.nodes for o in n.outputs]
    ref = {k: np.asarray(v) for k, v in jeng.run(x, extract=names).items()}
    env = {k: _to_torch(v) for k, v in ref.items()}
    for name in teng.graph.inputs:
        env[name] = torch.from_numpy(x).to(
            getattr(torch, teng.config.compute_dtype))
    params = teng._prepare_params()
    mine = {}
    with torch.inference_mode():
        for n in teng.graph.nodes:
            outs = lower_node(n, [env[i] for i in n.inputs],
                              [params[p] for p in n.params], teng._ctx)
            mine.update(zip(n.outputs, outs))
    return ref, mine


def _hold_int8_edges(case, jeng, teng, x):
    """Every int8 edge of ``jeng``'s optimized graph against ``teng``, node
    by node (each port node run on the reference's own input edges) and
    end to end, as the module docstring says.  Returns the number of int8
    edges, the LRN output elements that differ, and both engines' values
    (the reference's every edge, the port's int8 edges and outputs)."""
    ref, mine = _reference_edges(jeng, teng, x)
    lrn_out = {n.outputs[0] for n in teng.graph.nodes if n.op == "LRN"}
    int8 = [k for k, v in ref.items() if v.dtype == np.int8]
    lrn_off = 0
    for o, t in mine.items():
        if ref[o].dtype != np.int8:
            # a float edge: within 1 bf16 ulp, or 1e-5 of its largest value
            # (float convs sum in other orders)
            assert t.dtype != torch.int8, (case, o)
            r = ref[o].astype(np.float32)
            err = np.abs(t.float().numpy() - r)
            assert (err <= 2.0 ** -7 * np.abs(r)
                    + 1e-5 * np.abs(r).max()).all(), (case, o, err.max())
            continue
        assert t.dtype == torch.int8, (case, o, t.dtype)
        d = np.abs(t.numpy().astype(np.int32) - ref[o])
        if o in lrn_out:
            assert d.max() <= 1, (case, o, int(d.max()))
            lrn_off += int((d > 0).sum())
        else:
            assert d.max() == 0, \
                f"{case} {o}: {int((d > 0).sum())} int8 values differ"
    got = teng.extract(x, int8)
    e2e_off = 0
    for k in int8:
        d = np.abs(got[k].numpy().astype(np.int32) - ref[k])
        e2e_off += int((d > 0).sum())
        if k in lrn_out:
            assert d.max() <= 1, (case, k, int(d.max()))
    if lrn_off == 0:
        assert e2e_off == 0, f"{case}: {e2e_off} int8 values differ"
    total = sum(ref[k].size for k in int8)
    print(f"{case}: {len(int8)} int8 edges ({total} elements); node by "
          f"node {lrn_off} LRN output elements off by 1 LSB, the rest "
          f"equal; end to end {e2e_off} differ")
    return len(int8), lrn_off, ref, got


def _ops_graph():
    """A stem with an int8 LRN; an inception-like block whose Concat takes
    a float operand (a branch that is also a graph output) and int8
    operands at their own scales (concat_int8), beside one whose operands
    all arrive at one scale (passthrough); an int8 MAX 3x3 s1 pad-1 pool;
    a 2-group conv (float, ``int8_grouped=False``) and an LRN named "fp"
    in quant_overrides; a FC."""
    b = JBuilder("ops", seed=7)
    x = b.input("data", (2, 15, 13, 3))
    x = b.conv("stem", x, 32, 3, pad=1, relu=True)
    x = b.lrn("norm1", x)
    x = b.conv("red", x, 32, 1, relu=True)
    f1 = b.conv("br1", x, 16, 1, relu=True)
    f3 = b.conv("br3", x, 24, 3, pad=1, relu=True)
    fp = b.pool("brp", x, 3, 1, pad=1)
    fp = b.conv("brp_proj", fp, 8, 1, relu=True)
    cat1 = b.concat("cat1", [f1, f3, fp])
    e1 = b.conv("e1", cat1, 16, 1, relu=True)
    e3 = b.conv("e3", cat1, 16, 3, pad=1, relu=True)
    cat2 = b.concat("cat2", [e1, e3])
    y = b.conv("mix", cat2, 32, 1, relu=True)
    y = b.conv("grp", y, 32, 3, pad=1, group=2, relu=True)
    y = b.lrn("norm2", y)
    y = b.conv("post", y, 32, 3, pad=1, relu=True)
    y = b.pool("pool", y, 2, 2)
    y = b.fc("fc", y, 10)
    return b.finish([b.softmax("prob", y), f1])


def _vgg_graph():
    """VGG-shaped at narrow widths: 3x3 s1 convs, 2x2 MAX pools, FCs,
    Dropout and Softmax."""
    b = JBuilder("vggmini", seed=9)
    x = b.input("data", (2, 24, 20, 3))
    for stage, (n, ch) in enumerate([(2, 16), (2, 32), (3, 32)], start=1):
        for i in range(1, n + 1):
            x = b.conv(f"conv{stage}_{i}", x, ch, 3, pad=1, relu=True)
        x = b.pool(f"pool{stage}", x, 2, 2)
    x = b.fc("fc6", x, 64, relu=True)
    x = b.dropout("drop6", x)
    x = b.fc("fc7", x, 64, relu=True)
    x = b.dropout("drop7", x)
    x = b.fc("fc8", x, 10)
    return b.finish([b.softmax("prob", x)])


def test_ops_int8_edges_and_vgg_w8_match_reference():
    """Concat (concat_int8 with mixed scales and a float operand; the
    passthrough), LRN (requant_int8 and under the "fp" override), the float
    grouped conv and the int8 MAX 3x3 s1 pad-1 pool under w8a8, against the
    JAX engine (Pallas in interpret mode); and a VGG-shaped graph under w8
    on the default route (bf16 x int8 through both GEMM kernels) and the
    Winograd route."""
    rng = np.random.default_rng(3)
    g = _ops_graph()
    jcalibrate(g, [rng.normal(size=(2, 15, 13, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(2, 15, 13, 3)).astype(np.float32)
    tg = graph_from_reference(g)
    kw = dict(quant="w8a8", compute_dtype="bfloat16", int8_grouped=False,
              quant_overrides=(("norm2", "fp"),))
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True,
                              lrn_band=False, **kw))
    teng = Engine(tg, EngineConfig(backend="cuda", **kw), device="cpu")
    q = teng.graph.meta["quant"]
    assert q["cat1"].get("concat_int8"), q.get("cat1")
    assert len(set(q["cat1"]["in_scales"])) == 3
    assert q["cat2"].get("passthrough_int8"), q.get("cat2")
    assert q["norm1"].get("requant_int8") and "norm2" not in q
    assert q["brp"].get("passthrough_int8")
    n_int8, _, ref, got = _hold_int8_edges("ops w8a8", jeng, teng, x)
    assert n_int8 >= 10
    out = teng.graph.outputs[0]
    assert got[out].dtype == torch.bfloat16
    np.testing.assert_allclose(got[out].float().numpy(),
                               ref[out].astype(np.float32), rtol=0,
                               atol=1e-2)

    g = _vgg_graph()
    x = rng.normal(size=(2, 24, 20, 3)).astype(np.float32)
    tg = graph_from_reference(g)
    convs = tuple((n.name, "winograd") for n in g.nodes
                  if n.op == "Convolution")
    for route, ov in (("default", ()), ("winograd", convs)):
        case = f"vgg-shaped w8 {route}"
        kw = dict(quant="w8", compute_dtype="bfloat16", algo_overrides=ov)
        jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
        teng = Engine(tg, EngineConfig(backend="cuda", **kw), device="cpu")
        # calibration is skipped: per-channel int8 weights, w_scale only
        q = teng.graph.meta["quant"]
        for n in teng.graph.nodes:
            if n.op in ("Convolution", "InnerProduct"):
                assert teng.graph.params[n.params[0]].dtype == np.int8
                assert set(q[n.name]) == {"w_scale"}, (case, n.name)
        ref, mine = _reference_edges(jeng, teng, x)
        got = teng.extract(x, list(ref))
        worst = {}
        for k, r in ref.items():
            r = r.astype(np.float32)
            top = max(np.abs(r).max(), 1e-30)
            assert got[k].dtype == mine[k].dtype == torch.bfloat16, (case, k)
            # node by node: a Winograd conv within F(6,3)'s bf16 error
            # (tests/test_torch_winograd.py), every other node within the
            # w8 tolerance
            tol = 1e-2 if route == "winograd" and k.startswith("conv") \
                else 2e-2
            err = np.abs(mine[k].float().numpy() - r).max() / top
            assert err <= tol, (case, k, err)
            worst[k] = float(np.abs(got[k].float().numpy() - r).max() / top)
        if route == "default":
            # end to end: the default route's edges stay within the w8
            # tolerance; the Winograd route's bf16 transform errors compound
            # from layer to layer (printed)
            assert max(worst.values()) <= 2e-2, (case, worst)
            np.testing.assert_allclose(got["prob"].float().numpy(),
                                       ref["prob"].astype(np.float32),
                                       rtol=0, atol=1e-2, err_msg=case)
        print(f"{case}: largest end-to-end error / largest value per edge "
              f"{max(worst.values()):.3g} ({max(worst, key=worst.get)})")


def test_full_width_squeezenet_googlenet_w8a8_int8_edges():
    """squeezenet_v11 (passthrough Concats, its baked
    ``int8_requant_ops=False``) and googlenet (9 inception Concats, 2 int8
    LRNs, MAX 3x3 s1 pad-1 pools on int8 edges, its baked
    ``merge_siblings=False``) at b1, full width and size, full int8: every
    int8 edge against the JAX engine.  Both engines take
    ``algo_overrides=(("*", "xla"),)`` (Pallas interpret mode is too slow
    at this size): the int8 convs then run XLA's int8 conv in the
    reference and the port's GEMM kernels (plain versions) with the same
    folded scale."""
    for name in ("squeezenet_v11", "googlenet"):
        g = getattr(jmodels, name)()
        spec = next(iter(g.inputs.values()))
        rng = np.random.default_rng(4)
        jcalibrate(g, [rng.normal(size=spec.shape).astype(np.float32)],
                   method="max")
        x = rng.normal(size=spec.shape).astype(np.float32)
        kw = dict(quant="w8a8", compute_dtype="bfloat16",
                  algo_overrides=(("*", "xla"),))
        jeng = JEngine(g, JConfig(backend="pallas", interpret=True,
                                  lrn_band=False, **kw))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", **kw), device="cpu")
        n_int8, _, ref, got = _hold_int8_edges(f"{name} w8a8", jeng, teng,
                                               x)
        assert n_int8 >= 30, (name, n_int8)
        out = teng.graph.outputs[0]
        jp = ref[out].astype(np.float64).ravel()
        tp = got[out].double().numpy().ravel()
        assert jp.argmax() == tp.argmax(), name
        cos = jp @ tp / (np.linalg.norm(jp) * np.linalg.norm(tp))
        assert cos >= 0.999, (name, cos)
