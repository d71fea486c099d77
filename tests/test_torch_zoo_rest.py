"""The rest of the classification zoo — ShuffleNet v1/v2, SE-ResNet-50,
Inception-v3, DenseNet-121/169/201 and ResNeXt-50 — and their ops
(Scale, Axpy, Sigmoid, ShuffleChannel, Bias, BatchNorm, the grouped int8
conv) through the PyTorch port against the JAX package, on the CPU (the
port's kernel wrappers take their plain versions there).

Both engines get the same graph and weights (each builds its own zoo model
from the same seed, or the JAX one is carried across with
``graph_from_reference``), the same calibrated scales and the same numpy
inputs, made from a seed.

Tolerances, with their reasons:

- fp32: the fingerprints of ``tests/goldens.json`` with the tolerances of
  ``tests/test_goldens.py:104-118``, and the JAX engine's full output within
  rtol 1e-4 of its largest magnitude (the two frameworks sum convolutions
  in different orders).  An un-optimized graph (BatchNorm unfolded) the
  same.
- w8a8 int8 edges: equal, node by node and end to end, with one exception
  at Axpy outputs (``tests/test_torch_zoo_rest_int8.py`` says why: the
  reference's compiled Axpy reads its fused Sigmoid's gate at another
  precision than the edge it materializes).  Float edges node by node
  within 1 bf16 ulp (or 1e-5 of the edge's largest value), as
  ``tests/test_torch_classic_zoo.py`` holds them (``_hold_int8_edges``
  here is its helper with the Axpy allowance).

Few test items per file: see tests/test_torch_kernels.py.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import models as jmodels
from feathercnn_tpu.ir import Node as JNode
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch import models
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ops.lowering import lower_node
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import (_fingerprint, _nodes, _same_graph,
                                   _to_torch)

_MODELS = ("shufflenet_v1", "shufflenet_v2", "se_resnet50", "inception_v3",
           "densenet121", "densenet169", "densenet201", "resnext50")
# the models also held to the JAX engine's full fp32 output
_FULL_OUTPUT = ("se_resnet50", "resnext50", "inception_v3")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module's tests run (restored
    after).  These tests come last in a ``--dist loadfile`` run, beside
    each other on the other workers: each worker taking every core made
    them run ~12x their one-process time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The reference's and the port's zoo model at batch 1, seed 0."""
    return getattr(jmodels, name)(), models.build_model(name)


def test_builders_build_the_reference_graphs():
    """Nodes, attrs, params (bit-equal), shapes and the baked
    ``meta["config_overrides"]`` of the eight builders; at another batch
    and seed too for the two ShuffleNets."""
    for name in _MODELS:
        assert name in models.MODEL_BUILDERS, name
        _same_graph(*_pair(name), name)
    for name in ("shufflenet_v1", "shufflenet_v2"):
        _same_graph(getattr(jmodels, name)(batch=3, seed=1,
                                           with_softmax=False),
                    models.build_model(name, batch=3, seed=1,
                                       with_softmax=False), name)
    assert _pair("shufflenet_v1")[1].meta["config_overrides"] == {
        "int8_grouped": False}
    assert _pair("shufflenet_v2")[1].meta["config_overrides"] == {
        "int8_grouped": False, "shuffle_matmul": True}
    for name in ("se_resnet50", "inception_v3", "densenet121", "resnext50"):
        assert "config_overrides" not in _pair(name)[1].meta, name


def test_fp32_goldens_and_full_output():
    """The golden blob of each model (the logits before the Softmax), one
    image at full width and size, meets its fingerprint with
    tests/test_goldens.py's tolerances; SE-ResNet-50, ResNeXt-50 and
    Inception-v3 meet the JAX engine's full output too.  SE-ResNet-50's
    first8 takes an absolute floor of 1e-4 x max|y| (the full-output
    check's): its 16 Sigmoid gates take pre-activations up to ~100 with
    random weights, so the convs' f32 sums in another order than XLA's
    (each edge within 2e-6 of its largest value node by node, held here)
    move a gate by up to ~1e-4 and the smaller logits by up to ~9e-4 of
    their value (0.014 on 16.9, against a largest logit of 385)."""
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
        gated = name == "se_resnet50"
        assert fp["argmax"] == ref["argmax"], name
        np.testing.assert_allclose(fp["first8"], ref["first8"], rtol=1e-4,
                                   atol=1e-4 * np.abs(got).max() if gated
                                   else 1e-6, err_msg=name)
        np.testing.assert_allclose(fp["sum"], ref["sum"], rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(
            fp["proj"], ref["proj"], rtol=1e-3,
            atol=1e-3 * (1.0 + max(abs(v) for v in fp["first8"])),
            err_msg=name)
        if gated:
            # every edge node by node, the reference's output among them
            ref_edges, mine = _reference_edges(
                JEngine(jg), Engine(graph_from_reference(jg), device="cpu"),
                x)
            for k, t in mine.items():
                r = ref_edges[k]
                err = np.abs(t.numpy() - r).max() / np.abs(r).max()
                assert err <= 1e-5, (name, k, err)
            want = ref_edges[blob]
        elif name in _FULL_OUTPUT:
            want = np.asarray(JEngine(jg).run(x, extract=[blob])[blob])
        if name in _FULL_OUTPUT:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)


def _reference_edges(jeng, teng, x, fused_ops=()):
    """Every value of the reference's optimized graph (which must be the
    port's) as numpy, and each port node's outputs when the node runs on
    the reference's own input values: (ref, {value: port tensor}), as
    tests/test_torch_classic_zoo.py's helper of that name.  A value made by
    an op of ``fused_ops`` is read from the port's own output of that node
    instead (run on the reference's inputs): the reference's compiled
    consumer reads such a value before its rounding to the edge's type."""
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
            if n.op in fused_ops:
                env.update(zip(n.outputs, outs))
    return ref, mine


def _hold_int8_edges(case, jeng, teng, x, lsb_ops=(), fused_ops=(),
                     spread=False, filled=None):
    """Every int8 edge of ``jeng``'s optimized graph against ``teng``, as
    tests/test_torch_classic_zoo.py's helper of that name holds them: node
    by node (each port node on the reference's own input edges, but the
    values of ``fused_ops``) every int8 edge equal but the outputs of the
    ops in ``lsb_ops``, which may differ by 1 LSB, and every float edge
    within 1 bf16 ulp or 1e-5 of its largest value; end to end every int8
    edge equal where no such output differed node by node.  ``spread``:
    once one did, end to end the difference may grow downstream (printed,
    not held).  Returns the number of int8 edges, the elements of those
    outputs that differ, and both engines' values (the reference's every
    edge, the port's int8 edges and outputs).  ``filled`` (value ->
    channels) holds those values on their first channels alone: a concat
    ladder's ``__buf`` edges, whose later channels the port's in-place
    appends fill after the node ran."""
    ref, mine = _reference_edges(jeng, teng, x, fused_ops)
    if filled:
        ref = {k: v[..., :filled[k]] if k in filled else v
               for k, v in ref.items()}
        mine = {k: v[..., :filled[k]] if k in filled else v
                for k, v in mine.items()}
    loose = {n.outputs[0] for n in teng.graph.nodes if n.op in lsb_ops}
    int8 = [k for k, v in ref.items() if v.dtype == np.int8]
    off = 0
    for o, t in mine.items():
        if ref[o].dtype != np.int8:
            assert t.dtype != torch.int8, (case, o)
            r = ref[o].astype(np.float32)
            err = np.abs(t.float().numpy() - r)
            assert (err <= 2.0 ** -7 * np.abs(r)
                    + 1e-5 * np.abs(r).max()).all(), (case, o, err.max())
            continue
        assert t.dtype == torch.int8, (case, o, t.dtype)
        d = np.abs(t.numpy().astype(np.int32) - ref[o])
        if o in loose:
            assert d.max() <= 1, (case, o, int(d.max()))
            off += int((d > 0).sum())
        else:
            assert d.max() == 0, \
                f"{case} {o}: {int((d > 0).sum())} int8 values differ"
    got = teng.extract(x, int8)
    if filled:
        got = {k: v[..., :filled[k]] if k in filled else v
               for k, v in got.items()}
    e2e_off = 0
    for k in int8:
        d = np.abs(got[k].numpy().astype(np.int32) - ref[k])
        e2e_off += int((d > 0).sum())
        if k in loose and not (spread and off):
            assert d.max() <= 1, (case, k, int(d.max()))
    if off == 0:
        assert e2e_off == 0, f"{case}: {e2e_off} int8 values differ"
    total = sum(ref[k].size for k in int8)
    print(f"{case}: {len(int8)} int8 edges ({total} elements); node by "
          f"node {off} {'/'.join(lsb_ops) or 'no'} output elements off by "
          f"1 LSB, the rest equal; end to end {e2e_off} differ")
    return len(int8), off, ref, got


def _ops_graph(batch=2):
    """Every op of this slice at narrow widths, each in each of its forms:

    - a DenseNet-like Concat -> BatchNorm+Scale -> ReLU (a standalone int8
      Scale, ``requant_int8``) -> conv;
    - grouped int8 convs at 8, 4 and 32 channels a group, stride 2 and 1;
    - an SE path (global AVE pool, 1x1 down/up, Sigmoid) into an int8 Axpy
      with fused ReLU, then an int8 ShuffleChannel;
    - a float Axpy (its output feeds an Eltwise beside a float value), a
      plain Scale after that Eltwise, a two-bottom Scale with a learned
      bias (the SE gate as its scaler), a float ShuffleChannel and a Bias
      whose output is a graph output (a float reduction after it would
      fuse with it in the reference and read its sums before their bf16
      rounding).
    """
    b = JBuilder("ops", seed=11)
    x = b.input("data", (batch, 13, 11, 3))
    x = b.conv("stem", x, 32, 3, pad=1, bias=False)
    x = b.relu("stem_relu", b.bn_scale("stem_bnsc", x))
    c1 = b.conv("c1", x, 32, 1, bias=False)
    y = b.concat("cat", [x, c1])
    y = b.relu("pre_relu", b.bn_scale("pre", y))
    y = b.conv("c2", y, 64, 1, bias=False)
    y = b.relu("c2_relu", b.bn_scale("c2_bnsc", y))
    y = b.conv("g1", y, 64, 3, stride=2, pad=1, group=8, bias=False)
    y = b.relu("g1_relu", b.bn_scale("g1_bnsc", y))
    y = b.conv("g2", y, 64, 3, pad=1, group=16, bias=False)
    y = b.relu("g2_relu", b.bn_scale("g2_bnsc", y))
    y = b.conv("g3", y, 64, 3, pad=1, group=2, bias=False)
    y = b.bn_scale("g3_bnsc", y)
    s = b.pool("gp", y, 0, mode="AVE", global_pooling=True)
    s = b.conv("down", s, 16, 1, relu=True)
    s = b.conv("up", s, 64, 1)
    s = b.sigmoid("gate", s)
    sc = b.conv("proj", x, 64, 1, stride=2, bias=False)
    out = b.relu("axpy_relu", b.axpy("axpy", s, y, sc))
    out = b.shuffle_channel("shuf", out, 4)
    out = b.conv("g4", out, 64, 3, stride=2, pad=1, group=2, relu=True)
    # the float forms
    f = b.axpy("axpy_f", s, y, sc)
    f = b.eltwise("sum", [f, sc])
    f = b.scale("plain", f)
    name = "scaled"
    beta = b._param(name + "/beta", (64,), "mean")
    f = b._add(JNode(name, "Scale", [f, s], [name], {"bias_term": True},
                     [beta]))[0]
    b._channels[f] = 64
    f = b.shuffle_channel("shuf_f", f, 8)
    bias = b._param("bias/b", (64,), "mean")
    f = b._add(JNode("bias", "Bias", [f], ["bias"], {}, [bias]))[0]
    b._channels[f] = 64
    out = b.pool("pool", out, 0, mode="AVE", global_pooling=True)
    out = b.fc("fc", out, 10)
    return b.finish([b.softmax("prob", out), f])


def _bn_graph():
    """Un-folded BatchNorm, Scale, Bias, Sigmoid and Axpy in fp32."""
    b = JBuilder("bn", seed=5)
    x = b.input("data", (2, 9, 7, 8))
    y = b.conv("c", x, 16, 3, pad=1)
    y = b.relu("r", b.scale("sc", b.batchnorm("bn", y)))
    s = b.sigmoid("gate", b.pool("gp", y, 0, mode="AVE",
                                 global_pooling=True))
    y = b.axpy("axpy", s, y, y)
    y = b.shuffle_channel("shuf", y, 4)
    bias = b._param("bias/b", (16,), "mean")
    y = b._add(JNode("bias", "Bias", [y], ["bias"], {}, [bias]))[0]
    return b.finish([y])


def test_ops_match_reference():
    """The ops graph under w8a8 against the JAX engine (Pallas in interpret
    mode), node by node and end to end, for either value of
    ``shuffle_matmul`` (the reference's TPU form of the shuffle); the
    same graph in fp32 and an un-optimized fp32 graph (BatchNorm and Scale
    unfolded) against the JAX engine's outputs."""
    rng = np.random.default_rng(3)
    g = _ops_graph()
    jcalibrate(g, [rng.normal(size=(2, 13, 11, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(2, 13, 11, 3)).astype(np.float32)
    tg = graph_from_reference(g)
    for shuffle_matmul in (False, True):
        case = f"ops w8a8 shuffle_matmul={shuffle_matmul}"
        kw = dict(quant="w8a8", compute_dtype="bfloat16",
                  shuffle_matmul=shuffle_matmul)
        jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
        teng = Engine(tg, EngineConfig(backend="cuda", **kw), device="cpu")
        q = teng.graph.meta["quant"]
        ops = {n.name: n.op for n in teng.graph.nodes}
        assert ops["pre/scale"] == "Scale" and q["pre/scale"]["requant_int8"]
        assert q["axpy"].get("axpy_int8") and "axpy_f" not in q
        assert q["shuf"].get("passthrough_int8") and "shuf_f" not in q
        assert ops["plain"] == "Scale" and "plain" not in q
        n_int8, off, ref, got = _hold_int8_edges(
            case, jeng, teng, x, lsb_ops=("Axpy",), fused_ops=("Sigmoid",))
        int8 = {k for k, v in ref.items() if v.dtype == np.int8}
        # every grouped conv takes an int8 edge; g1 and g2 emit one (g3's
        # and g4's outputs feed global pools, which take float)
        grouped = [n for n in teng.graph.nodes if n.op == "Convolution"
                   and n.attrs.get("group", 1) > 1]
        assert [n.name for n in grouped] == ["g1", "g2", "g3", "g4"]
        for n in grouped:
            assert n.inputs[0] in int8, n.name
            assert (n.outputs[0] in int8) == (n.name in ("g1", "g2")), n.name
        assert {"axpy", "shuf", "pre/scale", "cat"} <= int8
        assert n_int8 >= 10, n_int8
        # end to end every int8 edge equals the reference's
        e2e = {k: int((got[k].numpy() != ref[k]).sum()) for k in int8}
        assert not any(e2e.values()), (case, e2e)
        out = teng.graph.outputs[0]
        np.testing.assert_allclose(got[out].float().numpy(),
                                   ref[out].astype(np.float32), rtol=0,
                                   atol=1e-2, err_msg=case)
    for graph, opt in ((g, True), (_bn_graph(), False)):
        xx = rng.normal(size=graph.inputs["data"].shape).astype(np.float32)
        want = np.asarray(JEngine(graph, optimize_graph=opt)(xx))
        teng = Engine(graph_from_reference(graph), optimize_graph=opt,
                      device="cpu")
        if not opt:
            assert {"BatchNorm", "Scale", "Bias", "Axpy", "Sigmoid",
                    "ShuffleChannel"} <= {n.op for n in teng.graph.nodes}
        np.testing.assert_allclose(teng(xx).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{graph.name} fp32")
