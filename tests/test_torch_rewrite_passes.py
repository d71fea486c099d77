"""The rewrite passes of the PyTorch port — the space-to-depth stem
(``passes_stem.py``, ``EngineConfig.s2d_stem``) and the concat ladders
(``passes_ladder.py``, ``concat_dus``) with their lowerings (SpaceToDepth,
LadderInit, LadderAppend, LadderView) — against the JAX package, on the
CPU.

- The passes: on the same graph (built by the JAX builder, after the
  reference's ``optimize`` and, for the int8 cases, ``quantize_graph``,
  carried across), the port's pass returns the reference's count and
  leaves the reference's graph: nodes, attrs, params, ``meta["quant"]``
  and ``value_scales`` bit for bit.
- fp32 numbers of the stem: within the reference's own ``rtol=atol=1e-5``
  (``tests/test_passes.py``) of the JAX s2d engine and of the port
  without the pass.
- w8a8: ResNet-50 with ``s2d_stem`` at b1 on a 64x64 input and
  DenseNet-121 with ``concat_dus`` at b1 on 224x224, both engines on
  ``algo_overrides=(("*", "xla"),)`` (Pallas interpret mode is too slow at
  this size): every int8 edge equal, node by node and end to end, with
  ``test_torch_zoo_rest._hold_int8_edges``.  A ladder's ``__buf`` edges are
  held on their filled channels only: the port's LadderAppend writes into
  the one buffer in place, so after the forward a ``__buf`` value holds
  the channels later appends wrote where the reference's holds zeros.
- In place: an append keeps its buffer's storage, and a view taken before
  a later append keeps its values.

Few test items per file: see tests/test_torch_kernels.py.
"""

import copy

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import models as jmodels
from feathercnn_tpu.ir import TensorSpec as JSpec
from feathercnn_tpu.ir import infer_shapes as jinfer_shapes
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.passes import optimize as joptimize
from feathercnn_tpu.passes_ladder import dus_concat_ladders as jladders
from feathercnn_tpu.passes_stem import space_to_depth_stem as jstem
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu.quant.rewrite import quantize_graph as jquantize
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ir import infer_shapes
from feathercnn_tpu_torch.passes_ladder import dus_concat_ladders
from feathercnn_tpu_torch.passes_stem import space_to_depth_stem
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _nodes
from test_torch_zoo_rest import _hold_int8_edges, _two_threads  # noqa: F401

_KW = dict(quant="w8a8", compute_dtype="bfloat16",
           algo_overrides=(("*", "xla"),))


def _stem(size=32, seed=15):
    b = JBuilder("stem", seed=seed)
    x = b.input("data", (1, size, size, 3))
    y = b.conv("conv1", x, 16, 7, stride=2, pad=3, relu=True)
    y = b.pool("pool1", y, 3, 2)
    y = b.conv("conv2", y, 16, 3, pad=1, relu=True)
    y = b.pool("gap", y, 0, mode="AVE", global_pooling=True)
    return b.finish([b.fc("fc", y, 10)])


def _toy_ladder(batch=2, size=8, base_c=16, k=8, layers=4, seed=0):
    """tests/test_ladder.py's DenseNet-shaped toy: a base conv, then
    ``layers`` of (1x1 conv on the running concat) -> Concat(prev, y_i),
    a standalone Scale and a 1x1 conv."""
    b = JBuilder("ladder", seed)
    x = b.input("data", (batch, size, size, 3))
    x = b.conv("stem", x, base_c, 3, pad=1)
    x = b.relu("stem_relu", x)
    for i in range(layers):
        y = b.conv(f"l{i}", x, k, 1)
        y = b.relu(f"l{i}_relu", y)
        x = b.concat(f"cat{i}", [x, y])
    x = b.bn_scale("post", x)
    x = b.conv("trans", x, base_c, 1)
    x = b.pool("gap", x, 0, mode="AVE", global_pooling=True)
    x = b.fc("fc", x, 10)
    return b.finish([x])


def _same(a, b, where):
    """``a`` and ``b`` (meta dicts, lists, arrays, numbers) equal, arrays
    bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _same_graph(jg, tg, what):
    assert _nodes(tg) == _nodes(jg), what
    assert tg.outputs == jg.outputs, what
    assert {k: s.shape for k, s in tg.specs.items()} == \
        {k: s.shape for k, s in jg.specs.items()}, what
    _same({k: np.asarray(v) for k, v in jg.params.items()}, tg.params,
          f"{what} params")
    _same(jg.meta, tg.meta, f"{what} meta")


def _prepared(g, quant, x):
    """``g`` after the reference engine's passes that come before the
    rewrite (``optimize``, and under w8a8 calibration and
    ``quantize_graph``), with shapes inferred."""
    g = copy.deepcopy(g)
    if quant:
        jcalibrate(g, [x], method="max")
    joptimize(g)
    if quant:
        jquantize(g, quant)
    jinfer_shapes(g)
    return g


def test_passes_equal_the_reference():
    """Each pass on the stem graph (fp32 and w8a8: the int8 weight is
    re-packed), on tests/test_ladder.py's toys (fp32 and w8a8: one buffer
    grid, the consumers' x_scale patched), a two-concat chain (kept) and a
    w8a8 chain with one concat's int8 mark removed (a mixed chain, kept):
    the same count and the same graph as the reference's."""
    rng = np.random.default_rng(3)
    cases = []
    for quant in (None, "w8a8"):
        x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
        cases.append((f"stem {quant}", _prepared(_stem(), quant, x),
                      jstem, space_to_depth_stem, 1))
        x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
        cases.append((f"ladder {quant}", _prepared(_toy_ladder(), quant, x),
                      jladders, dus_concat_ladders, 1))
    cases.append(("short chain", _prepared(_toy_ladder(layers=2), None, x),
                  jladders, dus_concat_ladders, 0))
    mixed = _prepared(_toy_ladder(), "w8a8", x)
    del mixed.meta["quant"][next(k for k in mixed.meta["quant"]
                                 if k.startswith("cat1"))]
    cases.append(("mixed chain", mixed, jladders, dus_concat_ladders, 0))
    for what, jg, jpass, tpass, want in cases:
        tg = graph_from_reference(jg)
        n_ref, n_port = jpass(jg), tpass(tg)
        assert n_ref == n_port == want, (what, n_ref, n_port)
        jinfer_shapes(jg)
        infer_shapes(tg)
        _same_graph(jg, tg, what)
        if what.startswith("ladder"):
            ops = [n.op for n in tg.nodes]
            assert "Concat" not in ops and ops.count("LadderAppend") == 3, \
                (what, ops)
        if what == "ladder w8a8":
            grids = [v["y_scale"] for v in tg.meta["quant"].values()
                     if v.get("ladder_int8")]
            assert len(grids) == 4 and len(set(grids)) == 1, grids


def test_s2d_stem_fp32_numbers_and_reload(tmp_path):
    """fp32: the port with ``s2d_stem`` against the JAX engine with it and
    the port without it (rtol = atol = 1e-5, the reference's own test);
    the rewritten graph saved and reloaded infers its shapes (the
    SpaceToDepth shape function is registered with the others) and runs
    to the same output."""
    from feathercnn_tpu_torch.model_format import load_ftpu, save_ftpu
    jg = _stem()
    x = np.random.default_rng(15).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(JEngine(jg, JConfig(s2d_stem=True))(x))
    plain = Engine(graph_from_reference(jg), device="cpu")(x).numpy()
    eng = Engine(graph_from_reference(jg), EngineConfig(s2d_stem=True),
                 device="cpu")
    ops = [n.op for n in eng.graph.nodes]
    assert ops[:2] == ["SpaceToDepth", "Convolution"], ops
    stem = eng.graph.nodes[1]
    assert (stem.attrs["kernel_h"], stem.attrs["stride"]) == (4, 1)
    assert eng.graph.specs[stem.inputs[0]].shape == (1, 19, 19, 12)
    got = eng(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    save_ftpu(eng.graph, str(tmp_path / "s2d.ftpu"))
    again = Engine.from_optimized(load_ftpu(str(tmp_path / "s2d.ftpu")),
                                  device="cpu")
    assert torch.equal(again(x), eng(x))


def test_resnet50_s2d_int8_edges():
    """ResNet-50 w8a8 with ``s2d_stem`` at b1, 64x64: one SpaceToDepth in
    front of a 4x4 s1 stem on 12 channels (int8 weight, float input:
    the float conv path); every int8 edge equals the JAX engine's, node by
    node and end to end."""
    g = jmodels.resnet50()
    g.inputs["data"] = JSpec((1, 64, 64, 3))
    jinfer_shapes(g)
    rng = np.random.default_rng(4)
    jcalibrate(g, [rng.normal(size=(1, 64, 64, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True,
                              s2d_stem=True, **_KW))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", s2d_stem=True, **_KW),
                  device="cpu")
    s2d = [n for n in teng.graph.nodes if n.op == "SpaceToDepth"]
    assert len(s2d) == 1
    stem = teng.graph.nodes[teng.graph.nodes.index(s2d[0]) + 1]
    assert stem.inputs == s2d[0].outputs and stem.attrs["kernel_h"] == 4
    assert teng.graph.params[stem.params[0]].shape == (4, 4, 12, 64)
    assert teng.graph.params[stem.params[0]].dtype == np.int8
    n_int8, _, ref, got = _hold_int8_edges("resnet50 s2d w8a8", jeng, teng,
                                           x)
    assert n_int8 >= 50, n_int8
    out = teng.graph.outputs[0]
    assert ref[out].argmax() == got[out].float().numpy().argmax()


def test_densenet121_ladder_int8_edges():
    """DenseNet-121 w8a8 with ``concat_dus`` at b1, 224x224: 4 ladders, 54
    appends ((6-1) + (12-1) + (24-1) + (16-1), tests/test_ladder.py's
    count); every int8 edge equals the JAX engine's, node by node and end
    to end, each ``__buf`` edge on its filled channels."""
    g = jmodels.densenet121()
    rng = np.random.default_rng(4)
    jcalibrate(g, [rng.normal(size=(1, 224, 224, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(1, 224, 224, 3)).astype(np.float32)
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True,
                              concat_dus=True, **_KW))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", concat_dus=True, **_KW),
                  device="cpu")
    ops = [n.op for n in teng.graph.nodes]
    assert (ops.count("LadderInit"), ops.count("LadderAppend"),
            ops.count("Concat")) == (4, 54, 0), ops
    specs = teng.graph.specs
    filled = {}
    for n in teng.graph.nodes:
        if n.op in ("LadderInit", "LadderAppend"):
            parts = n.inputs if n.op == "LadderInit" else n.inputs[1:]
            filled[n.outputs[0]] = (n.attrs.get("offset", 0)
                                    + sum(specs[p].shape[-1] for p in parts))
    n_int8, _, ref, got = _hold_int8_edges(
        "densenet121 concat_dus w8a8", jeng, teng, x, filled=filled)
    assert n_int8 >= 200, n_int8
    out = teng.graph.outputs[0]
    assert ref[out].argmax() == got[out].float().numpy().argmax()


def test_ladder_appends_in_place():
    """Along a ladder every ``__buf`` value is one storage (each append
    writes its channels into the buffer LadderInit made), each view is a
    prefix of it, and a view taken before a later append keeps its
    values; fp32 and w8a8 outputs equal the JAX engine's with the pass
    (fp32 within the reference's rtol 2e-5 of tests/test_ladder.py, int8
    at 0 LSB)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    jg = _toy_ladder()
    jcalibrate(jg, [x], method="max")
    for kw in ({}, _KW):
        jeng = JEngine(jg, JConfig(backend="pallas", interpret=True,
                                   concat_dus=True, **kw))
        teng = Engine(graph_from_reference(jg),
                      EngineConfig(backend="cuda", concat_dus=True, **kw),
                      device="cpu")
        nodes = teng.graph.nodes
        bufs = [n.outputs[0] for n in nodes
                if n.op in ("LadderInit", "LadderAppend")]
        views = [n.outputs[0] for n in nodes if n.op == "LadderView"]
        assert len(bufs) == len(views) == 4
        env = teng.run(x, extract=bufs + views)
        base = env[bufs[0]]
        for b in bufs:
            assert env[b].data_ptr() == base.data_ptr(), b
        for v in views:
            assert env[v].data_ptr() == base.data_ptr(), v
        # each view's values after the later appends ran
        ref = jeng.run(x, extract=views)
        for v in views:
            want = np.asarray(ref[v], np.float32)
            have = env[v].float().numpy()
            if kw:
                assert np.array_equal(have, want), v
            else:
                np.testing.assert_allclose(have, want, rtol=2e-5, atol=1e-6)
        out = teng.graph.outputs[0]
        np.testing.assert_allclose(
            env[out].float().numpy(), np.asarray(ref[out], np.float32),
            rtol=2.0 ** -7 if kw else 2e-5, atol=1e-6)
