"""Full-width, full-int8 (w8a8, bf16 activations) runs of ResNeXt-50 (its
grouped int8 convs on the implicit-GEMM kernel as super-groups, each
column tile reading its own groups' channels) and DenseNet-121 (its standalone int8 Scales) through the PyTorch
port against the JAX package, on the CPU, one image at full size;
tests/test_torch_se_inception_shufflenet_int8.py takes SE-ResNet-50,
Inception-v3 and ShuffleNet v1/v2 with these helpers.

Both engines take ``algo_overrides=(("*", "xla"),)`` (Pallas interpret mode
is too slow at this size): the int8 convs then run XLA's int8 conv in the
reference (``feature_group_count`` for the grouped ones) and the port's
GEMM kernels (plain versions) with the same folded scale.  Every int8
edge equals the reference's, node by node (each port node run on the
reference's own input edges) and end to end.

Few test items per file: see tests/test_torch_kernels.py.
"""

import numpy as np

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import models as jmodels
from feathercnn_tpu.ir import TensorSpec, infer_shapes
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_zoo_rest import _hold_int8_edges, _two_threads  # noqa: F401

_KW = dict(quant="w8a8", compute_dtype="bfloat16",
           algo_overrides=(("*", "xla"),))


def _engines(name, size=None):
    """The reference's zoo model at b1 (its input ``size`` x ``size`` where
    given), calibrated on one seeded image, its engine and the port's on
    the same graph, and a seeded image."""
    g = getattr(jmodels, name)()
    if size is not None:
        g.inputs["data"] = TensorSpec((1, size, size, 3))
        infer_shapes(g)
    spec = next(iter(g.inputs.values()))
    rng = np.random.default_rng(4)
    jcalibrate(g, [rng.normal(size=spec.shape).astype(np.float32)],
               method="max")
    x = rng.normal(size=spec.shape).astype(np.float32)
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **_KW))
    teng = Engine(graph_from_reference(g), EngineConfig(backend="cuda", **_KW),
                  device="cpu")
    return jeng, teng, x


def _top1_and_cosine(name, teng, ref, got):
    out = teng.graph.outputs[0]
    jp = ref[out].astype(np.float64).ravel()
    tp = got[out].double().numpy().ravel()
    assert jp.argmax() == tp.argmax(), name
    cos = jp @ tp / (np.linalg.norm(jp) * np.linalg.norm(tp))
    assert cos >= 0.999, (name, cos)
    return cos


def test_resnext50_grouped_int8_convs():
    """ResNeXt-50: its 16 grouped 3x3 convs (cardinality 32; 4 to 32
    channels a group, stride 2 in the first block of stages 3-5) take int8
    edges and run through ``conv2d_implicit_gemm`` on the super-group
    route (``groups=32``, the compact weight 32 channels wide: q = 32 /
    (C/32) groups a column tile), each call recorded; every int8 edge
    equals the reference's."""
    jeng, teng, x = _engines("resnext50")
    calls = []
    orig = dispatch.conv2d_implicit_gemm

    def record(xq, w, *a, **kw):
        calls.append((tuple(xq.shape), tuple(w.shape), kw.get("stride"),
                      kw.get("groups", 1)))
        return orig(xq, w, *a, **kw)

    grouped = [n for n in teng.graph.nodes if n.attrs.get("group", 1) > 1]
    assert len(grouped) == 16
    # the node-by-node run and the end-to-end forward launch each once
    dispatch.conv2d_implicit_gemm = record
    try:
        n_int8, _, ref, got = _hold_int8_edges("resnext50 w8a8", jeng, teng,
                                               x)
    finally:
        dispatch.conv2d_implicit_gemm = orig
    dense = [c for c in calls if c[1][2] == 32 and c[1][3] == c[0][3]
             and c[3] == 32 and c[0][3] in (128, 256, 512, 1024)]
    assert len(calls) == len(dense) == 2 * 16, calls
    assert sorted({(c[0][3], c[2]) for c in dense}) == [
        (128, 1), (256, 1), (256, 2), (512, 1), (512, 2), (1024, 1),
        (1024, 2)]
    int8 = {k for k, v in ref.items() if v.dtype == np.int8}
    for n in grouped:
        assert n.inputs[0] in int8 and n.outputs[0] in int8, n.name
    assert n_int8 >= 60, n_int8
    _top1_and_cosine("resnext50", teng, ref, got)


def test_densenet121_int8_scale_chain():
    """DenseNet-121: each dense layer's pre-activation BN+Scale+ReLU after
    a Concat is a standalone int8 Scale (``requant_int8``); every int8
    edge equals the reference's."""
    jeng, teng, x = _engines("densenet121")
    q = teng.graph.meta["quant"]
    scales = [n.name for n in teng.graph.nodes if n.op == "Scale"]
    requant = [s for s in scales if q.get(s, {}).get("requant_int8")]
    assert len(requant) >= 58, (len(requant), len(scales))
    n_int8, _, ref, got = _hold_int8_edges("densenet121 w8a8", jeng, teng,
                                           x)
    assert n_int8 >= 200, n_int8
    _top1_and_cosine("densenet121", teng, ref, got)
