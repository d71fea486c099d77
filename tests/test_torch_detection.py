"""The detection families of the PyTorch port — MobileNet-SSD, VGG16-SSD300,
Faster R-CNN VGG16 and R-FCN ResNet-101 — against the JAX package, on the
CPU (the port's kernel wrappers take their plain versions there).

Both engines get the same graph and weights (each builds its own zoo model
from the same seed, or the JAX one is carried across with
``graph_from_reference``), the same calibrated scales and the same numpy
inputs, made from a seed; the two-stage models take ``im_info`` [h, w, 1]
(``feathercnn_tpu/utils/timing.py::default_extra_inputs``).  The SSDs run
at their 300x300, the two-stage models at the goldens' CI size (96 x 128,
``tests/test_goldens.py:39-43``) and batch 1.  Tolerances, with their
reasons:

- the builders: the same nodes, attributes, specs, baked
  ``config_overrides`` and bit-equal weights; ``MODEL_BUILDERS`` holds the
  reference's 28 models;
- fp32: the head's input tensors (``mbox_loc`` and ``mbox_conf_flatten``,
  or ``rpn_cls_prob_reshape`` and ``rpn_bbox_pred``) meet the fingerprints
  of ``tests/goldens.json`` with the tolerances of
  ``tests/test_goldens.py:104-118``;
- the head, node by node (each head node run by the port on the
  reference's own input values, in fp32 and under w8a8): DetectionOutput's,
  Proposal's and ROIPooling's outputs equal to the bit; PSROIPooling
  within 2^-20 of its largest magnitude (the port sums each bin in f64,
  the reference in an f32 einsum);
- fp32 end to end: the head's inputs differ from the reference's by the
  f32 sums of the backbone in another order (a few ulps), which the
  rows carry: the same labels in the same order, scores within 2^-16 of
  1 and box coordinates within 1e-4 of the row's scale (SSD) or 0.05
  pixels (Proposal: ``exp`` of a delta magnifies its last bits); a row
  pair whose scores lie within 2^-16 may swap places (printed);
- w8a8 (bf16 activations): every int8 edge equal, node by node and end to
  end (0 LSB); every float edge node by node within 1 bf16 ulp or 1e-5
  of its largest value; end to end the head's rows equal wherever its
  inputs are (the inputs compared first, printed).

Few test items per file: see tests/test_torch_kernels.py.  Two torch
intra-op threads while the module runs (``_two_threads``, as
tests/test_torch_zoo_rest.py says why).
"""

import functools
import json
import os

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models import MODEL_BUILDERS as J_BUILDERS
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu.utils.timing import default_extra_inputs
from feathercnn_tpu_torch import models
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ops.lowering import lower_node
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _fingerprint, _same_graph, _to_torch
from test_torch_zoo_rest import _two_threads  # noqa: F401

_MODELS = ("mobilenet_ssd", "vgg16_ssd300", "faster_rcnn_vgg16",
           "rfcn_resnet101")
# tests/test_goldens.py:39-43
CI_SIZES = {"faster_rcnn_vgg16": dict(size=(96, 128), pre_nms_top_n=200,
                                      post_nms_top_n=32),
            "rfcn_resnet101": dict(size=(96, 128), post_nms_top_n=32)}
HEAD_OPS = ("DetectionOutput", "Proposal", "ROIPooling", "PSROIPooling")


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The reference's and the port's model at the CI size, batch 1."""
    kw = CI_SIZES.get(name, {})
    return J_BUILDERS[name](**kw), models.build_model(name, **kw)


def _feed(g, seed):
    """A seeded image, and ``im_info`` where the model takes it."""
    x = np.random.default_rng(seed).normal(
        size=g.inputs["data"].shape).astype(np.float32)
    feed = {"data": x}
    feed.update(default_extra_inputs(g))
    return feed


def test_builders_build_the_reference_graphs():
    """The four builders at the CI sizes, and MobileNet-SSD at another
    batch and seed: the reference's graphs, with the baked
    ``config_overrides`` (MobileNet-SSD's ``det_thresh_first``,
    VGG16-SSD300's three); the port's zoo holds all 28 of the
    reference's models."""
    assert set(models.MODEL_BUILDERS) == set(J_BUILDERS)
    for name in _MODELS:
        _same_graph(*_pair(name), name)
    _same_graph(J_BUILDERS["mobilenet_ssd"](batch=3, seed=2),
                models.mobilenet_ssd(batch=3, seed=2), "mobilenet_ssd b3")
    assert _pair("mobilenet_ssd")[1].meta["config_overrides"] == {
        "det_thresh_first": 512}
    assert _pair("vgg16_ssd300")[1].meta["config_overrides"] == {
        "topk_radix": False, "det_take_gather": True,
        "det_thresh_first": 1024}


def _edges(jeng, teng, feed):
    """Every value of the reference's optimized graph as numpy, and each
    port node's outputs when the node runs on the reference's own input
    values (the graph inputs cast as each engine casts them)."""
    names = [o for n in jeng.graph.nodes for o in n.outputs]
    ref = {k: np.asarray(v) for k, v in jeng.run(feed, extract=names).items()}
    cdt = getattr(torch, teng.config.compute_dtype)
    env = {k: _to_torch(v) for k, v in ref.items()}
    for k, v in feed.items():
        t = torch.from_numpy(v)
        env[k] = t.to(cdt) if t.dim() == 4 else t
    params = teng._prepare_params()
    mine = {}
    with torch.inference_mode():
        for n in teng.graph.nodes:
            outs = lower_node(n, [env[i] for i in n.inputs],
                              [params[p] for p in n.params], teng._ctx)
            mine.update(zip(n.outputs, outs))
    return ref, mine


def _hold_head(case, teng, ref, mine):
    """The module docstring's node-by-node gates on the head nodes; returns
    the number of kept rows."""
    kept = 0
    for n in teng.graph.nodes:
        if n.op not in HEAD_OPS:
            continue
        o = n.outputs[0]
        r, t = ref[o].astype(np.float32), mine[o].float().numpy()
        if n.op == "PSROIPooling":
            assert np.abs(t - r).max() <= 2.0 ** -20 * np.abs(r).max(), \
                (case, o)
            continue
        assert np.array_equal(t, r), (case, n.op, o)
        if n.op == "DetectionOutput":
            kept += int((t[..., 1] >= 0).sum())
        elif n.op == "Proposal":
            kept += int((t[:, 0] >= 0).sum())
    return kept


def _rows_e2e(name, w, t):
    """fp32 end-to-end rows (the module docstring's gate); the number of
    swapped pairs."""
    if w.ndim == 3:                                  # DetectionOutput
        w, t = w.reshape(-1, 7), t.reshape(-1, 7)
        lab, score, box, atol = 1, 2, slice(3, 7), None
    else:                                            # Proposal
        lab, score, box, atol = 0, None, slice(1, 5), 0.05
    swaps = 0
    for i in np.nonzero(w[:, lab] != t[:, lab])[0]:
        # a swap of two rows of near-equal scores
        j = i + 1 if i + 1 < len(w) and w[i, lab] == t[i + 1, lab] else i - 1
        assert score is not None and abs(w[i, score] - w[j, score]) \
            <= 2.0 ** -16, (name, i, w[i], t[i])
        t[[i, j]] = t[[j, i]]
        swaps += 1
    assert np.array_equal(w[:, lab], t[:, lab]), name
    if score is not None:
        assert np.abs(w[:, score] - t[:, score]).max() <= 2.0 ** -16, name
    scale = np.abs(w[:, box]).max(-1, keepdims=True)
    tol = atol if atol is not None else 1e-4 * np.maximum(scale, 1.0)
    assert (np.abs(w[:, box] - t[:, box]) <= tol).all(), (
        name, float(np.abs(w[:, box] - t[:, box]).max()))
    return swaps // 2


def test_fp32_goldens_and_heads():
    """Each model in fp32: the head's inputs meet their goldens; the head
    node by node equal to the reference's; the rows end to end within the
    fp32 gate (the module docstring's)."""
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        goldens = json.load(f)
    for name in _MODELS:
        jg, tg = _pair(name)
        feed = _feed(tg, 42)
        jeng, teng = JEngine(jg), Engine(tg, device="cpu")
        head = next(n for n in teng.graph.nodes if n.op in HEAD_OPS)
        out = head.outputs[0]
        got = teng.run(feed, extract=list(head.inputs[:2]) + [out])
        for blob, ref in goldens[name].items():
            fp = _fingerprint(got[blob].numpy())
            assert fp["argmax"] == ref["argmax"], (name, blob)
            np.testing.assert_allclose(fp["first8"], ref["first8"],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}/{blob}")
            np.testing.assert_allclose(fp["sum"], ref["sum"], rtol=1e-4,
                                       err_msg=f"{name}/{blob}")
            np.testing.assert_allclose(
                fp["proj"], ref["proj"], rtol=1e-3,
                atol=1e-3 * (1.0 + max(abs(v) for v in fp["first8"])),
                err_msg=f"{name}/{blob}")
        ref, mine = _edges(jeng, teng, feed)
        kept = _hold_head(name, teng, ref, mine)
        swaps = _rows_e2e(name, ref[out].copy(), got[out].numpy().copy())
        print(f"{name} fp32: goldens met, the head equal node by node "
              f"({kept} rows kept), end to end within the gate with "
              f"{swaps} near-tied pairs swapped")


def _w8a8(name, seed):
    """The calibrated reference model at the CI size, the JAX engine
    (Pallas in interpret mode) and the port's, w8a8 bf16, and a seeded
    feed."""
    g = J_BUILDERS[name](**CI_SIZES.get(name, {}))
    jcalibrate(g, [_feed(g, seed)], method="max")
    q = dict(quant="w8a8", compute_dtype="bfloat16")
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **q))
    teng = Engine(graph_from_reference(g), EngineConfig(backend="cuda", **q),
                  device="cpu")
    return jeng, teng, _feed(g, seed + 1)


def _hold_w8a8(name, seed):
    """The module docstring's w8a8 gates on one model."""
    jeng, teng, feed = _w8a8(name, seed)
    ref, mine = _edges(jeng, teng, feed)
    int8 = [k for k, v in ref.items() if v.dtype == np.int8]
    for o, t in mine.items():
        r = ref[o]
        if r.dtype == np.int8:
            assert t.dtype == torch.int8 and np.array_equal(t.numpy(), r), \
                (name, o)
            continue
        assert t.dtype != torch.int8, (name, o)
        r, tf = r.astype(np.float32), t.float().numpy()
        assert (np.abs(tf - r) <= 2.0 ** -7 * np.maximum(np.abs(r), np.abs(tf))
                + 1e-5 * np.abs(r).max()).all(), (name, o)
    kept = _hold_head(name, teng, ref, mine)
    head = next(n for n in teng.graph.nodes if n.op in HEAD_OPS)
    blobs = [i for i in head.inputs if i in ref]
    got = teng.run(feed, extract=int8 + blobs + [head.outputs[0]])
    for k in int8:
        assert np.array_equal(got[k].numpy(), ref[k]), (name, k)
    apart = {i: int((got[i].float().numpy() != ref[i].astype(np.float32))
                    .sum()) for i in blobs}
    out = head.outputs[0]
    rows_apart = int((got[out].numpy() != ref[out]).any(-1).sum())
    if not any(apart.values()):
        assert rows_apart == 0, name
    print(f"{name} w8a8: {len(int8)} int8 edges equal node by node and end "
          f"to end; the head equal node by node ({kept} rows kept); end to "
          f"end its input values apart {apart}, its rows apart {rows_apart}")
    return teng


def test_ssd_w8a8_int8_edges_and_rows():
    """MobileNet-SSD (13 depthwise convs on the int8 depthwise path, the
    reference's default "xla" branch) and VGG16-SSD300 (fc6 at d = 6 on the
    dilated int8 conv, an f32 Normalize) under w8a8."""
    for i, name in enumerate(("mobilenet_ssd", "vgg16_ssd300")):
        teng = _hold_w8a8(name, 10 + 2 * i)
        if name == "vgg16_ssd300":
            fc6 = next(n for n in teng.graph.nodes if n.name == "fc6")
            assert fc6.attrs["dilation"] == 6


def test_two_stage_w8a8_int8_edges_and_rois():
    """Faster R-CNN VGG16 (fc6/fc7 on the pooled ROIs) and R-FCN ResNet-101
    (stage 5 at d = 2, the vote Softmax on logits that reach +-1e6) under
    w8a8, with ``im_info``."""
    for i, name in enumerate(("faster_rcnn_vgg16", "rfcn_resnet101")):
        teng = _hold_w8a8(name, 20 + 2 * i)
        if name == "rfcn_resnet101":
            dil = [n.attrs["dilation"] for n in teng.graph.nodes
                   if n.attrs.get("dilation", 1) > 1]
            assert dil == [2, 2, 2], dil
