"""The segmentation family of the PyTorch port — FCN-32s/16s/8s,
DeepLab-LargeFOV and PSPNet-50 — and its ops (Deconvolution, Interp,
Crop, SPP, ArgMax) against the JAX package, on the CPU.

Both engines get the same graph and weights (each builds its own zoo model
from the same seed, or the JAX one is carried across with
``graph_from_reference``) and the same numpy inputs, made from a seed.
Tolerances, with their reasons:

- the builders: the same nodes, attributes, specs, baked
  ``config_overrides`` and bit-equal weights;
- fp32 models: the fingerprints of ``tests/goldens.json`` at the goldens'
  CI sizes (``tests/test_goldens.py:39-43``: PSPNet 89, DeepLab 65, FCN
  96) with the tolerances of ``tests/test_goldens.py:104-118``;
- the ops on small cases, f32: Crop, ArgMax and a MAX SPP equal; the
  Deconvolution, Interp and an AVE SPP within 1e-5 of the output's
  largest magnitude (f32 sums in another order than XLA's); bf16: within
  1 bf16 ulp of the larger of the two values, or 1e-5 of the largest
  magnitude (the f32 sums, rounded to bf16, may round to either side of
  a value on a bf16 midpoint, and leave ~1e-8 where XLA's cancel to 0).

Few test items per file: see tests/test_torch_kernels.py.  Two torch
intra-op threads while the module runs (``_two_threads``, as
tests/test_torch_zoo_rest.py says why).
"""

import functools
import json
import os

import numpy as np

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import models as jmodels
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu_torch import models
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _fingerprint, _same_graph
from test_torch_zoo_rest import _reference_edges, _two_threads  # noqa: F401

_MODELS = ("fcn32s", "fcn16s", "fcn8s", "deeplab_largefov", "pspnet50")
# tests/test_goldens.py:39-43
CI_SIZES = {"pspnet50": dict(size=89, num_classes=21),
            "deeplab_largefov": dict(size=65),
            "fcn32s": dict(size=96), "fcn16s": dict(size=96),
            "fcn8s": dict(size=96)}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The reference's and the port's model at the CI size, batch 1, seed
    0, without the Softmax (the goldens' graph)."""
    kw = dict(CI_SIZES[name], with_softmax=False)
    return getattr(jmodels, name)(**kw), models.build_model(name, **kw)


def test_builders_build_the_reference_graphs():
    """The five builders at the CI sizes, DeepLab also at its deploy size
    and at another batch and seed with its Softmax: the reference's
    graphs; PSPNet keeps its baked ``avepool_matmul`` and
    ``nested_pools``.  (The weights depend on the channels alone, so the
    FCNs' 134M are drawn once per package, at the CI size.)"""
    for name in _MODELS:
        assert name in models.MODEL_BUILDERS, name
        _same_graph(*_pair(name), name)
    for kw in ({}, dict(size=97, batch=3, seed=2)):
        _same_graph(jmodels.deeplab_largefov(**kw),
                    models.deeplab_largefov(**kw), f"deeplab {kw}")
    assert _pair("pspnet50")[1].meta["config_overrides"] == {
        "avepool_matmul": True, "nested_pools": True}


def test_fp32_goldens():
    """The golden blob of each model (the scores before the Softmax), one
    image at the CI size, meets its fingerprint with tests/test_goldens.py's
    tolerances, and the JAX engine's full output within rtol 1e-4 and 1e-4
    of its largest magnitude.  PSPNet's first8 takes an absolute floor of
    1e-5 x max|y|, as its full output does: its scores reach ~2.6e3 after
    50 conv layers, and the f32 sums in another order than XLA's (every
    output within 2e-6 of the largest) move a small score such as 5.23 by
    ~1e-3, over the goldens' rtol 1e-4 of that value."""
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        goldens = json.load(f)
    for name in _MODELS:
        jg, tg = _pair(name)
        x = np.random.default_rng(42).normal(
            size=tg.inputs["data"].shape).astype(np.float32)
        ((blob, ref),) = goldens[name].items()
        got = Engine(tg, device="cpu").run(x)[blob].numpy()
        fp = _fingerprint(got)
        assert fp["argmax"] == ref["argmax"], name
        deep = name == "pspnet50"
        np.testing.assert_allclose(fp["first8"], ref["first8"], rtol=1e-4,
                                   atol=1e-5 * np.abs(got).max() if deep
                                   else 1e-6, err_msg=name)
        np.testing.assert_allclose(fp["sum"], ref["sum"], rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(
            fp["proj"], ref["proj"], rtol=1e-3,
            atol=1e-3 * (1.0 + max(abs(v) for v in fp["first8"])),
            err_msg=name)
        want = np.asarray(JEngine(jg)(x))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=(1e-5 if deep else 1e-4)
                                   * np.abs(want).max(), err_msg=name)


def _ops_graph():
    """Every segmentation op on small shapes, each reading the input, in
    each of its forms: Deconvolution through the subpixel plan (k4 s2,
    k16 s8, k8 s4 pad 2 with 2 groups and a fused ReLU) and the textbook
    form (stride 1 at dilation 2; k2 s3, whose plan would need a negative
    pad); Interp by zoom, shrink, height and width, and negative pads;
    Crop on H and W and on the channel axis; SPP MAX and AVE over 3 levels
    of an odd map; ArgMax along the channels (top 1, top 3, top 2 values)
    and over the whole image."""
    b = JBuilder("segops", seed=4)
    x = b.input("data", (2, 9, 11, 8))
    outs = [b.deconv("dc_k4s2", x, 6, 4, stride=2, bias=False),
            b.deconv("dc_k16s8", x, 5, 16, stride=8),
            b.deconv("dc_k8s4p2", x, 4, 8, stride=4, pad=2, group=2,
                     relu=True),
            b.deconv("dc_dil2", x, 3, 3, stride=1, pad=1, dilation=2),
            b.deconv("dc_k2s3", x, 3, 2, stride=3)]
    outs += [b.interp("ip_zoom", x, zoom_factor=4),
             b.interp("ip_shrink", x, shrink_factor=2),
             b.interp("ip_hw", x, height=17, width=6),
             b.interp("ip_pad", x, zoom_factor=3, pad_beg=-1, pad_end=-2)]
    outs.append(b.crop("crop_hw", outs[1], x, axes=(1, 2), offsets=(3, 5)))
    outs.append(b.crop("crop_c", x, outs[0], axes=(3,), offsets=(2,)))
    outs += [b.spp("spp_max", x, 3), b.spp("spp_ave", x, 3, mode="AVE")]
    outs += [b.argmax("am_c", x, axis=-1),
             b.argmax("am_top3", x, axis=-1, top_k=3),
             b.argmax("am_val", x, axis=-1, top_k=2, out_max_val=True),
             b.argmax("am_flat", x, axis=None, top_k=4, out_max_val=True)]
    return b.finish(outs)


def test_segmentation_ops_match_reference():
    """The ops graph in f32 and bf16 against the JAX engine, every output
    within its tolerance (the module docstring's); the Crop of a
    Deconvolution's output equal to the same window of the port's own."""
    g = _ops_graph()
    tg = graph_from_reference(g)
    x = np.random.default_rng(5).normal(size=(2, 9, 11, 8)).astype(
        np.float32)
    exact = {"crop_c", "spp_max", "am_c", "am_top3", "am_val", "am_flat"}
    for dt in ("float32", "bfloat16"):
        want = {k: np.asarray(v.astype(np.float32)) for k, v in
                JEngine(g, JConfig(compute_dtype=dt)).run(x).items()}
        got = {k: v.float().numpy() for k, v in
               Engine(tg, EngineConfig(compute_dtype=dt), device="cpu")
               .run(x).items()}
        for k in g.outputs:
            w, t = want[k], got[k]
            assert t.shape == w.shape, (k, dt, t.shape, w.shape)
            err = np.abs(t - w)
            if k in exact:
                assert err.max() == 0, (k, dt, float(err.max()))
            elif dt == "float32":
                assert err.max() <= 1e-5 * np.abs(w).max(), (k, err.max())
            else:
                assert (err <= 2.0 ** -7 * np.maximum(np.abs(w), np.abs(t))
                        + 1e-5 * np.abs(w).max()).all(), (k, dt,
                                                          float(err.max()))
        assert np.array_equal(got["crop_hw"],
                              got["dc_k16s8"][:, 3:12, 5:16]), dt


def test_pspnet_pyramid_pools_and_fcn_crops():
    """PSPNet's baked pyramid: after ``nested_pools`` the 1x1, 2x2 and 3x3
    bins read the 6x6 bin's output, and in fp32 each bin, and every other
    node, run on the reference's own input values (node by node), is
    within 1e-5 of its largest value (window sums and conv sums of up to
    4,608 products in another order than XLA's); FCN's crops keep the reference's geometry (the score map back
    at the input's size)."""
    jg, tg = _pair("pspnet50")
    x = np.random.default_rng(6).normal(size=(1, 89, 89, 3)).astype(
        np.float32)
    teng = Engine(tg, device="cpu")
    nodes = {n.name: n for n in teng.graph.nodes}
    for b in (1, 2, 3):
        assert nodes[f"pool{b}x{b}"].inputs == ["pool6x6"], b
    ref, mine = _reference_edges(JEngine(jg), teng, x)
    for k, t in mine.items():
        r = ref[k]
        assert np.abs(t.numpy() - r).max() <= 1e-5 * np.abs(r).max(), k
    for name in ("fcn32s", "fcn16s", "fcn8s"):
        g = _pair(name)[1]
        crops = {n.name: n.attrs["offsets"] for n in g.nodes
                 if n.op == "Crop"}
        assert g.specs["score"].shape[1:3] == (96, 96), name
        assert crops["score"] == {32: [19, 19], 16: [27, 27],
                                  8: [31, 31]}[int(name[3:-1])], name
