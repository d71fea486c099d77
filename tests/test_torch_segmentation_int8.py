"""The segmentation family under full int8 (``quant="w8a8"``, bf16) through
the PyTorch port against the JAX engine (Pallas in interpret mode), on
the CPU at the goldens' CI sizes: DeepLab-LargeFOV at 65 (its conv5 at
dilation 2 and fc6 at 12 on the dilated int8 conv), PSPNet-50 at 89 (its
stages 4-5 at dilation 2 and 4, the requantizing AVE pools of its baked
``avepool_matmul`` pyramid, derived by ``nested_pools``) and FCN-8s at 96
(its Deconvolutions on bf16 edges).

Both engines get the same calibrated graph and the same numpy inputs,
made from a seed.  Tolerances, with their reasons:

- node by node (each port node on the reference's own input values):
  every int8 edge equal (0 LSB); every float edge within 1 bf16 ulp of the
  larger of the two values or 1e-5 of its largest magnitude (f32 sums in
  another order, rounded to bf16, may round to either side); but FCN's
  upsampling head (the float edges from its first Deconvolution on),
  within 1% of the edge's largest magnitude: inside the reference's
  compiled head a Deconvolution does not read the bf16 edge that the
  reference shows (measured: its output is up to 0.034 off an exact
  deconvolution of that edge at values near 4.4, where the same lowering
  run alone is within 3e-6; XLA keeps excess precision inside a fusion),
  while the port rounds each edge to bf16 (up to 0.4% of a value);
- end to end: every int8 edge equal, but downstream of an Interp: the
  Interp's f32 products (two dense products, as the reference's) are
  summed in XLA's CPU dot in an order that its emitter picks by shape (an
  FMA chain at some, separate roundings at others), so an Interp output
  on a bf16 midpoint may round the other way and move the int8 values
  that follow it by 1 LSB: there at most 1 LSB, in at most 0.1% of an
  edge's values.

Few test items per file: see tests/test_torch_kernels.py.  Two torch
intra-op threads while the module runs (``_two_threads``, as
tests/test_torch_zoo_rest.py says why).
"""

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import models as jmodels
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_zoo_rest import _reference_edges, _two_threads  # noqa: F401


def _engines(name, kw, seed):
    """The calibrated reference model, both engines under w8a8 bf16, and
    one seeded input."""
    rng = np.random.default_rng(seed)
    g = getattr(jmodels, name)(**kw)
    jcalibrate(g, [rng.normal(size=g.inputs["data"].shape).astype(
        np.float32)], method="max")
    x = rng.normal(size=g.inputs["data"].shape).astype(np.float32)
    q = dict(quant="w8a8", compute_dtype="bfloat16")
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **q))
    teng = Engine(graph_from_reference(g), EngineConfig(backend="cuda", **q),
                  device="cpu")
    return jeng, teng, x


def _downstream(graph, op):
    """The values computed from an output of a node of ``op``."""
    out = set()
    for n in graph.nodes:
        if n.op == op or any(i in out for i in n.inputs):
            out.update(n.outputs)
    return out


def _hold(case, jeng, teng, x):
    """The module docstring's gates; returns the reference's edges and the
    number of int8 edges."""
    ref, mine = _reference_edges(jeng, teng, x)
    int8 = [k for k, v in ref.items() if v.dtype == np.int8]
    head = _downstream(teng.graph, "Deconvolution")
    for o, t in mine.items():
        r = ref[o]
        if r.dtype != np.int8:
            assert t.dtype != torch.int8, (case, o)
            r = r.astype(np.float32)
            tf = t.float().numpy()
            err = np.abs(tf - r)
            if o in head:
                assert err.max() <= 1e-2 * np.abs(r).max(), (case, o,
                                                             err.max())
                continue
            assert (err <= 2.0 ** -7 * np.maximum(np.abs(r), np.abs(tf))
                    + 1e-5 * np.abs(r).max()).all(), (case, o, err.max())
            continue
        assert t.dtype == torch.int8, (case, o, t.dtype)
        n_off = int((t.numpy() != r).sum())
        assert n_off == 0, f"{case} {o}: {n_off} int8 values differ"
    after = _downstream(teng.graph, "Interp")
    got = teng.extract(x, int8)
    moved = {}
    for k in int8:
        d = np.abs(got[k].numpy().astype(np.int32) - ref[k])
        if k in after:
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
                (case, k, int(d.max()), int((d > 0).sum()))
            moved[k] = int((d > 0).sum())
        else:
            assert d.max() == 0, \
                f"{case} {k}: {int((d > 0).sum())} int8 values differ"
    print(f"{case}: {len(int8)} int8 edges equal node by node; end to end "
          f"equal but after an Interp: {moved}")
    return ref, len(int8)


def test_deeplab_w8a8_int8_edges():
    """DeepLab-LargeFOV at 65: the four dilated convs take and emit int8
    edges, and every int8 edge is the reference's."""
    jeng, teng, x = _engines("deeplab_largefov", dict(size=65), 0)
    ref, n_int8 = _hold("deeplab_largefov w8a8", jeng, teng, x)
    dilated = {n.name: n.attrs["dilation"] for n in teng.graph.nodes
               if n.attrs.get("dilation", 1) > 1}
    assert dilated == {"conv5_1": 2, "conv5_2": 2, "conv5_3": 2, "fc6": 12}
    for name in dilated:
        node = next(n for n in teng.graph.nodes if n.name == name)
        assert ref[node.inputs[0]].dtype == np.int8, name
        assert ref[node.outputs[0]].dtype == np.int8, name
    assert n_int8 >= 15, n_int8


def test_pspnet_w8a8_int8_edges():
    """PSPNet-50 at 89 under its baked ``avepool_matmul`` and
    ``nested_pools``: its nine dilated convs and its four requantizing
    pyramid pools (int8 in, int8 out) equal the reference's node by node,
    and every int8 edge end to end (the Interp allowance after the
    pyramid's Interps)."""
    jeng, teng, x = _engines("pspnet50", dict(size=89, num_classes=21), 1)
    assert teng.config.avepool_matmul and teng.config.nested_pools
    ref, n_int8 = _hold("pspnet50 w8a8", jeng, teng, x)
    q = teng.graph.meta["quant"]
    for b in (1, 2, 3, 6):
        node = next(n for n in teng.graph.nodes if n.name == f"pool{b}x{b}")
        assert q[node.name].get("requant_int8"), node.name
        assert ref[node.inputs[0]].dtype == np.int8, node.name
        assert ref[node.outputs[0]].dtype == np.int8, node.name
    dil = sorted(n.attrs["dilation"] for n in teng.graph.nodes
                 if n.attrs.get("dilation", 1) > 1)
    assert dil == [2] * 6 + [4] * 3, dil
    assert n_int8 >= 60, n_int8


def test_fcn8s_w8a8_edges():
    """FCN-8s at 96: the score convs (N = 21) emit bf16 into the
    Deconvolutions and Crops, and every int8 edge equals the
    reference's."""
    jeng, teng, x = _engines("fcn8s", dict(size=96), 2)
    ref, n_int8 = _hold("fcn8s w8a8", jeng, teng, x)
    for n in teng.graph.nodes:
        if n.op in ("Deconvolution", "Crop"):
            assert ref[n.inputs[0]].dtype != np.int8, n.name
    assert n_int8 >= 15, n_int8
