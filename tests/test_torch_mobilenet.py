"""MobileNet-v1 and -v2 through the PyTorch port against the JAX package, on
the CPU (the port's kernel wrappers take their plain versions there).

Both engines get the same graph and weights (each builds its own zoo model
from the same seed, or the JAX one is carried across with
``graph_from_reference``), the same calibrated scales and the same numpy
inputs, made from a seed.

Tolerances, with their reasons:

- fp32: the fingerprints of ``tests/goldens.json`` with the tolerances of
  ``tests/test_goldens.py:104-118``, and the JAX engine's full output within
  rtol 1e-4 of its largest magnitude (the two frameworks sum convolutions
  in different orders).
- w8a8 (full width, 1x64x64x3): int8 edges within 1 LSB, top-1 equal and
  prob cosine >= 0.999.  The stem and, in v2, the default route's
  depthwise convs run float convs whose sums the two frameworks take in
  other orders, so a float edge may differ in its last bit and move a
  requantized int8 value by one step downstream.  The test prints how many
  elements differ.
- calibration: the scales within rtol 1e-5 (the float convs sum in another
  order).

Few test items per file: see tests/test_torch_kernels.py.
"""

import json
import os

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.kernels.dispatch import select_algo as jselect_algo
from feathercnn_tpu.models import mobilenet_v1 as jmobilenet_v1
from feathercnn_tpu.models import mobilenet_v2 as jmobilenet_v2
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels.dispatch import select_algo
from feathercnn_tpu_torch.models import mobilenet_v1, mobilenet_v2
from feathercnn_tpu_torch.quant import calibrate
from feathercnn_tpu_torch.weights import graph_from_reference

_MODELS = {"mobilenet_v1": (jmobilenet_v1, mobilenet_v1, "fc7"),
           "mobilenet_v2": (jmobilenet_v2, mobilenet_v2, "fc11")}


def _inputs(seed, shape, n=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _fingerprint(arr):
    """tests/test_goldens.py's fingerprint of an output tensor."""
    out = np.asarray(arr, np.float32).ravel()
    v = np.random.default_rng(20260820 + out.size).standard_normal(
        out.size).astype(np.float32)
    return {"first8": [round(float(v_), 6) for v_ in out[:8]],
            "argmax": int(out.argmax()),
            "sum": round(float(out.sum()), 5),
            "proj": round(float(np.dot(out, v)), 5)}


def _override(g):
    """algo_overrides naming every depthwise conv "depthwise"."""
    return tuple((n.name, "depthwise") for n in g.nodes
                 if n.op == "Convolution" and n.attrs.get("group", 1) > 1)


def test_mobilenet_fp32_matches_golden_and_jax():
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        goldens = json.load(f)
    x = np.random.default_rng(42).normal(
        size=(1, 224, 224, 3)).astype(np.float32)
    for name, (jbuild, build, out) in _MODELS.items():
        # the same graph and seeded weights (HWIO (3, 3, 1, C) for the
        # depthwise convs) as the reference's zoo
        jg, tg = jbuild(with_softmax=False), build(with_softmax=False)
        assert [(n.name, n.op, n.inputs, n.params, n.attrs)
                for n in tg.nodes] == [(n.name, n.op, n.inputs, n.params,
                                        n.attrs) for n in jg.nodes], name
        assert tg.params.keys() == jg.params.keys(), name
        for k, v in jg.params.items():
            np.testing.assert_array_equal(tg.params[k], v, err_msg=k)
        assert tg.meta == jg.meta, name
        ref = goldens[name][out]
        got = Engine(tg, device="cpu")(x).numpy()
        fp = _fingerprint(got)
        # the tolerances of tests/test_goldens.py
        assert fp["argmax"] == ref["argmax"], name
        np.testing.assert_allclose(fp["first8"], ref["first8"], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(fp["sum"], ref["sum"], rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(
            fp["proj"], ref["proj"], rtol=1e-3,
            atol=1e-3 * (1.0 + max(abs(v) for v in fp["first8"])),
            err_msg=name)
        want = np.asarray(JEngine(jg)(x))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_mobilenet_w8a8_matches_reference_on_both_routes():
    """Full-width v1 and v2, full int8 with bf16 float activations, on the
    default route (v1's depthwise convs take the int8 variant; v2's, with
    its baked ``int8_grouped=False``, PyTorch's float grouped conv as the
    reference takes XLA's) and on the "depthwise" override route (the
    float variant), against the JAX engine's Pallas kernels in interpret
    mode."""
    x = _inputs(1, (1, 64, 64, 3))[0]
    for name, (jbuild, _, _) in _MODELS.items():
        g = jbuild(with_softmax=True)
        jcalibrate(g, [x], method="max")
        tg = graph_from_reference(g)
        for route, extra in [("default", {}),
                             ("override", {"algo_overrides": _override(g)})]:
            case = f"{name} {route}"
            jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                                      compute_dtype="bfloat16",
                                      interpret=True, **extra))
            teng = Engine(tg, EngineConfig(backend="cuda", quant="w8a8",
                                           compute_dtype="bfloat16",
                                           **extra), device="cpu")
            names = [o for n in jeng.graph.nodes for o in n.outputs]
            got_all = jeng.run(x, extract=names)
            want = {k: np.asarray(v) for k, v in got_all.items()
                    if np.asarray(v).dtype == np.int8}
            assert len(want) >= 10, (case, len(want))
            got = teng.extract(x, sorted(want))
            off1 = total = 0
            for k, ref in want.items():
                assert got[k].dtype == torch.int8, (case, k, got[k].dtype)
                d = np.abs(got[k].numpy().astype(np.int32) - ref)
                assert d.max() <= 1, (case, k, int(d.max()))
                off1 += int((d == 1).sum())
                total += ref.size
            print(f"{case}: {len(want)} int8 edges, {off1} of {total} "
                  f"elements off by 1 LSB")
            jp = np.asarray(got_all[g.outputs[0]], np.float64).ravel()
            tp = teng(x).double().numpy().ravel()
            assert jp.argmax() == tp.argmax(), case
            cos = jp @ tp / (np.linalg.norm(jp) * np.linalg.norm(tp))
            assert cos >= 0.999, (case, cos)


def test_select_algo_routes_equal_reference():
    """For every conv of both models, as each engine calls it (with
    ``cin * group`` for a grouped conv): the same route.  This pins the
    mirrored quirk that sends depthwise convs to "xla" by default."""
    for name, (jbuild, _, _) in _MODELS.items():
        g = jbuild(batch=1)
        x = _inputs(2, (1, 64, 64, 3))[0]
        jcalibrate(g, [x], method="max")
        jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                                  interpret=True))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", quant="w8a8"),
                      device="cpu")
        routes = {}
        for eng, select in ((jeng, jselect_algo), (teng, select_algo)):
            specs = eng.graph.specs
            quant = eng.graph.meta.get("quant", {})
            r = {}
            for n in eng.graph.nodes:
                if n.op != "Convolution":
                    continue
                cin = specs[n.inputs[0]].shape[-1]
                group = n.attrs.get("group", 1)
                r[n.name] = select(n, cin * group if group > 1 else cin,
                                   n.name in quant)
            routes[select] = r
        want, got = routes[jselect_algo], routes[select_algo]
        assert got == want, name
        dw = [k for k, n in ((n.name, n) for n in teng.graph.nodes)
              if n.attrs.get("group", 1) > 1]
        assert dw and all(want[k] == "xla" for k in dw), name


def test_calibrate_mobilenet_v1_matches_reference_scales():
    """The port's calibrate over its own engine gives the reference's
    scales for MobileNet-v1 within rtol 1e-5."""
    xs = _inputs(4, (1, 64, 64, 3), n=2)
    jg = jmobilenet_v1(with_softmax=True)
    jcalibrate(jg, xs, method="max")
    tg = mobilenet_v1(with_softmax=True)
    scales = calibrate(tg, xs, method="max", device="cpu")
    assert scales.keys() == jg.meta["act_scales"].keys()
    for key in ("act_scales", "value_scales"):
        a, b = jg.meta[key], tg.meta[key]
        assert a.keys() == b.keys(), key
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       err_msg=f"{key}[{k}]")
