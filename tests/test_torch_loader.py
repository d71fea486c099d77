"""The ``.ftpu`` loader of the PyTorch port (``model_format.py``,
``Engine.from_path``, ``from_optimized``, ``compile``, ``summary``) against
the JAX package, on the CPU.

The Caffe deploys of ``tools/deploys`` (ResNet-50 and SqueezeNet v1.1),
with seeded weights from ``tools/synth_caffemodel.py``, are converted by
the reference's ``tools/convert_caffe.py`` and saved by its ``save_ftpu``;
both packages load the file.  Tolerances, with their reasons:

- the loaded graphs: the same nodes, attributes, specs and meta, every
  weight bit-equal;
- fp32 outputs: the goldens' (``tests/test_goldens.py:104-118``): rtol 1e-4
  of the largest magnitude (the two frameworks sum convolutions in other
  orders);
- w8a8: every int8 edge equal to the JAX engine's (Pallas in interpret
  mode), node by node and end to end (0 LSB);
- a file either package writes is byte-identical to the other's and loads
  in the other to the same graph;
- ``summary()``: the reference's string, character for character.

Few test items per file: see tests/test_torch_kernels.py.  Two torch
intra-op threads while the module runs (``_two_threads``, as
tests/test_torch_zoo_rest.py says why).
"""

import os
import sys

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu import model_format as jformat
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch import model_format
from feathercnn_tpu_torch import models
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ir import infer_shapes
from feathercnn_tpu_torch.quant import calibrate
from test_torch_classic_zoo import _hold_int8_edges, _same_graph
from test_torch_zoo_rest import _two_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEPLOYS = os.path.join(ROOT, "tools", "deploys")


def _converted(name, tmp_path, batch):
    """``tools/deploys/<name>_deploy.prototxt`` with seeded synthetic
    weights, converted by the reference's converter and written by its
    ``save_ftpu``: the file's path."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from convert_caffe import convert
    from synth_caffemodel import synth_net
    deploy = os.path.join(DEPLOYS, f"{name}_deploy.prototxt")
    with open(deploy) as f:
        data = synth_net(f.read(), seed=0)
    weights = str(tmp_path / f"{name}.caffemodel")
    with open(weights, "wb") as f:
        f.write(data)
    path = str(tmp_path / f"{name}.ftpu")
    jformat.save_ftpu(convert(deploy, weights, batch=batch), path)
    return path


def _loaded_alike(path):
    """Both packages' ``load_ftpu`` of ``path``: the same graph."""
    jg, tg = jformat.load_ftpu(path), model_format.load_ftpu(path)
    from feathercnn_tpu.ir import infer_shapes as jinfer
    jinfer(jg)
    infer_shapes(tg)
    _same_graph(jg, tg, path)
    return jg, tg


def test_converted_deploys_load_and_run_alike(tmp_path):
    """ResNet-50 and SqueezeNet v1.1, converted from their deploys: both
    loaders give the same graph and weights, and each engine's
    ``from_path`` the same fp32 output (ResNet-50 at 224x224, SqueezeNet at
    its deploy's 227x227, 2 images)."""
    rng = np.random.default_rng(0)
    for name, hw in (("resnet50", 224), ("squeezenet_v11", 227)):
        path = _converted(name, tmp_path, batch=2)
        _loaded_alike(path)
        x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
        want = np.asarray(JEngine.from_path(path, prefer_native=False)(x))
        teng = Engine.from_path(path, prefer_native=False, device="cpu")
        got = teng(x).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        assert (got.reshape(2, -1).argmax(-1)
                == want.reshape(2, -1).argmax(-1)).all(), name


def test_converted_deploys_w8a8_int8_edges(tmp_path):
    """The converted deploys calibrated by the reference and saved with
    their scales: loaded by both packages and run under w8a8 (bf16), every
    int8 edge equal node by node and end to end (ResNet-50 at 224x224, 1
    image; SqueezeNet v1.1 at 227x227, 2 images)."""
    rng = np.random.default_rng(1)
    for name, hw, nb in (("resnet50", 224, 1), ("squeezenet_v11", 227, 2)):
        path = _converted(name, tmp_path, batch=nb)
        g = jformat.load_ftpu(path, mmap_weights=False)
        g.params = {k: np.array(v) for k, v in g.params.items()}
        jcalibrate(g, [rng.normal(size=(nb, hw, hw, 3)).astype(np.float32)],
                   method="max")
        cal = str(tmp_path / f"{name}_calibrated.ftpu")
        jformat.save_ftpu(g, cal)
        _loaded_alike(cal)
        x = rng.normal(size=(nb, hw, hw, 3)).astype(np.float32)
        kw = dict(quant="w8a8", compute_dtype="bfloat16")
        jeng = JEngine.from_path(cal, JConfig(backend="pallas",
                                              interpret=True, **kw),
                                 prefer_native=False)
        teng = Engine.from_path(cal, EngineConfig(backend="cuda", **kw),
                                device="cpu")
        n_int8, _, _, _ = _hold_int8_edges(f"{name} loaded w8a8", jeng,
                                           teng, x)
        assert n_int8 >= 10, (name, n_int8)


def test_save_ftpu_round_trips_between_packages(tmp_path):
    """A calibrated port-built model written by the port's ``save_ftpu``
    loads in the reference to the same graph, and the reference's file of
    that graph loads in the port; the two files are byte-identical.  A
    loaded graph runs through ``Engine.from_optimized`` (no passes) to the
    output of the engine that optimized it."""
    rng = np.random.default_rng(2)
    g = models.squeezenet_v11(batch=2)
    calibrate(g, [rng.normal(size=(2, 227, 227, 3)).astype(np.float32)],
              method="max", device="cpu")
    mine, theirs = str(tmp_path / "port.ftpu"), str(tmp_path / "ref.ftpu")
    model_format.save_ftpu(g, mine)
    jg = jformat.load_ftpu(mine)
    jformat.save_ftpu(jg, theirs)
    with open(mine, "rb") as f, open(theirs, "rb") as h:
        assert f.read() == h.read()
    back = model_format.load_ftpu(theirs)
    infer_shapes(back)
    _same_graph(g, back, "round trip")
    _loaded_alike(theirs)
    cfg = EngineConfig(backend="cuda", quant="w8a8", compute_dtype="bfloat16")
    built = Engine(back, cfg, device="cpu")
    opt = str(tmp_path / "optimized.ftpu")
    model_format.save_ftpu(built.graph, opt)
    again = Engine.from_optimized(model_format.load_ftpu(opt), cfg,
                                  device="cpu")
    assert [n.name for n in again.graph.nodes] == \
        [n.name for n in built.graph.nodes]
    x = rng.normal(size=(2, 227, 227, 3)).astype(np.float32)
    assert torch.equal(again(x), built(x))


def test_summary_and_compile_match_reference(tmp_path):
    """``Engine.summary()`` (and ``top=5``) gives the reference's string for
    the same graph in fp32, bf16 and w8a8, and ``compile(batch)`` runs one
    forward at the declared shape (the kept constants made)."""
    rng = np.random.default_rng(3)
    path = _converted("squeezenet_v11", tmp_path, batch=1)
    g = jformat.load_ftpu(path)
    jcalibrate(g, [rng.normal(size=(1, 227, 227, 3)).astype(np.float32)],
               method="max")
    cal = str(tmp_path / "cal.ftpu")
    jformat.save_ftpu(g, cal)
    for kw in ({}, {"compute_dtype": "bfloat16"},
               {"quant": "w8a8", "compute_dtype": "bfloat16"}):
        jeng = JEngine.from_path(cal, JConfig(**kw), prefer_native=False)
        teng = Engine.from_path(cal, EngineConfig(**kw), device="cpu")
        for top in (None, 5):
            assert teng.summary(top=top) == jeng.summary(top=top), (kw, top)
    teng = Engine.from_path(cal, EngineConfig(
        backend="cuda", quant="w8a8", compute_dtype="bfloat16"),
        device="cpu")
    assert not teng._ctx._consts and teng._device_params is None
    teng.compile(batch=2)
    assert teng._ctx._consts and teng._device_params is not None
    assert "TOTAL:" in teng.summary(top=5).splitlines()[-1]


def test_from_path_prefer_native_loads_the_same(tmp_path):
    """``prefer_native`` has no effect in the port: either value loads the
    file through ``load_ftpu`` to the same engine graph."""
    g = models.resnet50(batch=1)
    path = str(tmp_path / "r50.ftpu")
    model_format.save_ftpu(g, path)
    ref = Engine(g, device="cpu")
    for prefer_native in (True, False):
        eng = Engine.from_path(path, prefer_native=prefer_native,
                               device="cpu")
        assert [(n.name, n.op) for n in eng.graph.nodes] == \
            [(n.name, n.op) for n in ref.graph.nodes]
        for k, v in ref.graph.params.items():
            np.testing.assert_array_equal(eng.graph.params[k], v, err_msg=k)
