"""Each node's device constants made once (``ops/lowering.py::
LoweringCtx.kept``), on the CPU:

- ResNet-50, MobileNet-v1 and ResNeXt-50 from the zoo at 64x64, batch 2,
  w8a8 on the "cuda" backend: two forwards inside ``profiling.record()``.
  The first makes constants (the recorder's ``Kept`` misses); the second
  makes none, finds each constant it looks up among those the first made
  (hits), and makes no tensor from a host number (``torch.tensor`` and
  ``torch.as_tensor`` given anything but a tensor are counted while it
  runs).  The two forwards' outputs are equal bit for bit.
- A small graph with the other sites that turn a number into a tensor: a
  requantizing LRN, a requantizing AVE pool, an int8 Eltwise of three
  operands (PyTorch's ops, not the kernel) and a requantizing Concat of
  an int8, a rescaled int8 and a float operand, held to the same rule.

On the card the same mechanism leaves ``Engine.run`` without a host sync
after the first forward of a shape (``tools/trace_probe.py``).  Few test
items per file: see tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from feathercnn_tpu_torch import Engine, EngineConfig, TensorSpec
from feathercnn_tpu_torch.kernels.eltwise import eltwise_int8
from feathercnn_tpu_torch.models.builder import GraphBuilder
from feathercnn_tpu_torch.models.zoo import build_model
from feathercnn_tpu_torch.quant import calibrate
from feathercnn_tpu_torch.utils import profiling

_KW = dict(backend="cuda", quant="w8a8", compute_dtype="bfloat16")


def _calibrated(g, shape, seed):
    rng = np.random.default_rng(seed)
    calibrate(g, [rng.normal(size=shape).astype(np.float32)], method="max",
              device="cpu")
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _two_forwards(eng, x, monkeypatch):
    """Two forwards inside ``record()``: their outputs, and the types of
    the values that a tensor was made from on the engine's device during
    the second.  Checks the constants each forward made and reused."""
    host = []

    def counted(fn):
        def made_from(data, *args, **kw):
            if not torch.is_tensor(data) and torch.device(
                    kw.get("device") or "cpu") == eng.device:
                host.append(type(data).__name__)
            return fn(data, *args, **kw)
        return made_from

    with profiling.record() as rec:
        first = eng.run(x)
        with monkeypatch.context() as m:
            for name in ("tensor", "as_tensor"):
                m.setattr(torch, name, counted(getattr(torch, name)))
            second = eng.run(x)
    counts = profiling.consts_by_batch(rec)
    assert set(counts) == {0, 1}, counts
    made = {(k.node, k.key) for k in rec.consts if k.made}
    assert counts[0][0] == len(made) > 0
    assert counts[1][0] == 0 and counts[1][1] > 0, counts
    assert {(k.node, k.key) for k in rec.consts if k.batch == 1} <= made
    return first, second, host


@pytest.mark.parametrize("name", ["resnet50", "mobilenet_v1", "resnext50"])
def test_the_cells_nets_make_their_constants_once(name, monkeypatch):
    g = build_model(name, batch=2)
    g.inputs["data"] = TensorSpec((2, 64, 64, 3))
    x = _calibrated(g, (2, 64, 64, 3), 11)
    eng = Engine(g, EngineConfig(**_KW), device="cpu")
    first, second, host = _two_forwards(eng, x, monkeypatch)
    assert host == [], host
    for k, v in first.items():
        assert v.dtype == second[k].dtype and torch.equal(v, second[k]), k


def test_the_other_sites_make_their_constants_once(monkeypatch):
    b = GraphBuilder("sites", seed=4)
    x = b.input("data", (2, 12, 12, 8))
    c1 = b.conv("c1", x, 16, 3, pad=1, relu=True)
    p1 = b.pool("p1", b.lrn("l1", c1), 3, 1, pad=1, mode="AVE")
    a = b.conv("a", p1, 16, 1, relu=True)
    bb = b.conv("b", a, 16, 1, relu=True)
    c = b.conv("c", bb, 16, 1, relu=True)
    d = b.conv("d", b.eltwise("e", [a, bb, c]), 16, 1, relu=True)
    cat = b.concat("cat", [d, a, b.sigmoid("s", d)])
    g = b.finish([b.fc("fc", b.conv("f", cat, 8, 1, relu=True), 10)])
    x = _calibrated(g, (2, 12, 12, 8), 3)
    eng = Engine(g, EngineConfig(**_KW), device="cpu")
    q = eng.graph.meta["quant"]
    assert q["l1"].get("requant_int8") and q["p1"].get("requant_int8")
    assert q["e"].get("eltwise_int8") and len(q["e"]["in_scales"]) == 3
    assert q["cat"].get("concat_int8")
    fallbacks = eltwise_int8.fallbacks
    first, second, host = _two_forwards(eng, x, monkeypatch)
    assert eltwise_int8.fallbacks == fallbacks + 2
    assert host == [], host
    for k, v in first.items():
        assert torch.equal(v, second[k]), k
