"""The recorder's grouped conv routes (``utils/profiling.py::Route``, each
one where ``kernels/dispatch.py::conv_forward`` picks the route) on the
CPU:

- ResNeXt-50 from the zoo at 64x64, w8a8 on the "cuda" backend: each
  forward inside ``record()`` gives one ``"supergroup"`` route for each of
  its 16 grouped 3x3 convs, in graph order, with q = 32 / (C/32) (8, 4, 2
  and 1 by stage), and none on the block-diagonal weight or PyTorch's
  float conv; nothing is recorded once the block has ended;
- a grouped 1x1 conv and a grouped 3x3 conv that no q fits give
  ``"block_diagonal"``, one at q = 1 ``"supergroup"``, a depthwise conv
  ``"depthwise"``, and each of them ``"float"`` with ``int8_grouped``
  off.

Few test items per file: see tests/test_torch_kernels.py.
"""

import numpy as np

from feathercnn_tpu_torch import Engine, EngineConfig, TensorSpec
from feathercnn_tpu_torch.models.builder import GraphBuilder
from feathercnn_tpu_torch.models.zoo import build_model
from feathercnn_tpu_torch.quant import calibrate
from feathercnn_tpu_torch.utils import profiling

_KW = dict(backend="cuda", quant="w8a8", compute_dtype="bfloat16")


def _calibrated(g, shape, seed):
    rng = np.random.default_rng(seed)
    calibrate(g, [rng.normal(size=shape).astype(np.float32)], method="max",
              device="cpu")
    return rng.normal(size=shape).astype(np.float32)


def test_resnext50_grouped_convs_take_the_supergroup_route():
    g = build_model("resnext50", batch=2)
    g.inputs["data"] = TensorSpec((2, 64, 64, 3))
    x = _calibrated(g, (2, 64, 64, 3), 7)
    eng = Engine(g, EngineConfig(**_KW), device="cpu")
    grouped = [n.name for n in eng.graph.nodes if n.attrs.get("group", 1) > 1]
    assert len(grouped) == 16
    with profiling.record() as rec:
        for _ in range(2):
            eng(x)
    q_of_stage = {"2": 8, "3": 4, "4": 2, "5": 1}
    assert rec.routes == [
        profiling.Route(batch, name, "supergroup", q_of_stage[name[3]])
        for batch in (0, 1) for name in grouped]
    eng(x)
    assert len(rec.routes) == 32
    assert profiling._recorder is None


def test_every_route_is_named():
    b = GraphBuilder("routes", seed=5)
    x = b.input("data", (2, 12, 12, 32))
    y = b.conv("g1x1", x, 64, 1, group=4, relu=True)
    y = b.conv("g3x3", y, 64, 3, pad=1, group=2, relu=True)  # q = 1
    # 16 channels in and 12 out a group: no q
    y = b.conv("g3x3_no_q", y, 48, 3, pad=1, group=4, relu=True)
    y = b.conv("dw", y, 48, 3, pad=1, group=48, relu=True)
    g = b.finish([b.fc("fc", y, 10)])
    x = _calibrated(g, (2, 12, 12, 32), 8)
    want = {"g1x1": ("block_diagonal", 0), "g3x3_no_q": ("block_diagonal", 0),
            "dw": ("depthwise", 0), "g3x3": ("supergroup", 1)}
    for int8_grouped in (True, False):
        eng = Engine(g, EngineConfig(int8_grouped=int8_grouped, **_KW),
                     device="cpu")
        with profiling.record() as rec:
            eng(x)
        got = {r.node: (r.route, r.q) for r in rec.routes}
        assert [r.batch for r in rec.routes] == [0] * 4
        assert got == (want if int8_grouped
                       else {n: ("float", 0) for n in want}), got
