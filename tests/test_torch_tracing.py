"""The port's recorder (``feathercnn_tpu_torch/utils/profiling.py::record``)
on the CPU:

- off by default, it records nothing;
- inside it, one ``Engine.run`` is one ``run`` span, one ``node`` span
  for the input's cast and one per graph node, in graph order, nested in
  the run and sharing its batch id, on the plain walk and on the sharded
  walk of a one-rank mesh;
- a sync reported inside a node span is that node's, one outside a run is
  not counted, and the sync debug mode set before it is set again after;
- the node span still opens the node's ``record_function`` range under a
  profiler, so ``profiling.trace()`` writes a range named after a node.

The CPU has no CUDA syncs: the tests raise PyTorch's own warning text, as
``set_sync_debug_mode("warn")`` raises it on the card.  Few test items per
file: see tests/test_torch_kernels.py.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.models.builder import GraphBuilder
from feathercnn_tpu_torch.ops import lowering
from feathercnn_tpu_torch.ops.lowering import LoweringCtx
from feathercnn_tpu_torch.parallel import ShardingConfig
from feathercnn_tpu_torch.parallel.mesh import build_mesh
from feathercnn_tpu_torch.utils import profiling

SYNC = ("called a synchronizing CUDA operation (Triggered internally at "
        "c10/cuda/CUDAFunctions.cpp:1.)")


def _net():
    """A conv, a residual add, a pool and an FC."""
    b = GraphBuilder("t", seed=3)
    x = b.input("data", (2, 8, 8, 4))
    y = b.conv("c1", x, 4, 3, pad=1, relu=True)
    y = b.eltwise("add", [x, y])
    y = b.pool("p", y, 2, 2)
    return b.finish([b.fc("fc", y, 5)])


def _x():
    return np.random.default_rng(0).normal(size=(2, 8, 8, 4)).astype(
        np.float32)


def _one_rank_sharded():
    """An engine that walks its nodes through ``_forward_sharded`` on a
    mesh of one rank (``Engine`` itself takes the plain walk there)."""
    cfg = EngineConfig(sharding=ShardingConfig(mesh_shape=(1, 1)))
    eng = Engine(_net(), cfg, device="cpu")
    eng._mesh = build_mesh(cfg.sharding)
    eng._ctx = LoweringCtx(eng._local, eng.config, eng.device,
                           mesh=eng._mesh, tp={})
    return eng


def test_recording_is_off_by_default():
    eng = Engine(_net(), device="cpu")
    assert profiling._recorder is None
    assert profiling.run_scope().wrap(lowering.lower_node) is \
        lowering.lower_node
    eng(_x())
    with profiling.record() as rec:
        pass
    eng(_x())
    assert rec.spans == [] and rec.syncs == [] and rec.anchor_ns == []
    assert profiling._recorder is None


def test_one_run_span_and_a_node_span_per_input_and_node():
    plain = Engine(_net(), device="cpu")
    sharded = _one_rank_sharded()
    for eng in (plain, sharded):
        want = eng(_x())
        with profiling.record() as rec:
            for _ in range(2):
                assert torch.equal(eng(_x()), want)
        runs = [s for s in rec.spans if s.kind == "run"]
        assert [r.batch for r in runs] == [0, 1]
        assert all(r.parent is None and r.name == "run" for r in runs)
        for run in runs:
            nodes = [s for s in rec.spans if s.parent == run.id]
            assert [(s.kind, s.name, s.op) for s in nodes] == [
                ("node", "data", "Input")] + [
                ("node", n.name, n.op) for n in eng.graph.nodes]
            assert all(s.batch == run.batch for s in nodes)
            assert all(run.t0_ns <= a.t0_ns <= a.t1_ns <= b.t0_ns
                       <= b.t1_ns <= run.t1_ns
                       for a, b in zip(nodes, nodes[1:]))
        assert len(rec.spans) == 2 * (2 + len(eng.graph.nodes))
        assert rec.syncs == []


def test_a_sync_is_its_nodes_and_the_mode_comes_back(monkeypatch):
    eng = Engine(_net(), device="cpu")
    real = lowering._LOWERINGS["Pooling"]

    def pool_that_syncs(node, *args):
        warnings.warn(SYNC)
        return real(node, *args)

    monkeypatch.setitem(lowering._LOWERINGS, "Pooling", pool_that_syncs)
    (pool,) = [n for n in eng.graph.nodes if n.op == "Pooling"]
    with profiling.record() as rec:
        warnings.warn(SYNC)                 # outside a run: not counted
        eng(_x())
        with pytest.warns(UserWarning, match="not a sync"):
            warnings.warn("not a sync")     # shown as ever
    (run,) = [s for s in rec.spans if s.kind == "run"]
    assert [(s.batch, s.node, s.op) for s in rec.syncs] == [
        (run.batch, pool.name, "Pooling")]
    # the line that made the call, here this file's
    assert rec.syncs[0].site.endswith(
        f"test_torch_tracing.py:{pool_that_syncs.__code__.co_firstlineno + 1}")
    assert run.t0_ns <= rec.syncs[0].t_ns <= run.t1_ns
    with pytest.warns(UserWarning, match="synchronizing"):
        warnings.warn(SYNC)                 # shown again after the block

    # the sync debug mode, on a host that reports a card
    mode = {"now": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now=m))
    with profiling.record():
        assert mode["now"] == "warn"
    assert mode["now"] == 2
    with pytest.raises(RuntimeError, match="already open"):
        with profiling.record():
            with profiling.record():
                pass
    assert mode["now"] == 2 and profiling._recorder is None


def test_trace_holds_a_range_per_node(tmp_path):
    eng = Engine(_net(), device="cpu")
    with profiling.trace(str(tmp_path / "tb")) as logdir:
        with profiling.record() as rec:
            eng(_x())
    (name,) = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    assert {n.name for n in eng.graph.nodes} <= ranges
    assert [s.name for s in rec.spans if s.kind == "node"] == ["data"] + [
        n.name for n in eng.graph.nodes]
