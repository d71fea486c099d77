"""The port's sharded ``Engine`` (``EngineConfig(sharding=...)``) against the
unsharded port and the JAX engine, on the CPU.

Each sharded engine runs on 4 gloo ranks started by
``parallel.launch.spawn``; every rank gets the same global input and hands
back the global outputs.  The graphs are the reference's tests' own
(``qnet`` and ``meshy`` of tests/test_parallel.py, the dry-run graph of
``__graft_entry__.py``) and its flagship, ResNet-50 b4 at 64x64 w8a8; and
the mesh rules against the reference's.
Tolerances, with their reasons:

- every int8 edge of a rank's forward equals the unsharded port's (0 LSB):
  a TP node's channel slice, a DP batch slice and a spatial shard sum each
  output's int8 products exactly and apply the same f32 epilogue;
- every output within the reference's own bound, rtol 1e-3 and atol 1e-4
  (``__graft_entry__.py:108-109``), of the JAX engine on one device and
  of the JAX engine under the same mesh;
- ResNet-50's top-1 equal.

Few test items per file (see tests/test_torch_kernels.py for why).
"""

import os

import numpy as np
import pytest

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models import resnet50 as jresnet50
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.parallel import ShardingConfig as JSharding
from feathercnn_tpu.parallel import build_mesh as jbuild_mesh
from feathercnn_tpu.parallel import mesh as jmesh
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.model_format import save_ftpu
from feathercnn_tpu_torch.parallel import PipelineEngine, ShardingConfig
from feathercnn_tpu_torch.parallel import mesh as tmesh
from feathercnn_tpu_torch.parallel.tp import shard_graph
from feathercnn_tpu_torch.parallel.launch import (collectives_rank,
                                                  engine_rank, spawn,
                                                  to_numpy)
from feathercnn_tpu_torch.weights import graph_from_reference

BOUND = dict(rtol=1e-3, atol=1e-4)
JQ = JConfig(backend="pallas", quant="w8a8", interpret=True,
             algo_overrides=(("*", "xla"),))
TQ = EngineConfig(backend="cuda", quant="w8a8", algo_overrides=(("*", "xla"),))


def _qnet():
    b = JBuilder("qnet", seed=15)
    x = b.input("data", (8, 8, 8, 8))
    y = b.conv("c1", x, 32, 3, pad=1, relu=True)
    y = b.conv("c2", y, 64, 1, relu=True)
    y = b.conv("c3", y, 32, 1, relu=True)
    y = b.pool("gap", y, 0, mode="AVE", global_pooling=True)
    return b.finish([b.fc("fc", y, 8)])


def _meshy():
    b = JBuilder("meshy", seed=9)
    x = b.input("data", (8, 8, 8, 8))
    x = b.conv("stem", x, 16, 3, pad=1, relu=True)
    y = b.conv("g1", x, 16, 1, group=4, relu=True)
    y = b.shuffle_channel("shuf", y, 4)
    y = b.conv("g2", y, 16, 1, group=4)
    s = b.pool("gp", y, 0, mode="AVE", global_pooling=True)
    s = b.conv("down", s, 4, 1, relu=True)
    s = b.conv("up", s, 16, 1)
    s = b.sigmoid("prob", s)
    z = b.relu("axpy_relu", b.axpy("axpy", s, y, x))
    z = b.conv("head", z, 16, 1, relu=True)
    z = b.pool("gap", z, 0, mode="AVE", global_pooling=True)
    return b.finish([b.fc("fc", z, 8)])


def _dryrun_graph():
    """The dry-run graph of ``__graft_entry__.py``: a grouped conv, a
    shuffle, an SE gate and Axpy, a merged sibling pair, an FC."""
    b = JBuilder("dryrun", seed=0)
    x = b.input("data", (4, 16, 16, 8))
    y = b.relu("conv1_relu", b.bn_scale("conv1_bnsc", b.conv(
        "conv1", x, 32, 3, stride=1, pad=1, bias=False)))
    sc = b.conv("proj", y, 64, 1, bias=False)
    z = b.conv("b2a", y, 32, 1, relu=True)
    z = b.conv("b2b", z, 32, 3, pad=1, relu=True)
    z = b.conv("b2c", z, 64, 1)
    s = b.relu("add_relu", b.eltwise("add", [sc, z]))
    q = b.conv("g1", s, 64, 1, group=4, relu=True)
    q = b.shuffle_channel("shuf", q, 4)
    q = b.conv("g2", q, 64, 1, group=4)
    gate = b.pool("se_gp", q, 0, mode="AVE", global_pooling=True)
    gate = b.sigmoid("se_prob", b.conv("se_up", gate, 64, 1))
    s = b.relu("se_relu", b.axpy("se_axpy", gate, q, s))
    s = b.pool("gap", s, 0, mode="AVE", global_pooling=True)
    return b.finish([b.softmax("prob", b.fc("fc", s, 16))])


def _values(eng, x):
    """Every value of the engine's optimized graph, as numpy."""
    names = [o for n in eng.graph.nodes for o in n.outputs]
    return names, to_numpy(eng.run(x, extract=names))


def _held(label, jg, tcfg, jcfg, meshes, x):
    """The port under each mesh (4 ranks) against the unsharded port (every
    int8 value equal, every rank), and its output against the JAX engine
    on one device and under the same mesh (``BOUND``)."""
    tg = graph_from_reference(jg)
    names, want = _values(Engine(tg, tcfg, device="cpu"), x)
    j1 = np.asarray(JEngine(jg, jcfg)(x), np.float32)
    out = tg.outputs[0]
    for scfg in meshes:
        ranks = spawn(engine_rank, 4, args=(
            tg, tcfg.replace(sharding=ShardingConfig(**scfg)), x, names,
            "cpu"))
        jm = np.asarray(JEngine(jg, jcfg.replace(
            sharding=JSharding(**scfg)))(x), np.float32)
        edges = 0
        for r, got in enumerate(ranks):
            for k in names:
                if want[k].dtype == np.int8:
                    edges += 1
                    assert got[k].dtype == np.int8, (label, k)
                    bad = int((got[k] != want[k]).sum())
                    assert bad == 0, f"{label} {scfg} rank {r} {k}: {bad}"
            for ref, what in ((j1, "JAX"), (jm, "JAX under the mesh")):
                np.testing.assert_allclose(got[out], ref, **BOUND,
                                           err_msg=f"{label} {scfg} {what}")
        assert edges or tcfg.quant is None, f"{label}: no int8 edge"
    return want[out], j1


def test_qnet_int8_dp_tp():
    """tests/test_parallel.py's ``qnet`` (its first conv takes int8 on
    C_in = 8) under DP x TP (2, 2), TP (1, 4) and spatial (1, 4)."""
    jg = _qnet()
    x = np.random.default_rng(0).normal(size=(8, 8, 8, 8)).astype(
        np.float32)
    jcalibrate(jg, [x], method="max")
    _held("qnet", jg, TQ, JQ, [dict(mesh_shape=(2, 2)),
                              dict(mesh_shape=(1, 4)),
                              dict(mesh_shape=(1, 4), shard_spatial=True)],
          x)


def test_meshy_float_and_int8_dp_tp():
    """``meshy``: grouped convs (replicated under TP), a ShuffleChannel, an
    SE gate and Axpy, under (2, 2): in f32 on the "torch" backend, then
    w8a8 on the "cuda" backend (its kernels' plain versions here)."""
    jg = _meshy()
    x = np.random.default_rng(1).normal(size=(8, 8, 8, 8)).astype(
        np.float32)
    _held("meshy f32", jg, EngineConfig(), JConfig(),
          [dict(mesh_shape=(2, 2))], x)
    jcalibrate(jg, [x], method="max")
    _held("meshy w8a8", jg, EngineConfig(backend="cuda", quant="w8a8"),
          JConfig(backend="pallas", quant="w8a8", interpret=True),
          [dict(mesh_shape=(2, 2))], x)


def test_dryrun_graph_ring_overlap():
    """The dry-run graph in f32 with ``ring_overlap`` on the "torch"
    backend (its TP 1x1 convs and FC through the ring collective matmul)
    under (2, 2) and TP (1, 4); the softmax rows sum to 1.  Under TP
    (1, 4) the ring takes the place of channel all-gathers: each rank runs
    3 rings and 5 gathers where it ran 7 gathers without ``ring_overlap``,
    and no ring on the "cuda" backend, which keeps its kernels on column
    slices."""
    jg = _dryrun_graph()
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 8)).astype(
        np.float32)
    cfg = EngineConfig(compute_dtype="float32")
    want, _ = _held("dryrun", jg, cfg, JConfig(compute_dtype="float32"),
                    [dict(mesh_shape=(2, 2), ring_overlap=True),
                     dict(mesh_shape=(1, 4), ring_overlap=True)], x)
    np.testing.assert_allclose(want.sum(), 4.0, rtol=1e-3)
    tg = graph_from_reference(jg)
    calls = {}
    for backend in ("torch", "cuda"):
        for ring in (False, True):
            sharded = cfg.replace(backend=backend, sharding=ShardingConfig(
                mesh_shape=(1, 4), ring_overlap=ring))
            ranks = spawn(collectives_rank, 4, args=(tg, sharded, x, "cpu"))
            for outs, _ in ranks:
                np.testing.assert_allclose(outs[tg.outputs[0]], want,
                                           **BOUND)
            calls[backend, ring] = ranks[0][1]
            assert all(c == calls[backend, ring] for _, c in ranks)
    ring, plain = calls["torch", True], calls["torch", False]
    # 3 rings: conv1's output, read by proj and b2a, and b2b's, read by
    # b2c, are no longer gathered
    assert plain == {"gather_channels": 7, "allgather_matmul": 0}, calls
    assert ring == {"gather_channels": 5, "allgather_matmul": 3}, calls
    assert calls["cuda", True] == calls["cuda", False] == plain, calls


def test_resnet50_w8a8_dp_tp_spatial_pipeline(tmp_path):
    """The flagship of ``__graft_entry__.py``: ResNet-50 b4 at 64x64,
    w8a8, seeded weights, through a ``.ftpu`` file each rank loads, under
    DP x TP (2, 2) and spatial (1, 4) (halos at conv1 and stages 2-4, pool1
    and stage 5's stride-2 input gathered), and a 2-stage pipeline on
    ``["cpu"] * 2`` with 2 micro-batches; top-1 equal to the JAX
    engine's."""
    jg = jresnet50(batch=4, with_softmax=False)
    x = np.random.default_rng(1).normal(size=(4, 64, 64, 3)).astype(
        np.float32) * 0.1
    jcalibrate(jg, [x], method="max")
    tg = graph_from_reference(jg)
    path = os.path.join(tmp_path, "resnet50.ftpu")
    save_ftpu(tg, path)
    names, want = _values(Engine(tg, TQ, device="cpu"), x)
    j1 = np.asarray(JEngine(jg, JQ)(x), np.float32)
    out = tg.outputs[0]
    for scfg in (dict(mesh_shape=(2, 2)),
                 dict(mesh_shape=(1, 4), shard_spatial=True)):
        ranks = spawn(engine_rank, 4, args=(
            path, TQ.replace(sharding=ShardingConfig(**scfg)), x, names,
            "cpu"))
        jm = np.asarray(JEngine(jg, JQ.replace(
            sharding=JSharding(**scfg)))(x), np.float32)
        for r, got in enumerate(ranks):
            for k in names:
                if want[k].dtype == np.int8:
                    bad = int((got[k] != want[k]).sum())
                    assert bad == 0, f"{scfg} rank {r} {k}: {bad} differ"
            for ref in (j1, jm):
                np.testing.assert_allclose(got[out], ref, **BOUND,
                                           err_msg=str(scfg))
                assert (got[out].argmax(-1) == ref.argmax(-1)).all()
    pipe = PipelineEngine(tg, TQ, num_stages=2, devices=["cpu"] * 2)
    got = to_numpy(pipe(x, micro_batches=2))
    np.testing.assert_array_equal(got, want[out])
    np.testing.assert_allclose(got, j1, **BOUND)
    assert (got.argmax(-1) == j1.argmax(-1)).all()


def _depthwise(name, groups, cout, seed):
    b = JBuilder(name, seed=seed)
    x = b.input("data", (2, 8, 8, groups))
    x = b.conv("dw", x, cout, 3, pad=1, group=groups, relu=True)
    return b.finish([b.conv("pw", x, 24, 1)])


def test_mesh_rules_match_reference():
    """``param_shardings``, ``value_pspec`` and the input and output
    layouts give the reference's (grouped convs replicate, depthwise and
    ungrouped ones split on C_out where it divides) on meshes (2, 2),
    (1, 4) spatial and (2, 4); ``build_mesh`` refuses a mesh larger than
    the world (one process here).  A depthwise conv of channel multiplier
    2 runs under TP (1, 4) and (2, 2), each rank on the input channels its
    outputs read, against the unsharded port and the JAX engine
    (``_held``); one whose groups do not divide the model axis is
    refused."""
    from feathercnn_tpu.ir import infer_shapes
    from feathercnn_tpu.passes import optimize
    jg = _dryrun_graph()
    jg_dw = _depthwise("dw", 16, 16, 1)
    for g in (jg, jg_dw):
        optimize(g)
        infer_shapes(g)
        tg = graph_from_reference(g)
        for shape, spatial in (((2, 2), False), ((1, 4), True),
                               ((2, 4), False)):
            jcfg = JSharding(mesh_shape=shape, shard_spatial=spatial)
            tcfg = tmesh.ShardingConfig(mesh_shape=shape,
                                        shard_spatial=spatial)
            jm = jbuild_mesh(jcfg)
            tm = tmesh.Mesh(dict(zip(tcfg.axis_names, shape)),
                            dict.fromkeys(tcfg.axis_names, 0),
                            dict.fromkeys(tcfg.axis_names))
            want = {k: tuple(s.spec) + (None,) * (
                np.ndim(g.params[k]) - len(s.spec))
                for k, s in jmesh.param_shardings(g, jm, jcfg).items()}
            assert tmesh.param_shardings(tg, tm, tcfg) == want, (g.name,
                                                                 shape)
            for name, spec in g.specs.items():
                ref = tuple(jmesh.value_pspec(jcfg, jm, spec.shape))
                ref += (None,) * (len(spec.shape) - len(ref))
                assert tmesh.value_pspec(tcfg, tm, spec.shape) == ref, name
            for got, ref in (
                    (tmesh.input_shardings(tg, tm, tcfg),
                     jmesh.input_shardings(g, jm, jcfg)),
                    (tmesh.output_shardings(tg, tm, tcfg, tg.outputs),
                     jmesh.output_shardings(g, jm, jcfg, g.outputs))):
                assert got.keys() == ref.keys()
                for k, v in ref.items():
                    want = tuple(v.spec) + (None,) * (len(got[k])
                                                      - len(v.spec))
                    assert got[k] == want, k
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        tmesh.build_mesh(tmesh.ShardingConfig(mesh_shape=(2, 2)))
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 16)).astype(
        np.float32)
    _held("depthwise x2", _depthwise("dw2", 16, 32, 3),
          EngineConfig(compute_dtype="float32"),
          JConfig(compute_dtype="float32"),
          [dict(mesh_shape=(1, 4)), dict(mesh_shape=(2, 2))], x)
    tcfg = tmesh.ShardingConfig(mesh_shape=(1, 4))
    tm = tmesh.Mesh({"data": 1, "model": 4}, {"data": 0, "model": 1},
                    {"data": None, "model": None})
    with pytest.raises(ValueError, match="6 groups and 24 outputs"):
        shard_graph(graph_from_reference(_depthwise("dw6", 6, 24, 4)), tm,
                    tcfg)
