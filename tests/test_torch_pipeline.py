"""The port's pipeline engine (``parallel/pipeline.py``) against the
reference's, on the CPU (stages on ``["cpu"] * S``).

- ``partition_stages`` gives the reference's cuts, live-ins and live-outs
  node for node (pure host arithmetic: equal).
- Each stage holds only its own params.
- SqueezeNet v1.1 through the pipeline in f32 within rtol 1e-4, atol 1e-5
  of the JAX engine (tests/test_parallel.py:247's bound; the frameworks
  sum convs in different orders), and equal to the port's own engine.
- The w8a8 pipeline within rtol 1e-3, atol 1e-4 of the JAX
  ``PipelineEngine`` (tests/test_parallel.py:286's bound), every int8
  value equal to the port's unsharded engine.

Few test items per file (see tests/test_torch_kernels.py for why).
"""

import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.ir import infer_shapes as jinfer_shapes
from feathercnn_tpu.models import MODEL_BUILDERS as JMODELS
from feathercnn_tpu.parallel.pipeline import PipelineEngine as JPipeline
from feathercnn_tpu.parallel.pipeline import \
    partition_stages as jpartition_stages
from feathercnn_tpu.passes import optimize as joptimize
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ir import infer_shapes
from feathercnn_tpu_torch.models import mobilenet_v1
from feathercnn_tpu_torch.parallel import PipelineEngine, partition_stages
from feathercnn_tpu_torch.parallel.launch import to_numpy
from feathercnn_tpu_torch.passes import optimize
from feathercnn_tpu_torch.weights import graph_from_reference


def test_partition_stages_matches_reference():
    jg = JMODELS["resnet50"](batch=1, with_softmax=False)
    tg = graph_from_reference(jg)
    joptimize(jg)
    jinfer_shapes(jg)
    optimize(tg)
    infer_shapes(tg)
    for s in (1, 2, 3, 4, 8):
        want = [([n.name for n in st.nodes], st.live_in, st.live_out)
                for st in jpartition_stages(jg, s)]
        got = [([n.name for n in st.nodes], st.live_in, st.live_out)
               for st in partition_stages(tg, s)]
        assert got == want, s
    with pytest.raises(ValueError, match="num_stages"):
        partition_stages(tg, 0)


def test_stage_params_are_disjoint():
    """MobileNet-v1 over 3 stages: each param on exactly one stage, on that
    stage's device; more stages than devices, or no GPU for the default
    devices, raise."""
    g = mobilenet_v1()
    pipe = PipelineEngine(g, num_stages=3, devices=["cpu"] * 3)
    names = [set(p) for p in pipe._stage_params]
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            assert not (names[i] & names[j])
    assert set().union(*names) == {p for n in pipe.graph.nodes
                                   for p in n.params}
    with pytest.raises(ValueError, match="stages"):
        PipelineEngine(g, num_stages=3, devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineEngine(g, num_stages=2)


def test_float_pipeline_matches_engines():
    jg = JMODELS["squeezenet_v11"]()
    x = np.random.default_rng(3).normal(size=(4, 227, 227, 3)).astype(
        np.float32)
    tg = graph_from_reference(jg)
    want = np.asarray(JEngine(jg)(x))
    own = Engine(tg, device="cpu")(x).numpy()
    pipe = PipelineEngine(tg, num_stages=4, devices=["cpu"] * 4)
    for m in (1, 2):
        got = pipe(x, micro_batches=m).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


def test_int8_pipeline_matches_jax_pipeline():
    """tests/test_parallel.py:272's case: SqueezeNet v1.1 w8a8 (int8 edges)
    over 3 stages with 2 micro-batches."""
    jg = JMODELS["squeezenet_v11"]()
    x = np.random.default_rng(4).normal(size=(2, 227, 227, 3)).astype(
        np.float32)
    jcalibrate(jg, [x], method="max")
    tg = graph_from_reference(jg)
    jcfg = JConfig(backend="pallas", quant="w8a8", interpret=True)
    tcfg = EngineConfig(backend="cuda", quant="w8a8")
    want = np.asarray(JPipeline(jg, jcfg, num_stages=3)(x, micro_batches=2),
                      np.float32)
    pipe = PipelineEngine(tg, tcfg, num_stages=3, devices=["cpu"] * 3)
    got = to_numpy(pipe(x, micro_batches=2))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    eng = Engine(tg, tcfg, device="cpu")
    np.testing.assert_array_equal(got, to_numpy(eng(x)))
    # every int8 value crossing a stage boundary equals the engine's
    cut = [v for st in pipe.stages[1:] for v in st.live_in]
    ref = to_numpy(eng.extract(x, cut))
    carried = {}
    with torch.inference_mode():
        for mb in range(2):
            env = {"data": torch.from_numpy(x[mb:mb + 1])}
            for s, st in enumerate(pipe.stages):
                env.update(pipe._run_stage(s, {v: env[v]
                                               for v in st.live_in}))
            for v in cut:
                carried.setdefault(v, []).append(to_numpy(env[v]))
    int8 = [v for v in cut if ref[v].dtype == np.int8]
    assert int8, cut
    for v in int8:
        np.testing.assert_array_equal(np.concatenate(carried[v]), ref[v])
