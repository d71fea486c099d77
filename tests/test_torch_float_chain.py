"""The port's float chains (``fuse_chains`` without ``quant``) against the
JAX package, on the CPU.

Full-width ResNet-50 in bf16 with the wildcard region table: the port (its
plain versions on the CPU, the float chains through the dispatcher's
``fused_chain_float``) against the JAX engine with its Pallas kernels in
interpret mode.  Inputs are made from a seed with numpy.

Tolerances, with their reasons:

- each fused node's output edge: within 2e-2 of the edge's largest |value|.
  The two engines sum every float conv and chain in other orders and store
  every edge in bf16, whose step is 2^-8 of a value; an edge that rounds
  the other way feeds every later layer, and over the 50 layers the
  largest difference measured 0.92% of the edge's largest value (two bf16
  steps are 0.78%);
- the output (softmax probabilities): within the reference's 2e-3.
"""

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models import resnet50 as jresnet50
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch as kdispatch
from feathercnn_tpu_torch.weights import graph_from_reference

_FUSED = ("FusedChain", "FusedBottleneck")


def _fused(graph):
    return [(n.name, n.op, n.inputs, n.outputs, n.attrs.get("nb", 1))
            for n in graph.nodes if n.op in _FUSED]


def test_resnet50_bf16_fuse_chains_matches_pallas_interpret(monkeypatch):
    """1x64x64x3 through both engines: the same fused nodes (chains of nb 2,
    3, 5 and stage 5's two single blocks), each fused node's output edge
    and the output within the stated tolerances, and every chain call
    through ``fused_chain_float`` with bf16 x and weights."""
    g = jresnet50(with_softmax=True)
    g.meta["chain_regions"] = {"*": True}
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jeng = JEngine(g, JConfig(fuse_chains=True, compute_dtype="bfloat16",
                              interpret=True))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", compute_dtype="bfloat16",
                               fuse_chains=True), device="cpu")
    assert _fused(teng.graph) == _fused(jeng.graph)
    assert [(n[1], n[4]) for n in _fused(teng.graph)] == [
        ("FusedChain", 2), ("FusedChain", 3), ("FusedChain", 5),
        ("FusedBottleneck", 1), ("FusedBottleneck", 1)]

    calls = []
    chain = kdispatch.fused_chain_float

    def rec(x, w1, *rest, **kw):
        calls.append((x.dtype, w1.dtype, w1.shape[0]))
        return chain(x, w1, *rest, **kw)
    monkeypatch.setattr(kdispatch, "fused_chain_float", rec)

    names = [n[3][0] for n in _fused(teng.graph)]
    want = jeng.run(x, extract=names)
    got = teng.extract(x, names)
    for name in names:
        ref = np.asarray(want[name], np.float32)
        t = got[name]
        assert t.dtype == torch.bfloat16, (name, t.dtype)
        err = float(np.abs(t.float().numpy() - ref).max())
        top = float(np.abs(ref).max())
        print(f"{name}: max |diff| {err} of max |ref| {top} "
              f"({100 * err / top:.2f}%)")
        assert err <= 2e-2 * top, (name, err, top)
    assert calls == [(torch.bfloat16, torch.bfloat16, nb)
                     for nb in (2, 3, 5, 1, 1)]
    np.testing.assert_allclose(teng(x).float().numpy(),
                               np.asarray(jeng(x), np.float32), rtol=2e-3,
                               atol=2e-3)


def test_resnet50_b128_float_chain_graphs_equal_reference():
    """The graphs the two engines build at the batch the chip run serves,
    b128, in bf16 and in f32: the same fused nodes.  bf16 gives chains of
    nb 2, 3, 5 and two single blocks at stage 5 (whose bf16 weights fit the
    reference's VMEM gate one block at a time only); f32 gives nb 3, 2, 2
    and one block, at stages 3-4."""
    g = jresnet50(batch=128, with_softmax=False)
    g.meta["chain_regions"] = {"*": True}
    want = {"bfloat16": [2, 3, 5, 1, 1], "float32": [3, 2, 2, 1]}
    for dt, nbs in want.items():
        jeng = JEngine(g, JConfig(fuse_chains=True, compute_dtype=dt,
                                  interpret=True))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", compute_dtype=dt,
                                   fuse_chains=True), device="cpu")
        assert _fused(teng.graph) == _fused(jeng.graph), dt
        assert [n[4] for n in _fused(teng.graph)] == nbs, dt
        assert [n.op for n in teng.graph.nodes] == \
            [n.op for n in jeng.graph.nodes], dt
