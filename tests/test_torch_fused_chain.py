"""The port's region fusion (``fuse_blocks`` / ``fuse_chains``) and its
``fused_chain`` against the JAX package, on the CPU.

On the CPU the port's ``fused_chain`` takes its plain version
(``fused_chain_plain``); the reference is the Pallas kernel
``feathercnn_tpu.kernels.fused_chain.fused_chain`` in interpret mode, alone
and inside the JAX engine.  Every input is made from a seed with numpy.

Tolerances, with their reasons:

- int8 mode: equality for every output type (int8, bf16 and f32).  Both
  sides sum the int8 products exactly, turn them to f32 at the same points
  (conv2: one int32 sum where Cm <= 128, else nine per-tap int32 sums
  added in f32, kh outer and kw inner) and round the same f32 steps.  The
  reference's compiled body contracts each ``acc * s + b`` into one FMA,
  and the shortcut's ``+ f32(x) * sx`` into a second one on block 0 only:
  on a later block XLA recomputes the previous block's requant inside the
  add, and the clamp it emits between the product and the add keeps them
  apart.  The f32-out cases pin both rules (with either rule swapped,
  outputs differ), and the saturated case pins the per-tap f32 sum (a
  single int32 sum changes its outputs).
- float mode: the reference's own ``rtol = atol = 2e-3``
  (tests/test_region_fusion.py): the two frameworks sum the f32 dots in
  different orders.
- the engines: every int8 edge equal (0 LSB); outputs within the
  reference's 2e-3.

Each test loops over its cases and names the failing one (few test items
per file: see tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.kernels.fused_chain import fused_chain as jfused_chain
from feathercnn_tpu.models import resnet50 as jresnet50
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch as kdispatch
from feathercnn_tpu_torch.kernels.fused_chain import (fused_chain,
                                                      fused_chain_float,
                                                      kernel_layout)
from feathercnn_tpu_torch.weights import graph_from_reference

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _int8_args(seed, n, h, w, c, cm, nb):
    """Random int8 operands at scales that keep y1, y2 and the output off
    their clip limits."""
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)      # noqa: E731

    def ws(k, cols):
        return (rng.uniform(0.5, 1.5, (nb, cols)) * 1e-3
                / np.sqrt(k)).astype(np.float32)

    x = i8(n, h, w, c)
    weights = (i8(nb, c, cm), f32(nb, cm), i8(nb, 9 * cm, cm), f32(nb, cm),
               i8(nb, cm, c), f32(nb, c))
    w_scales = (ws(c, cm), ws(9 * cm, cm), ws(cm, c))
    sx, sy1, sy2 = (tuple(float(v) for v in rng.uniform(lo, hi, nb))
                    for lo, hi in ((0.02, 0.05), (5e-4, 2e-3), (5e-4, 2e-3)))
    return x, weights, w_scales, (sx, sy1, sy2)


def _saturated_sum_args(cm=257, n=1, h=5, w=6, c=24):
    """One block whose y1 is 127 everywhere and whose conv2 weights are one
    value per output channel, with b2 cancelling the interior pixels' sum
    down to ~60: the f32 rounding of conv2's running sum (past 2^24 after
    five taps) then shows in y2, and so in the f32 output."""
    rng = np.random.default_rng(5)
    v = rng.integers(100, 128, cm)
    x = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    w1 = rng.integers(-127, 128, (1, c, cm)).astype(np.int8)
    b1 = np.full((1, cm), 1e4, np.float32)
    w2 = np.broadcast_to(v.astype(np.int8), (1, 9 * cm, cm)).copy()
    b2 = (60.0 - 127.0 * v.astype(np.float64) * 9 * cm).astype(
        np.float32)[None]
    w3 = rng.integers(-127, 128, (1, cm, c)).astype(np.int8)
    b3 = rng.normal(size=(1, c)).astype(np.float32)
    w_scales = (np.full((1, cm), 1e-3, np.float32),
                np.ones((1, cm), np.float32),
                np.full((1, c), 1e-6, np.float32))
    return x, (w1, b1, w2, b2, w3, b3), w_scales, ((0.03,), (1.0,), (1.0,))


# (N, H, W, C, Cm, nb, output): "int8" requantizes to s_out; "bfloat16"
# and "float32" are the s_out=None outputs (f32 pins the FMA rules).
_INT8_CASES = [
    (2, 9, 11, 64, 32, 2, "int8"),       # H, W not multiples of a tile
    (2, 9, 11, 64, 32, 2, "bfloat16"),
    (2, 9, 11, 64, 32, 2, "float32"),    # shortcut of block 1: no FMA
    (4, 16, 16, 64, 64, 1, "float32"),   # shortcut of block 0: FMA
    (1, 7, 7, 48, 144, 2, "int8"),       # Cm > 128: per-tap f32 sum
    (1, 13, 9, 72, 144, 3, "bfloat16"),  # C not a multiple of 16
    (1, 13, 9, 72, 144, 3, "float32"),
    (2, 8, 8, 40, 16, 3, "int8"),
    (2, 6, 5, 24, 8, 2, "int8"),
    "saturated conv2 sum, Cm=257",
]


def test_fused_chain_matches_pallas_interpret():
    for i, case in enumerate(_INT8_CASES):
        if isinstance(case, str):
            x, weights, w_scales, (sx, sy1, sy2) = _saturated_sum_args()
            out = "float32"
        else:
            n, h, w, c, cm, nb, out = case
            x, weights, w_scales, (sx, sy1, sy2) = _int8_args(
                i, n, h, w, c, cm, nb)
        s_out = 0.05 if out == "int8" else None
        scales = (sx, sy1, sy2, s_out)
        kw = {} if out == "int8" else {"out_dtype": _JDT[out]}
        want = np.asarray(jfused_chain(
            jnp.asarray(x), *weights, w_scales=w_scales, scales=scales,
            interpret=True, **kw).astype(jnp.float32))
        got = fused_chain(_t(x), *map(_t, weights),
                          w_scales=tuple(map(_t, w_scales)), scales=scales,
                          out_dtype=None if out == "int8" else _TDT[out])
        assert got.dtype == _TDT[out], (case, got.dtype)
        diff = int((got.float().numpy() != want).sum())
        assert diff == 0, f"{case}: {diff} of {want.size} outputs differ"
        assert np.count_nonzero(want) > want.size // 4, (case, "degenerate")

    # the float mode: bf16 and f32 x, weights of x's type; nb 1-3, Cm <= and
    # > 128, C not a multiple of 16, odd H and W
    for case in [(2, 9, 11, 64, 32, 2, "float32"),
                 (1, 7, 7, 48, 144, 1, "bfloat16"),
                 (1, 13, 9, 72, 144, 3, "bfloat16"),
                 (3, 5, 7, 24, 16, 3, "float32")]:
        n, h, w, c, cm, nb, dt = case
        rng = np.random.default_rng(n + h + cm)
        x = rng.normal(size=(n, h, w, c)).astype(np.float32)
        weights = [rng.normal(size=s).astype(np.float32) * sc for s, sc in
                   (((nb, c, cm), c ** -0.5), ((nb, cm), 0.1),
                    ((nb, 9 * cm, cm), (9 * cm) ** -0.5), ((nb, cm), 0.1),
                    ((nb, cm, c), cm ** -0.5), ((nb, c), 0.1))]
        jw = [jnp.asarray(a, _JDT[dt]) if k % 2 == 0 else jnp.asarray(a)
              for k, a in enumerate(weights)]
        want = np.asarray(jfused_chain(jnp.asarray(x, _JDT[dt]), *jw,
                                       interpret=True).astype(jnp.float32))
        tw = [_t(a).to(_TDT[dt]) if k % 2 == 0 else _t(a)
              for k, a in enumerate(weights)]
        got = fused_chain(_t(x).to(_TDT[dt]), *tw)
        assert got.dtype == _TDT[dt], (case, got.dtype)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3,
                                   atol=2e-3, err_msg=str(case))

    # no fallback: a chain off the CPU, float or int8, takes its weights in
    # the kernel's layout only, and then launches its kernel or raises; it
    # never takes the plain version
    xm = torch.empty((1, 4, 4, 8), dtype=torch.bfloat16, device="meta")
    wm = [torch.empty(s, device="meta", dtype=d) for s, d in
          (((1, 8, 4), torch.bfloat16), ((1, 4), torch.float32),
           ((1, 36, 4), torch.bfloat16), ((1, 4), torch.float32),
           ((1, 4, 8), torch.bfloat16), ((1, 8), torch.float32))]
    for chain in (fused_chain, fused_chain_float):
        with pytest.raises(ValueError, match="kernel_layout"):
            chain(xm, *wm)
        laid = [kernel_layout(w) if k % 2 == 0 else w
                for k, w in enumerate(wm)]
        with pytest.raises(ValueError, match="no kernel for device meta"):
            chain(xm, *laid)
    xm = torch.empty((1, 4, 4, 8), dtype=torch.int8, device="meta")
    wm = [w.to(torch.int8) if k % 2 == 0 else w for k, w in enumerate(wm)]
    q = dict(w_scales=tuple(torch.empty(s, device="meta")
                            for s in ((1, 4), (1, 4), (1, 8))),
             scales=((0.1,), (0.1,), (0.1,), 0.1))
    with pytest.raises(ValueError, match="kernel_layout"):
        fused_chain(xm, *wm, **q)
    laid = [kernel_layout(w) if k % 2 == 0 else w for k, w in enumerate(wm)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_chain(xm, *laid, **q)
    w = torch.arange(24, dtype=torch.int8).reshape(1, 4, 6)
    assert torch.equal(kernel_layout(w), w)
    assert kernel_layout(w).transpose(1, 2).is_contiguous()


def _same_graph(jeng, teng):
    """The port's optimized graph equals the reference's: nodes, attrs,
    params and meta["quant"]."""
    jg, tg = jeng.graph, teng.graph
    assert [(n.name, n.op, n.inputs, n.outputs, n.params) for n in tg.nodes] \
        == [(n.name, n.op, n.inputs, n.outputs, n.params) for n in jg.nodes]
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert tn.attrs == jn.attrs, jn.name
    assert tg.params.keys() == jg.params.keys()
    for k in jg.params:
        assert np.array_equal(tg.params[k], np.asarray(jg.params[k])), k
    jq, tq = jg.meta.get("quant", {}), tg.meta.get("quant", {})
    assert tq.keys() == jq.keys()
    for name in jq:
        assert tq[name].keys() == jq[name].keys(), name
        for k, v in jq[name].items():
            got = tq[name][k]
            if isinstance(v, (list, tuple)) and v and hasattr(v[0], "shape"):
                assert all(np.array_equal(a, b) for a, b in zip(got, v))
            elif hasattr(v, "shape"):
                assert np.array_equal(np.asarray(got), np.asarray(v)), \
                    (name, k)
            else:
                assert got == v, (name, k)


def test_fusion_passes_build_the_reference_graph():
    """ResNet-50 at batch 1, calibrated on one seeded image: the chains,
    their scales, stacked weights and quant entries equal the reference's;
    without a region table nothing fuses; a run broken by a shape change
    gives one chain and one FusedBottleneck."""
    g = jresnet50(batch=1, with_softmax=False)
    g.meta["chain_regions"] = {"*": True}
    x = np.random.default_rng(7).normal(size=(1, 224, 224, 3)).astype(
        np.float32)
    jcalibrate(g, [x], method="max")
    for quant in ("w8a8", None):
        jeng = JEngine(g, JConfig(backend="pallas", quant=quant,
                                  compute_dtype="bfloat16",
                                  fuse_chains=True, interpret=True))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", quant=quant,
                                   compute_dtype="bfloat16",
                                   fuse_chains=True), device="cpu")
        _same_graph(jeng, teng)
        chains = [n for n in teng.graph.nodes if n.op == "FusedChain"]
        if quant:
            assert [n.attrs["nb"] for n in chains] == [2, 3, 5, 2]
            assert [n.attrs["s_out"] is None for n in chains] == \
                [False, False, False, True]
            assert not [n for n in teng.graph.nodes
                        if n.op == "FusedBottleneck"]
        else:
            assert chains and not chains[0].attrs["quant"]

    del g.meta["chain_regions"]
    teng = Engine(graph_from_reference(g),
                  EngineConfig(quant="w8a8", fuse_chains=True), device="cpu")
    assert not [n for n in teng.graph.nodes
                if n.op in ("FusedChain", "FusedBottleneck")]

    g = _mixed_graph()
    jeng = JEngine(g, JConfig(fuse_chains=True, interpret=True))
    teng = Engine(graph_from_reference(g), EngineConfig(fuse_chains=True),
                  device="cpu")
    _same_graph(jeng, teng)
    ops = [n.op for n in teng.graph.nodes]
    assert ops.count("FusedChain") == 1 and ops.count("FusedBottleneck") == 1


def _int8_edges(jeng, x):
    names = [o for n in jeng.graph.nodes for o in n.outputs]
    got = jeng.run(x, extract=names)
    return {k: np.asarray(v) for k, v in got.items()
            if np.asarray(v).dtype == np.int8}


def _edges_equal(jeng, teng, x, what):
    want = _int8_edges(jeng, x)
    got = teng.extract(x, sorted(want))
    total = 0
    for name, ref in want.items():
        t = got[name]
        assert t.dtype == torch.int8, (what, name, t.dtype)
        diff = int((t.numpy() != ref).sum())
        assert diff == 0, f"{what} {name}: {diff} of {ref.size} differ"
        total += ref.size
    np.testing.assert_allclose(teng(x).float().numpy(),
                               np.asarray(jeng(x), np.float32), rtol=2e-3,
                               atol=2e-3, err_msg=what)
    return total


def test_resnet50_fuse_chains_int8_edges_equal_pallas_interpret(
        monkeypatch):
    """Full-width ResNet-50, full int8, 1x64x64x3, fuse_chains with the
    wildcard region table: the port (its plain versions on the CPU)
    against the JAX engine with its Pallas kernels in interpret mode.  The
    lowering hands the chain its weights in the kernel's layout, made once:
    every forward passes the same tensors."""
    g = jresnet50(with_softmax=True)
    g.meta["chain_regions"] = {"*": True}
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jcalibrate(g, [x], method="max")
    jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                              fuse_chains=True, interpret=True))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", quant="w8a8",
                               fuse_chains=True), device="cpu")
    assert [n.op for n in teng.graph.nodes].count("FusedChain") == 4
    weights = []

    def rec(x, w1, b1, w2, b2, w3, b3, **kw):
        weights.append((w1, w2, w3))
        return fused_chain(x, w1, b1, w2, b2, w3, b3, **kw)
    monkeypatch.setattr(kdispatch, "fused_chain", rec)
    total = _edges_equal(jeng, teng, x, "resnet50 fuse_chains")
    print(f"int8 edges: 0 of {total} elements differ")
    assert total > 500_000, total
    assert len(weights) == 8        # 4 chains, 2 forwards
    assert all(w.dtype == torch.int8 and w.transpose(1, 2).is_contiguous()
               for ws in weights for w in ws)
    assert all(a is b for first, again in zip(weights[:4], weights[4:])
               for a, b in zip(first, again))


def _mini_resnet(batch=2, hw=8, C=64, Cm=16, nblocks=3, seed=3,
                 entry_conv=True):
    """tests/test_region_fusion.py's graph: (entry conv ->) nblocks
    identity bottlenecks -> exit conv, with the wildcard region table.
    Without the entry conv the first block reads the float graph input."""
    b = JBuilder("mini_res", seed=seed)
    x = b.input("data", (batch, hw, hw, C))
    if entry_conv:
        x = b.conv("conv_in", x, C, 1, relu=True)
    for i in range(nblocks):
        a = b.conv(f"blk{i}_c1", x, Cm, 1, relu=True)
        c2 = b.conv(f"blk{i}_c2", a, Cm, 3, pad=1, relu=True)
        c3 = b.conv(f"blk{i}_c3", c2, C, 1)
        s = b.eltwise(f"blk{i}_add", [x, c3])
        x = b.relu(f"blk{i}_relu", s)
    x = b.conv("conv_out", x, C, 1, relu=True)
    g = b.finish([x])
    g.meta["chain_regions"] = {"*": True}
    return g


def _mixed_graph():
    """Two (32, 8) blocks, a projection, one (64, 16) block."""
    b = JBuilder("mixed", seed=5)
    x = b.input("data", (2, 8, 8, 32))
    x = b.conv("conv_in", x, 32, 1, relu=True)
    for i, (C, Cm) in enumerate([(32, 8), (32, 8), (64, 16)]):
        if i == 2:
            x = b.conv("proj", x, 64, 1, relu=True)
        a = b.conv(f"b{i}_c1", x, Cm, 1, relu=True)
        c2 = b.conv(f"b{i}_c2", a, Cm, 3, pad=1, relu=True)
        c3 = b.conv(f"b{i}_c3", c2, C, 1)
        x = b.relu(f"b{i}_relu", b.eltwise(f"b{i}_add", [x, c3]))
    x = b.conv("conv_out", x, 64, 1, relu=True)
    g = b.finish([x])
    g.meta["chain_regions"] = {"*": True}
    return g


def test_fuse_blocks_mini_graph_matches_reference():
    """fuse_blocks: int8 FusedBottleneck nodes, the first of them on the
    float graph input (quantized with a divide), every int8 edge equal; and
    both fusion flags in the float mode against the reference."""
    x = np.random.default_rng(11).normal(size=(2, 8, 8, 64)).astype(
        np.float32)
    g = _mini_resnet(entry_conv=False)
    jcalibrate(g, [x], method="max")
    jeng = JEngine(g, JConfig(backend="pallas", quant="w8a8",
                              fuse_blocks=True, interpret=True))
    teng = Engine(graph_from_reference(g),
                  EngineConfig(backend="cuda", quant="w8a8",
                               fuse_blocks=True), device="cpu")
    _same_graph(jeng, teng)
    blocks = [n for n in teng.graph.nodes if n.op == "FusedBottleneck"]
    assert len(blocks) == 3 and all(n.attrs["quant"] for n in blocks)
    assert blocks[0].inputs == ["data"]
    _edges_equal(jeng, teng, x, "mini fuse_blocks w8a8")

    g = _mini_resnet()
    for flag, op in (("fuse_blocks", "FusedBottleneck"),
                     ("fuse_chains", "FusedChain")):
        want = np.asarray(JEngine(g, JConfig(interpret=True,
                                             **{flag: True}))(x))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", **{flag: True}),
                      device="cpu")
        assert op in [n.op for n in teng.graph.nodes], flag
        np.testing.assert_allclose(teng(x).numpy(), want, rtol=2e-3,
                                   atol=2e-3, err_msg=flag)
