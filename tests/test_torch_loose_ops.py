"""The loose ops of the PyTorch port (the layers a converted Caffe graph may
hold that no zoo builder uses: PReLU, TanH, ELU, AbsVal, Exp, Log, BNLL,
Power, MVN, Tile, Reduction, Threshold) and fault C1 (the leaky ReLU's
slope, the Eltwise ``coeffs`` and Power's scale and shift used unrounded)
against the JAX engine, on the CPU, in f32 and bf16.

The same graphs and numpy inputs, made from a seed, go through both
engines.  Each output is held in ulps of its type (bf16 ulps for a bf16
output), with these bounds and reasons:

- 0 ulp: PReLU, AbsVal, Threshold, Tile, the leaky ReLU, the Eltwise
  ``coeffs`` sum and Power (the reference's op order followed: each Python
  number rounded to x's type, as JAX's weak typing does; in f32 the
  multiply-adds fused as XLA's compiled form fuses them, in bf16 each
  step rounded); every bf16 output of an elementwise op;
- f32 only, the transcendental functions, XLA's own approximations beside
  PyTorch's (measured on these inputs): Exp and Log 1 ulp, BNLL 3, TanH
  4, ELU 6 (``expm1`` near 0), Power at a power that is not a whole
  number 1 (XLA's ``pow`` is within 1 ulp of the f64 power rounded
  once, which the port takes);
- MVN and Reduction, sums in another order than XLA's: within 4e-6 of the
  output's largest magnitude (f32), and MVN's bf16 output within 1 bf16
  ulp.

Few test items per file: see tests/test_torch_kernels.py.
"""

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.ir import Node as JNode
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.weights import graph_from_reference

SHAPE = (2, 16, 16, 64)


def _ulps(a, b, dtype):
    """Elementwise distance in ulps of ``dtype`` of two f32 arrays holding
    values of that type (NaN beside NaN is 0)."""
    sh = 16 if dtype == "bfloat16" else 0
    ia = (a.view(np.int32) >> sh).astype(np.int64)
    ib = (b.view(np.int32) >> sh).astype(np.int64)
    # the sign-magnitude bit patterns onto one ordered line
    ia = np.where(ia < 0, -(ia & (2 ** (31 - sh) - 1)), ia)
    ib = np.where(ib < 0, -(ib & (2 ** (31 - sh) - 1)), ib)
    d = np.abs(ia - ib)
    d[np.isnan(a) & np.isnan(b)] = 0
    return d


def _both(g, x, dt):
    want = {k: np.asarray(v.astype(np.float32)) for k, v in
            JEngine(g, JConfig(compute_dtype=dt)).run(x).items()}
    got = {k: v.float().numpy() for k, v in
           Engine(graph_from_reference(g), EngineConfig(compute_dtype=dt),
                  device="cpu").run(x).items()}
    return want, got


def _c1_graph():
    """The three ops of fault C1: a leaky ReLU, Eltwise SUMs with
    ``coeffs`` over two and three inputs, and Power at powers 1 and 2."""
    b = JBuilder("c1", seed=1)
    x = b.input("data", SHAPE)
    y = b.conv("y", x, 64, 1)
    z = b.conv("z", x, 64, 1)
    outs = [b.relu("leaky", x, negative_slope=0.1)]
    for name, ins, cf in (("sum2", [x, y], [0.3, -1.7]),
                          ("sum3", [x, y, z], [0.3, -1.7, 0.11])):
        outs.append(b._add(JNode(name, "Eltwise", ins, [name],
                                 {"operation": "SUM", "coeffs": cf}))[0])
    for name, p in (("pow1", 1.0), ("pow2", 2.0)):
        outs.append(b._add(JNode(name, "Power", [x], [name],
                                 {"scale": 0.3, "shift": 0.7,
                                  "power": p}))[0])
    return b.finish(outs)


def test_fault_c1_shown_and_repaired():
    """Each op of fault C1, computed first as the port computed it before
    the repair (the Python number unrounded; the coeffs summed as ``sum(c
    * x)``; Power unfused and unrounded), differs from the JAX engine's
    output, in bf16 for every op and in f32 for the coeffs and Power; the
    port's lowering now gives the JAX engine's output to 0 ulp in f32 and
    bf16."""
    g = _c1_graph()
    rng = np.random.default_rng(0)
    x = rng.normal(size=SHAPE).astype(np.float32) * 3
    for dt in ("float32", "bfloat16"):
        want, got = _both(g, x, dt)
        tdt = getattr(torch, dt)
        xt = torch.from_numpy(x).to(tdt)
        ref = Engine(graph_from_reference(g), EngineConfig(compute_dtype=dt),
                     device="cpu").run(x, extract=["y", "z"])
        y, z = ref["y"], ref["z"]
        before = {
            "leaky": torch.where(xt > 0, xt, xt * 0.1),
            "sum2": sum(c * v for c, v in zip([0.3, -1.7], [xt, y])),
            "sum3": sum(c * v for c, v in zip([0.3, -1.7, 0.11],
                                              [xt, y, z])),
            "pow1": xt * 0.3 + 0.7,
            "pow2": torch.pow(xt * 0.3 + 0.7, 2.0)}
        for k, old in before.items():
            n_old = int((old.float().numpy() != want[k]).sum())
            if dt == "bfloat16" or k != "leaky":
                assert n_old > 0, (k, dt, "the fault does not show")
            assert _ulps(got[k], want[k], dt).max() == 0, (k, dt)
            print(f"C1 {k} {dt}: {n_old} of {x.size} outputs apart before "
                  "the repair, 0 after")


def _loose_graph():
    """Every loose op reading the input (Log and a fractional Power a
    positive map made from it)."""
    b = JBuilder("loose", seed=2)
    x = b.input("data", SHAPE)
    b.graph.params["prelu/slope"] = np.random.default_rng(9).uniform(
        0, 0.5, size=(64,)).astype(np.float32)

    def op(name, kind, attrs, src=x, params=()):
        return b._add(JNode(name, kind, [src], [name], attrs,
                            list(params)))[0]

    pos = op("pos", "Power", {"scale": 0.25, "shift": 4.0, "power": 1.0},
             op("abs", "AbsVal", {}))
    outs = [op("prelu", "PReLU", {}, params=["prelu/slope"]),
            op("tanh", "TanH", {}), op("elu", "ELU", {"alpha": 0.7}),
            op("abs2", "AbsVal", {}), op("exp", "Exp", {}),
            op("log", "Log", {}, pos), op("bnll", "BNLL", {}),
            op("pow15", "Power", {"scale": 0.3, "shift": 0.5,
                                  "power": 1.5}, pos),
            op("pow_half", "Power", {"power": 0.5}, pos),
            op("mvn", "MVN", {}),
            op("mvn_c", "MVN", {"across_channels": True}),
            op("mvn_mean", "MVN", {"normalize_variance": False}),
            op("tile", "Tile", {"axis": 2, "tiles": 3}),
            op("red_sumsq", "Reduction", {"axis": 1, "operation": "SUMSQ"}),
            op("red_mean", "Reduction", {"axis": 2, "operation": "MEAN",
                                         "coeff": 0.5}),
            op("red_asum", "Reduction", {"axis": 1, "operation": "ASUM"}),
            op("red_sum", "Reduction", {"axis": 3, "operation": "SUM"}),
            op("thresh", "Threshold", {"threshold": 0.3})]
    return b.finish(outs)


# f32 ulp bounds of the transcendental outputs (the module docstring's)
F32_ULPS = {"exp": 1, "log": 1, "bnll": 3, "tanh": 4, "elu": 6, "pow15": 1}
SUMS = ("mvn", "mvn_c", "mvn_mean", "red_sumsq", "red_mean", "red_asum",
        "red_sum")


def test_loose_ops_match_reference():
    """One graph of every loose op in f32 and bf16 against the JAX engine,
    each output within its bound (the module docstring's)."""
    g = _loose_graph()
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32) * 3
    for dt in ("float32", "bfloat16"):
        want, got = _both(g, x, dt)
        for k in g.outputs:
            w, t = want[k], got[k]
            assert t.shape == w.shape, (k, dt, t.shape, w.shape)
            if k in SUMS:
                err = np.abs(t - w)
                assert err.max() <= 4e-6 * np.abs(w).max() or (
                    dt == "bfloat16" and k.startswith("mvn")
                    and _ulps(t, w, dt).max() <= 1), (k, dt, err.max())
                continue
            bound = F32_ULPS.get(k, 0) if dt == "float32" else 0
            assert _ulps(t, w, dt).max() <= bound, (k, dt)
