"""The loose ops of the PyTorch port (the layers a converted Caffe graph may
hold that no zoo builder uses: PReLU, TanH, ELU, AbsVal, Exp, Log, BNLL,
Power, MVN, Tile, Reduction, Threshold), fault C1 (the leaky ReLU's slope,
the Eltwise ``coeffs`` and Power's scale and shift used unrounded) and the
port's single-rounding multiply-add (``numerics.fma``) against the JAX
engine, on the CPU, in f32 and bf16.

The same graphs and numpy inputs, made from a seed, go through both
engines.  Each output is held in ulps of its type (bf16 ulps for a bf16
output), with these bounds and reasons:

- 0 ulp against the JAX engine: PReLU, AbsVal, Threshold, Tile, the leaky
  ReLU, the Eltwise ``coeffs`` sum and Power at a whole power (the
  reference's op order followed: each Python number rounded to x's type,
  as JAX's weak typing does; in f32 the multiply-adds fused as XLA's
  compiled form fuses them, in bf16 each step rounded).
- The transcendental ops (Exp, Log, BNLL, TanH, ELU, Power at 1.5) are
  held against an oracle: the op's formula in float64 numpy on the op's
  own input values, rounded once to the output type.  The bounds are
  derived, not measured:
  - the port evaluates each in f64 (PyTorch's f64 ``exp``, ``log``,
    ``tanh``, ``expm1``, ``log1p``, ``pow``, each within 1 f64 ulp on
    every ATen path: glibc, Sleef's ``_u10`` and MKL's HA functions
    document <= 1 ulp) and rounds once; two values a few f64 ulps apart
    round to one f32 or bf16 value unless an f32 rounding midpoint lies
    between them, so the port is within 1 ulp of the oracle, in f32 and
    in bf16 (f64 -> bf16 rounds through f32: the second rounding can also
    move a value by 1 bf16 ulp, never 2);
  - the JAX engine evaluates XLA's own f32 polynomial approximations,
    which XLA does not document; ``XLA_F32_ULPS`` holds the largest error
    XLA's CPU gives on these (seeded) inputs plus a margin of 1 ulp for
    another XLA build or ISA, which may contract the polynomial's steps
    into FMAs differently (each such step moves the result by at most 1
    ulp at these sizes);
  - in bf16 XLA rounds its f32 approximation to bf16, the port its f64
    value: at a bf16 rounding midpoint they part by 1 bf16 ulp, so the
    two engines' bf16 outputs of these ops may differ by 1 bf16 ulp and
    no more.
- MVN and Reduction, sums in another order than XLA's: within 4e-6 of the
  output's largest magnitude (f32), and MVN's bf16 output within 1 bf16
  ulp.

``fma`` is held to ``a*b + c`` rounded once: in f64 numpy, whose one
rounding to f32 after the exact-product f64 sum is exact unless that sum
is inexact and lands on an f32 rounding midpoint; the test counts those
double-rounding cases on its inputs and holds the count at 0.  Under
``ATEN_CPU_CAPABILITY=default`` (ATen's scalar path, in a subprocess)
``torch.addcmul`` rounds the product before the add and misses that value;
``fma`` does not.

Few test items per file: see tests/test_torch_kernels.py.
"""

import os
import subprocess
import sys

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


# XLA's largest f32 error on these inputs against the oracle, + 1 ulp (the
# module docstring)
XLA_F32_ULPS = {"exp": 1 + 1, "log": 1 + 1, "bnll": 3 + 1, "tanh": 4 + 1,
                "elu": 4 + 1, "pow15": 1 + 1}
# the port: f64 evaluation, rounded once (the module docstring)
PORT_ULPS = 1
SUMS = ("mvn", "mvn_c", "mvn_mean", "red_sumsq", "red_mean", "red_asum",
        "red_sum")


def _round_once(p, c):
    """``p + c`` in f64 rounded to f32, with p an exact f64 product of two
    f32 values; asserts no double rounding: the f64 sum either exact or
    off every f32 rounding midpoint."""
    p, c = np.asarray(p, np.float64), np.asarray(c, np.float64)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    tie = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    n = int((tie & (err != 0)).sum())
    assert n == 0, f"{n} double roundings"
    return s.astype(np.float32)


def _oracle(k, v, dt):
    """The transcendental output ``k`` of the input values ``v`` (f32
    array of values of type ``dt``) in f64, rounded once to ``dt``."""
    v = v.astype(np.float64)
    if k == "pow15":                      # y = 0.3 * pos + 0.5, then y^1.5
        if dt == "float32":
            y = _round_once(np.float32(0.3) * v, np.float32(0.5))
        else:
            b = torch.bfloat16
            y = (torch.from_numpy(v).to(b) * torch.tensor(0.3, dtype=b)
                 + torch.tensor(0.5, dtype=b)).float().numpy()
        v = y.astype(np.float64)
    alpha = float(torch.tensor(0.7, dtype=getattr(torch, dt)))
    out = {"exp": np.exp, "log": np.log, "tanh": np.tanh,
           "bnll": lambda u: np.maximum(u, 0) + np.log1p(np.exp(-np.abs(u))),
           "elu": lambda u: np.where(u > 0, u, alpha * np.expm1(
               np.minimum(u, 0))),
           "pow15": lambda u: np.power(u, 1.5)}[k](v)
    return torch.from_numpy(out).to(getattr(torch, dt)).float().numpy()


def test_loose_ops_match_reference():
    """One graph of every loose op in f32 and bf16 against the JAX engine,
    and the transcendental ones against the f64 oracle, each output within
    its bound (the module docstring's)."""
    g = _loose_graph()
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32) * 3
    for dt in ("float32", "bfloat16"):
        want, got = _both(g, x, dt)
        src = Engine(graph_from_reference(g), EngineConfig(compute_dtype=dt),
                     device="cpu").run(x, extract=["pos"])
        xin = torch.from_numpy(x).to(getattr(torch, dt)).float().numpy()
        pos = src["pos"].float().numpy()
        for k in g.outputs:
            w, t = want[k], got[k]
            assert t.shape == w.shape, (k, dt, t.shape, w.shape)
            if k in SUMS:
                err = np.abs(t - w)
                assert err.max() <= 4e-6 * np.abs(w).max() or (
                    dt == "bfloat16" and k.startswith("mvn")
                    and _ulps(t, w, dt).max() <= 1), (k, dt, err.max())
                continue
            if k not in XLA_F32_ULPS:
                assert _ulps(t, w, dt).max() == 0, (k, dt)
                continue
            o = _oracle(k, pos if k in ("log", "pow15") else xin, dt)
            port, ref = _ulps(t, o, dt).max(), _ulps(w, o, dt).max()
            assert port <= PORT_ULPS, (k, dt, "port", port)
            if dt == "float32":
                assert ref <= XLA_F32_ULPS[k], (k, dt, "JAX", ref)
            else:
                assert _ulps(t, w, dt).max() <= 1, (k, dt)
            print(f"{k} {dt}: port {port} ulp, JAX {ref} ulp from the f64 "
                  "oracle rounded once")


_FMA_PROBE = """
import numpy as np, torch
from feathercnn_tpu_torch.numerics import fma
rng = np.random.default_rng(3)
a, b, c = (rng.normal(size=1 << 16).astype(np.float32) * 3 for _ in range(3))
s = a.astype(np.float64) * b + c
z = s - a.astype(np.float64) * b
err = (a.astype(np.float64) * b - (s - z)) + (c - z)
ties = int((((s.view(np.int64) & 0x1FFFFFFF) == 0x10000000)
            & (err != 0)).sum())
want = s.astype(np.float32)
ta, tb, tc = map(torch.from_numpy, (a, b, c))
old = int((torch.addcmul(tc, ta, tb).numpy() != want).sum())
new = int((fma(ta, tb, tc).numpy() != want).sum())
print(torch.backends.cpu.get_cpu_capability(), ties, old, new)
"""


def test_fma_is_one_rounding_on_every_isa():
    """``a*b + c`` on 65,536 seeded f32 triples, in a subprocess under each
    ``ATEN_CPU_CAPABILITY`` (``default``: ATen's scalar path; ``avx2``;
    the host's own): ``fma`` equals the f64 form rounded once on every
    ISA, with no double rounding on these inputs; ``torch.addcmul``, the
    form the port used before, misses it under ``default``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cap in ("default", "avx2", None):
        env = dict(os.environ, PYTHONPATH=root)
        env.pop("ATEN_CPU_CAPABILITY", None)
        if cap:
            env["ATEN_CPU_CAPABILITY"] = cap
        out = subprocess.run([sys.executable, "-c", _FMA_PROBE], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        isa, ties, old, new = out.stdout.split()
        print(f"{isa}: addcmul misses {old} of 65536, fma {new}, "
              f"double roundings {ties}")
        assert (int(ties), int(new)) == (0, 0), (isa, ties, new)
        if cap == "default":
            assert isa == "DEFAULT" and int(old) > 0, (isa, old)
