"""The port's Winograd F(6x6,3x3) path and its "winograd" and "dot1x1"
dispatcher branches against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the reference's
``feathercnn_tpu.kernels.winograd`` (plain jnp) and the port's
``feathercnn_tpu_torch.kernels.winograd`` (plain torch), and small graphs
through both engines with those algos named in ``algo_overrides``.

Tolerances, with their reasons:

- ``transform_weights``: equal (the same f32 contractions in the same
  order).
- against the exact conv (no reference involved): the gates of
  ``chip_smoke.py``'s Winograd check, in the test's docstring.
- ``winograd_conv2d``: within 1e-4 (f32 x and out) or 1e-2 (a bf16 x or
  out) of the largest |y| of the same conv before its activation.  Both
  versions round the transformed tiles and weights to bf16 for a bf16 x,
  and the two frameworks sum the transforms in other orders, so a tile
  value may round the other way, which the output transform (entries up
  to 32) carries into several outputs.  The pre-activation magnitude is
  the scale of that error (a ReLU6 output is clipped to 6 whatever it is).
- w8a8 graphs: every int8 edge equal (the "winograd" conv keeps float
  edges; "dot1x1" sums int8 products exactly, as the reference's int32
  dot).
- w8 graphs (bf16 activations, no int8 edge): every float edge within
  2e-2 of its largest magnitude and the probabilities within 1e-2 (a
  bf16 probability near 1 has an ulp of 0.0039): the bf16 x int8 GEMMs
  sum in f32 in other orders, and a bf16 store may round the other way,
  layer after layer.

Few test items per file: see tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.kernels import winograd as jwinograd
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import winograd
from feathercnn_tpu_torch.weights import graph_from_reference


def _case(rng, xdt, int8_w, n, h, w, c, co):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wt = rng.normal(size=(3, 3, c, co)).astype(np.float32)
    bias = rng.normal(size=co).astype(np.float32)
    ws = None
    if int8_w:
        ws = (np.abs(wt).reshape(-1, co).max(0) / 127).astype(np.float32)
        wt = np.clip(np.round(wt / ws), -127, 127).astype(np.int8)
    return x, wt, bias, ws


# (x type, int8 weight, pad, H, W, activation, out type): each property
# in several cases
_CASES = [
    ("float32", False, 1, 13, 11, "relu", "float32"),
    ("float32", False, 0, 20, 17, None, "bfloat16"),
    ("float32", True, 1, 8, 8, "relu6", "float32"),
    ("float32", True, 0, 13, 11, "relu", "bfloat16"),
    ("bfloat16", False, 1, 20, 17, "relu6", "bfloat16"),
    ("bfloat16", False, 0, 8, 8, None, "float32"),
    ("bfloat16", True, 1, 13, 11, "relu", "float32"),
    ("bfloat16", True, 0, 20, 17, "relu6", "bfloat16"),
    ("bfloat16", True, 1, 7, 9, None, "bfloat16"),
    ("float32", True, 1, 9, 7, "relu6", "float32"),
]


def test_winograd_conv2d_matches_reference():
    """f32 and bf16 x; float weights and int8 weights with w_scale; pad 0
    and 1; H and W not multiples of 6; ReLU, ReLU6 and none; f32 and bf16
    outputs."""
    rng = np.random.default_rng(0)
    worst = {}
    for xdt, int8_w, pad, h, w, act, odt in _CASES:
        x, wt, bias, ws = _case(rng, xdt, int8_w, 2, h, w, 8, 16)
        jx = jnp.asarray(x).astype(xdt)
        kw = dict(w_scale=None if ws is None else jnp.asarray(ws),
                  pad_h=pad, pad_w=pad)
        want = np.asarray(jwinograd.winograd_conv2d(
            jx, jnp.asarray(wt), jnp.asarray(bias), activation=act,
            out_dtype=jnp.dtype(odt), **kw), np.float32)
        args = (torch.from_numpy(x).to(getattr(torch, xdt)),
                torch.from_numpy(wt), torch.from_numpy(bias),
                None if ws is None else torch.from_numpy(ws), pad, pad)
        got = winograd.winograd_conv2d(*args, activation=act,
                                       out_dtype=getattr(torch, odt))
        pre = winograd.winograd_conv2d(*args, out_dtype=torch.float32)
        assert got.dtype == getattr(torch, odt)
        assert got.shape == want.shape, (got.shape, want.shape)
        rel = (np.abs(got.float().numpy() - want).max()
               / pre.abs().max().item())
        key = (xdt, odt)
        worst[key] = max(worst.get(key, 0.0), float(rel))
        tol = 1e-4 if key == ("float32", "float32") else 1e-2
        assert rel <= tol, (xdt, int8_w, pad, h, w, act, odt, rel)
    print("largest error / largest pre-activation |y|:", worst)


def test_winograd_error_against_direct_conv():
    """F(6,3)'s own error, the gates ``chip_smoke.py`` holds each Winograd
    conv of the VGG-16 path to against ``F.conv2d``: against the exact
    conv (f64) of the same bf16 x and dequantized int8 weight, the RMS
    error within 6% of the pre-activation output's RMS and the largest
    within 25% of its largest magnitude (bf16-rounded transformed operands:
    ~4% RMS measured at every VGG shape class); an f32 x within 1e-4 of
    both (tests/test_winograd.py's bound for the reference)."""
    gen = torch.Generator().manual_seed(3)
    for dt, (rms_tol, max_tol) in ((torch.bfloat16, (0.06, 0.25)),
                                   (torch.float32, (1e-4, 1e-4))):
        for h, w, c, co in ((30, 31, 3, 64), (14, 15, 64, 64),
                            (7, 7, 512, 128)):
            x = torch.relu(torch.randn(2, h, w, c, generator=gen)).to(dt)
            wf = torch.randn(3, 3, c, co, generator=gen) * (2 / (9 * c)) ** .5
            ws = wf.abs().reshape(-1, co).amax(0) / 127
            wq = torch.round(wf / ws).clamp(-127, 127).to(torch.int8)
            y = winograd.winograd_conv2d(x, wq, None, ws,
                                         out_dtype=torch.float32)
            pre = torch.nn.functional.conv2d(
                x.double().permute(0, 3, 1, 2),
                (wq.double() * ws.double()).permute(3, 2, 0, 1),
                padding=1).permute(0, 2, 3, 1)
            e = (y.double() - pre)
            rms = float(e.pow(2).mean().sqrt() / pre.pow(2).mean().sqrt())
            top = float(e.abs().max() / pre.abs().max())
            assert rms <= rms_tol and top <= max_tol, (dt, h, c, rms, top)
            print(f"{dt} {(h, w, c, co)}: RMS error / RMS {rms:.3g}, "
                  f"largest / largest {top:.3g}")


def test_transform_weights_equals_reference():
    rng = np.random.default_rng(1)
    for c, co in ((8, 16), (3, 64), (64, 5)):
        w = rng.normal(size=(3, 3, c, co)).astype(np.float32)
        want = np.asarray(jwinograd.transform_weights(jnp.asarray(w)))
        got = winograd.transform_weights(torch.from_numpy(w))
        assert got.dtype == torch.float32 and got.shape == (64, c, co)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(winograd.BT, jwinograd.BT)
    np.testing.assert_array_equal(winograd.G, jwinograd.G)
    np.testing.assert_array_equal(winograd.AT, jwinograd.AT)


def _override_graph():
    """A stem, a 3x3 conv, merged sibling 1x1 convs (one with a ReLU, one
    without: ``act_segments``; 128 channels, the merge pass's alignment),
    a strided 1x1, a 5x5 conv and a FC, on a 15x14 input."""
    b = JBuilder("ovr", seed=5)
    x = b.input("data", (2, 15, 14, 3))
    x = b.conv("stem", x, 16, 3, pad=1, relu=True)
    x = b.conv("c3", x, 32, 3, pad=1, relu=True)
    s1 = b.conv("s1", x, 128, 1, relu=True)
    s2 = b.conv("s2", x, 128, 1)
    x = b.eltwise("sum", [s1, s2])
    x = b.conv("c3b", x, 32, 3, pad=0, relu=True)
    x = b.conv("p2", x, 48, 1, stride=2, relu=True)
    x = b.conv("c5", x, 16, 5, pad=2, relu=True)
    x = b.fc("fc", x, 10)
    return b.finish([b.softmax("prob", x)])


def _edges(eng, x):
    names = [o for n in eng.graph.nodes for o in n.outputs]
    return eng.run(x, extract=names)


def test_winograd_and_dot1x1_overrides_match_reference():
    """The "winograd" override on every conv (3x3 s1 convs take it, the
    others fall back to "xla" as in the reference) and "dot1x1" on every
    conv (1x1 g1 convs take it, the merged conv with its act_segments
    among them), under w8a8 and w8, against the JAX engine (Pallas in
    interpret mode)."""
    g = _override_graph()
    rng = np.random.default_rng(2)
    jcalibrate(g, [rng.normal(size=(2, 15, 14, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(2, 15, 14, 3)).astype(np.float32)
    tg = graph_from_reference(g)
    for algo in ("winograd", "dot1x1"):
        for quant in ("w8a8", "w8"):
            case = f"{algo} {quant}"
            kw = dict(quant=quant, compute_dtype="bfloat16",
                      algo_overrides=(("*", algo),))
            jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
            teng = Engine(tg, EngineConfig(backend="cuda", **kw),
                          device="cpu")
            merged = [n for n in teng.graph.nodes
                      if n.attrs.get("act_segments")]
            assert len(merged) == 1, case
            want = {k: np.asarray(v, np.float32 if v.dtype != jnp.int8
                                  else np.int8)
                    for k, v in _edges(jeng, x).items()}
            got = teng.extract(x, sorted(want))
            n_int8 = 0
            for k, ref in want.items():
                t = got[k]
                if ref.dtype == np.int8:
                    assert t.dtype == torch.int8, (case, k, t.dtype)
                    diff = int((t.numpy() != ref).sum())
                    assert diff == 0, f"{case} {k}: {diff} int8 values differ"
                    n_int8 += 1
                else:
                    assert t.dtype != torch.int8, (case, k)
                    err = np.abs(t.float().numpy() - ref).max()
                    assert err <= 2e-2 * max(np.abs(ref).max(), 1e-30), \
                        (case, k, err)
            out = teng.graph.outputs[0]
            np.testing.assert_allclose(got[out].float().numpy(), want[out],
                                       rtol=0, atol=1e-2, err_msg=case)
            if quant == "w8a8":
                assert n_int8 >= 4, (case, n_int8)
            else:
                assert n_int8 == 0, (case, n_int8)
            print(f"{case}: {n_int8} int8 edges equal, "
                  f"{len(want) - n_int8} float edges within 2e-2")
