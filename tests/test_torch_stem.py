"""The port's float stem (``kernels/stem.py``) against the JAX package's
float conv, on the CPU.

The reference computes an int8-emitting stem in its dispatcher's float
branch (``feathercnn_tpu/kernels/dispatch.py::conv_forward``, run here
under ``jax.jit``): the bf16 input and the dequantized weight summed in
f32, + bias, the activation, ``clip(round(y * out_scale))``.  On the CPU
the port's ``stem_conv_int8`` takes ``stem_conv_plain``, and the
dispatcher routes a stem there where ``takes_stem_kernel`` holds.  The
CUDA kernel itself runs only on the card (``chip_smoke.py``); here its
weight layout, its offsets into the staged input rows and its sum order
are emulated.  Tolerance: int8 outputs equal (0 LSB).

Few test items per file: see tests/test_torch_kernels.py.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feathercnn_tpu.ir import Node as JNode
from feathercnn_tpu.kernels import dispatch as jdispatch
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.ir import Node
from feathercnn_tpu_torch.kernels import dispatch as kdispatch
from feathercnn_tpu_torch.kernels.stem import (stem_conv_int8,
                                               stem_conv_plain, stem_layout,
                                               stem_plan, takes_stem_kernel)
from feathercnn_tpu_torch.models import MODEL_BUILDERS, build_model
from feathercnn_tpu_torch.ops.lowering import LoweringCtx
from feathercnn_tpu_torch.quant import rewrite

ACTS = (None, "relu", "relu6")
# (kernel, stride, pad, Co): ResNet-50's stem and MobileNet's
STEMS = ((7, 2, 3, 64), (3, 2, 1, 32))


def _node(k, s, p, co, act, lib=JNode):
    attrs = {"num_output": co, "kernel_h": k, "kernel_w": k, "stride": s,
             "pad_h": p, "pad_w": p, "group": 1, "bias_term": True,
             "dilation": 1, **({"activation": act} if act else {})}
    return lib("conv1", "Convolution", ["data"], ["conv1"], attrs)


def _reference(x, w, w_scale, bias, y_scale, k, s, p, act):
    """The JAX dispatcher's float conv of an int8-emitting stem, compiled,
    on numpy bf16-valued x (f32), int8 w, its scales and f32 bias."""
    node = _node(k, s, p, w.shape[-1], act)
    q = {"w_scale": w_scale, "input_scale": 0.03, "emit_int8": True,
         "y_scale": y_scale}
    ctx = SimpleNamespace(qinfo=lambda n: q, config=SimpleNamespace(
        algo_for=lambda name: None, interpret=True,
        compute_dtype="bfloat16", int8_grouped=False))
    fn = jax.jit(lambda u, v, b: jdispatch.conv_forward(node, u, v, b, ctx))
    return np.asarray(fn(jnp.asarray(x, jnp.bfloat16), w, bias))


def _port_ctx(backend, q):
    graph = SimpleNamespace(meta={"quant": {"conv1": q}})
    return LoweringCtx(graph, EngineConfig(backend=backend), torch.device(
        "cpu"))


def test_plain_equals_the_reference_float_stem():
    """``stem_conv_plain``, the wrapper on CPU tensors and the dispatcher's
    route (on the "cuda" backend, through ``stem_conv_int8``) give the
    reference's int8 stem bit for bit, at 7x7 s2 p3 -> 64 and 3x3 s2 p1 ->
    32 with each activation: on seeded values at a calibration-like scale,
    and on small integers and quarter weights whose sums are exact in any
    order, at y_scale 0.5, so that many quotients land on .5 (rounded half
    to even) and many saturate."""
    rng = np.random.default_rng(0)
    ties = clamped = 0
    for k, s, p, co in STEMS:
        for exact in (False, True):
            if exact:
                x = rng.integers(-8, 9, size=(2, 21, 19, 3)).astype(np.float32)
                w = rng.integers(-7, 8, size=(k, k, 3, co)).astype(np.int8)
                w_scale = np.full(co, 0.25, np.float32)
                bias = (rng.integers(-8, 9, size=co) * 0.25).astype(np.float32)
                y_scale = 0.5
            else:
                x = np.asarray(jnp.asarray(rng.normal(size=(2, 33, 30, 3)),
                                           jnp.bfloat16).astype(jnp.float32))
                w = rng.integers(-127, 128, size=(k, k, 3, co)).astype(np.int8)
                w_scale = (rng.uniform(0.5, 1.5, co) / 127 / k).astype(
                    np.float32)
                bias = rng.normal(size=co).astype(np.float32) * 0.1
                y_scale = 3.7 / 127
            tx = torch.tensor(x).to(torch.bfloat16)
            wd = (torch.from_numpy(w).float()
                  * torch.from_numpy(w_scale)).to(torch.bfloat16)
            tb = torch.from_numpy(bias)
            for act in ACTS:
                want = _reference(x, w, w_scale, bias, y_scale, k, s, p, act)
                if exact:
                    acc = torch.nn.functional.conv2d(
                        tx.double().permute(0, 3, 1, 2),
                        wd.double().permute(3, 2, 0, 1), stride=s,
                        padding=p).permute(0, 2, 3, 1) + tb.double()
                    acc = {None: acc, "relu": acc.clamp_min(0),
                           "relu6": acc.clamp(0, 6)}[act] / y_scale
                    ties += int((acc - acc.trunc()).abs().eq(0.5).sum())
                    clamped += int(acc.abs().gt(127.5).sum())
                q = {"w_scale": w_scale, "input_scale": 0.03,
                     "emit_int8": True, "y_scale": y_scale}
                node = _node(k, s, p, co, act, Node)
                got = {
                    "plain": stem_conv_plain(tx, wd, tb, (s, s), (p, p), act,
                                             1.0 / y_scale),
                    "wrapper": stem_conv_int8(tx, wd, tb, (s, s), (p, p), act,
                                              1.0 / y_scale),
                    "route": kdispatch.conv_forward(
                        node, tx, torch.from_numpy(w), tb,
                        _port_ctx("cuda", q))}
                for what, out in got.items():
                    assert out.dtype == torch.int8, what
                    diff = int((out.numpy() != want).sum())
                    assert diff == 0, (what, k, exact, act, diff)
    assert ties > 1000 and clamped > 1000, (ties, clamped)


def _emulate(x, w, bias, stride, pad, act, out_scale):
    """The kernel's arithmetic on its own layout, in f32: per band of
    ``plan.th`` output rows the staged input rows as f32 (``lead`` zeros,
    the row's data, zeros to the pitch ``rp``; rows off the image zero),
    each output's taps in (r, s, c) order read at its window start plus
    ``r * rp + e`` and summed one at a time from 0 (a bf16 x bf16 product
    is exact in f32, so ``acc + x * w`` rounds as the kernel's FMA does),
    the weight recovered from ``stem_layout``'s lane order."""
    n, h, wd, c = x.shape
    kh, kw, _, co = w.shape
    (sh, sw), (ph, pw) = stride, pad
    plan = stem_plan(h, wd, c, kh, kw, co, sh, sw, ph, pw)
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (wd + 2 * pw - kw) // sw + 1
    wt = stem_layout(w).permute(0, 2, 1, 3).reshape(kh * kw * c, co).numpy()
    out = np.empty((n, oh, ow, co), np.float32)
    for img in range(n):
        for oh0 in range(0, oh, plan.th):
            rows = np.zeros((plan.rows, plan.rp), np.float32)
            for rr in range(plan.rows):
                ih = oh0 * sh - ph + rr
                if 0 <= ih < h:
                    rows[rr, plan.lead:plan.lead + wd * c] = \
                        x[img, ih].float().reshape(-1).numpy()
            flat = rows.reshape(-1)
            band = min(plan.th, oh - oh0)
            orow, ocol = np.divmod(np.arange(band * ow), ow)
            base = (orow * sh * plan.rp + plan.lead + (ocol * sw - pw) * c)
            assert base.min() >= 0
            acc = np.zeros((band * ow, co), np.float32)
            t = 0
            for r in range(kh):
                for e in range(kw * c):
                    xv = flat[base + r * plan.rp + e]
                    acc = (acc + xv[:, None] * wt[t][None]).astype(np.float32)
                    t += 1
            out[img, oh0:oh0 + band] = acc.reshape(band, ow, co)
    y = torch.from_numpy(out) + bias
    y = {None: y, "relu": y.clamp_min(0), "relu6": y.clamp(0, 6)}[act]
    return torch.clamp(torch.round(y * torch.tensor(out_scale)), -127,
                       127).to(torch.int8)


def _sequential(x, w, bias, stride, pad, act, out_scale):
    """The stem summed one tap at a time in (r, s, c) order from 0 in f32,
    straight from the padded image, then the plain version's epilogue."""
    kh, kw, c, co = w.shape
    (sh, sw), (ph, pw) = stride, pad
    xp = np.pad(x.float().numpy(), ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    wf = w.float().numpy()
    acc = np.zeros((x.shape[0], oh, ow, co), np.float32)
    for r in range(kh):
        for q in range(kw):
            win = xp[:, r:r + sh * (oh - 1) + 1:sh, q:q + sw * (ow - 1) + 1:sw]
            for ch in range(c):
                acc = (acc + win[..., ch:ch + 1] * wf[r, q, ch]).astype(
                    np.float32)
    y = torch.from_numpy(acc) + bias
    y = {None: y, "relu": y.clamp_min(0), "relu6": y.clamp(0, 6)}[act]
    return torch.clamp(torch.round(y * torch.tensor(out_scale)), -127,
                       127).to(torch.int8)


def test_layout_and_sum_order_equal_the_plain_version():
    """``stem_plan`` and ``stem_layout`` as the kernel reads them, with its
    sum order (``_emulate``), give the taps summed one at a time in (r, s,
    c) order bit for bit on seeded values, for the zoo's stem forms (7x7 s2
    p3, 3x3 s2 p1, 3x3 s1 p1, 11x11 s4, 3x3 s2 p0; 24, 32, 64 and 96
    channels), an odd stride and size, FCN's pad of 100 and one or two
    channels; and so does ``stem_conv_plain`` wherever the padding is at
    most (k - 1) / 2, every zoo stem but FCN's (PyTorch's CPU conv sums
    those in that order; a larger pad takes another of its paths).  Every
    plan keeps two blocks an SM within 227 KB and fits ResNet-50's and
    MobileNet's full-size stems."""
    rng = np.random.default_rng(1)
    cases = ((7, 2, 3, 64, 3, (30, 26)), (3, 2, 1, 32, 3, (23, 30)),
             (3, 1, 1, 64, 3, (13, 17)), (11, 4, 0, 96, 3, (43, 39)),
             (3, 2, 0, 64, 3, (21, 25)), (3, 2, 1, 24, 3, (16, 16)),
             (5, 3, 2, 32, 3, (37, 41)), (3, 1, 100, 64, 3, (6, 5)),
             (3, 1, 1, 32, 1, (9, 14)), (5, 2, 2, 32, 2, (11, 10)))
    for k, s, p, co, c, (h, wd) in cases:
        x = torch.from_numpy(rng.normal(size=(2, h, wd, c))).to(
            torch.bfloat16)
        w = torch.from_numpy(rng.normal(size=(k, k, c, co)) / k).to(
            torch.bfloat16)
        bias = torch.from_numpy(rng.normal(size=co) * 0.1).float()
        for act in ACTS:
            want = _sequential(x, w, bias, (s, s), (p, p), act, 30.0)
            got = _emulate(x, w, bias, (s, s), (p, p), act, 30.0)
            diff = int((got != want).sum())
            assert diff == 0, (k, s, p, co, c, act, diff)
            if 2 * p <= k - 1:
                plain = stem_conv_plain(x, w, bias, (s, s), (p, p), act,
                                        30.0)
                assert torch.equal(plain, want), (k, s, p, co, c, act)
    for args in ((224, 224, 3, 7, 7, 64, 2, 2, 3, 3),
                 (224, 224, 3, 3, 3, 32, 2, 2, 1, 1),
                 (224, 224, 3, 7, 7, 96, 2, 2, 0, 0),
                 (600, 800, 3, 3, 3, 64, 1, 1, 1, 1)):
        plan = stem_plan(*args)
        assert plan is not None and 2 * plan.smem + 2048 <= 232448, args


# The route of every zoo builder's stem under w8a8 on the "cuda" backend,
# bf16 compute: "kernel" (stem_conv_int8), "fallback" (an int8-emitting
# stem the kernel does not take: stem_conv_plain, counted) or "float" (a
# stem that emits bf16: stem_conv_plain, not counted; AlexNet's feeds an
# LRN on float edges, MobileNet-v2's and the ShuffleNets' a float grouped
# conv)
ZOO_ROUTES = {
    "alexnet": "float", "deeplab_largefov": "kernel",
    "densenet121": "kernel", "densenet169": "kernel", "densenet201": "kernel",
    "faster_rcnn_vgg16": "kernel", "fcn16s": "kernel", "fcn32s": "kernel",
    "fcn8s": "kernel", "googlenet": "kernel", "inception_v3": "kernel",
    "mobilenet_ssd": "kernel", "mobilenet_v1": "kernel",
    "mobilenet_v2": "float", "pspnet50": "kernel", "resnet101": "kernel",
    "resnet152": "kernel", "resnet50": "kernel", "resnext50": "kernel",
    "rfcn_resnet101": "kernel", "se_resnet50": "kernel",
    "shufflenet_v1": "float", "shufflenet_v2": "float",
    "squeezenet_v10": "kernel", "squeezenet_v11": "kernel",
    "vgg16": "kernel", "vgg16_ssd300": "kernel", "vgg19": "kernel",
}


def _stem_route(eng):
    """The route the dispatcher's float branch gives the engine's stem (its
    first conv), from its node and quant marks alone."""
    g = eng.graph
    node = next(n for n in g.nodes if n.op == "Convolution")
    q = g.meta.get("quant", {}).get(node.name) or {}
    kh, kw = node.attrs["kernel_h"], node.attrs["kernel_w"]
    s, p = node.attrs["stride"], node.attrs["pad_h"]
    c = g.specs[node.inputs[0]].shape[-1]
    x = torch.empty(g.specs[node.inputs[0]].shape, dtype=torch.bfloat16,
                    device="meta")
    w = torch.empty((kh, kw, c, node.attrs["num_output"]),
                    dtype=torch.bfloat16, device="meta")
    if not q.get("emit_int8") or c > 4:
        return "float"
    ok = takes_stem_kernel(x, w, (s, s), (p, p), node.attrs.get("group", 1),
                           node.attrs.get("dilation", 1), torch.int8,
                           node.attrs.get("act_segments"))
    return "kernel" if ok else "fallback"


def test_every_zoo_stem_routes_by_what_the_dispatcher_sees(monkeypatch):
    """``takes_stem_kernel`` on every zoo builder's stem (w8a8, bf16, its
    baked config; scales set, weights quantized to zeros: the route reads
    shapes and marks), listed by model; ResNet-50 with ``s2d_stem`` (a 4x4
    stem on 12 channels) and in bf16 take the float branch; and stems the
    kernel does not take fall back: 16 or 48 channels, a 13x13 kernel, a
    stride of 5, a dilation, act_segments, an f32 input."""
    monkeypatch.setattr(rewrite, "quantize_weight_per_channel", lambda w: (
        np.zeros(w.shape, np.int8), np.ones(w.shape[-1], np.float32)))
    assert sorted(ZOO_ROUTES) == sorted(MODEL_BUILDERS)
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16", quant="w8a8")
    routes = {}
    for name in MODEL_BUILDERS:
        g = build_model(name, batch=1)
        plain = Engine(copy.copy(g), EngineConfig(backend="cuda"),
                       device="cpu").graph
        values = {v for n in plain.nodes for v in n.inputs + n.outputs}
        g.meta["value_scales"] = dict.fromkeys(values, 0.05)
        g.meta["act_scales"] = {n.name: 0.05 for n in plain.nodes
                                if n.op in ("Convolution", "InnerProduct")}
        routes[name] = _stem_route(Engine(g, cfg, device="cpu"))
        if name == "resnet50":
            assert _stem_route(Engine(g, cfg.replace(s2d_stem=True),
                                      device="cpu")) == "float"
            assert _stem_route(Engine(g, cfg.replace(quant=None),
                                      device="cpu")) == "float"
        del g, plain
    assert routes == ZOO_ROUTES
    x = torch.empty(2, 64, 64, 3, dtype=torch.bfloat16, device="meta")

    def w(k, co, c=3, dtype=torch.bfloat16):
        return torch.empty(k, k, c, co, dtype=dtype, device="meta")
    assert takes_stem_kernel(x, w(7, 64), (2, 2), (3, 3))
    for what, args, kw in (
            ("16 channels", (x, w(7, 16), (2, 2), (3, 3)), {}),
            ("48 channels", (x, w(3, 48), (2, 2), (1, 1)), {}),
            ("13x13", (x, w(13, 64), (2, 2), (6, 6)), {}),
            ("stride 5", (x, w(7, 64), (5, 5), (3, 3)), {}),
            ("dilation 2", (x, w(3, 64), (1, 1), (2, 2)), {"dilation": 2}),
            ("segments", (x, w(3, 64), (1, 1), (1, 1)),
             {"segments": (("relu", 32), (None, 32))}),
            ("an f32 input", (x.float(), w(3, 64), (1, 1), (1, 1)), {}),
            ("bf16 out", (x, w(3, 64), (1, 1), (1, 1)),
             {"out_dtype": torch.bfloat16})):
        assert not takes_stem_kernel(*args, **kw), what


def test_counters_move_only_on_the_cuda_backend(monkeypatch):
    """The dispatcher counts a stem it sends to PyTorch's conv in
    ``stem_conv_int8.fallbacks`` on the "cuda" backend alone (the "torch"
    backend, the float oracle, never reaches it); a CPU tensor takes the
    plain version, so ``launches`` stays 0 here; every route gives the
    plain output.  The wrapper refuses what has no kernel: another device,
    an unknown activation."""
    from feathercnn_tpu_torch.ops.lowering import lower_node
    monkeypatch.setattr(stem_conv_int8, "launches", 0)
    monkeypatch.setattr(stem_conv_int8, "fallbacks", 0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 20, 20, 3))).to(torch.bfloat16)
    for co, fallback in ((64, 0), (48, 1)):
        w = torch.from_numpy(rng.integers(-127, 128, size=(3, 3, 3, co),
                                          dtype=np.int8))
        q = {"w_scale": np.full(co, 0.01, np.float32), "input_scale": 0.03,
             "emit_int8": True, "y_scale": 0.04}
        node = _node(3, 2, 1, co, "relu", Node)
        bias = torch.zeros(co)
        wd = (w.float() * 0.01).to(torch.bfloat16)
        want = stem_conv_plain(x, wd, bias, (2, 2), (1, 1), "relu", 25.0)
        for backend in ("torch", "cuda"):
            before = stem_conv_int8.fallbacks
            (got,) = lower_node(node, [x], [w, bias], _port_ctx(backend, q))
            if backend == "cuda":
                assert torch.equal(got, want), co
            assert stem_conv_int8.fallbacks - before == (
                fallback if backend == "cuda" else 0), (co, backend)
    assert stem_conv_int8.launches == 0
    wd = torch.zeros(3, 3, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        stem_conv_int8(x.to("meta"), wd.to("meta"), None, (2, 2), (1, 1))
    with pytest.raises(ValueError, match="unknown activation"):
        stem_conv_int8(x, wd, None, (2, 2), (1, 1), "tanh")
