"""The GEMM kernels' weight layout and launch plan, on the CPU.

``gemm_layout`` stores a weight as the CUDA kernels read it ((N, K), K
contiguous, an int8 weight's rows padded to a multiple of 16 bytes) with
its values and logical shape unchanged, so the plain versions take it as
they take the original.  ``gemm_plan`` picks each
launch's main loop, tile and stages on the host; here it is held to what
the wgmma design needs at every GEMM launch shape of the three served
models at their chip batches, found by running each model's int8 forward
on the CPU at batch 1 with the two kernel entry points replaced by
recorders (M scales with the batch).

Tolerances: int8 outputs equal (0 LSB); bf16 within 1 bf16 ulp plus 1e-5
of the sum's magnitude, as tests/test_torch_kernels.py holds them.  Few
test items (see tests/test_torch_kernels.py for why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feathercnn_tpu.kernels.conv import conv2d_implicit_gemm as jconv
from feathercnn_tpu.kernels.matmul import matmul_epilogue as jmm
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
from feathercnn_tpu_torch.kernels.matmul import (SMEM_LIMIT, gemm_layout,
                                                 gemm_pitch, gemm_plan,
                                                 is_gemm_layout, launch_args,
                                                 matmul_epilogue)
from feathercnn_tpu_torch.models import mobilenet_v1, mobilenet_v2, resnet50
from feathercnn_tpu_torch.models.builder import GraphBuilder
from feathercnn_tpu_torch.quant import calibrate


def _bf16_close(got, want, case):
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= ulp + 1e-5 * np.abs(w).max()).all(), case


def test_gemm_layout_keeps_values_and_the_pallas_results():
    rng = np.random.default_rng(5)
    for shape in [(64, 96), (24, 1000), (1, 7), (3, 3, 16, 40),
                  (1, 1, 64, 256), (7, 7, 3, 64)]:
        w = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        lw = gemm_layout(w)
        assert lw.shape == w.shape and torch.equal(lw, w), shape
        assert is_gemm_layout(lw), shape
        k_major = lw.t() if lw.dim() == 2 else lw.permute(3, 0, 1, 2)
        k = k_major[0].numel()
        assert k_major[0].is_contiguous(), shape
        # int8 rows padded to whole 16-byte pieces (zeros past K)
        assert gemm_pitch(lw) == -(-k // 16) * 16, shape
        rows = torch.as_strided(lw, (shape[-1], gemm_pitch(lw)),
                                (gemm_pitch(lw), 1))
        assert not rows[:, k:].any(), shape
        if min(shape[-2:]) > 1:
            assert not is_gemm_layout(w.contiguous()), shape
    with pytest.raises(ValueError):
        gemm_layout(torch.zeros(2, 3, 4))

    for (m, k, n, out) in [(130, 64, 200, "int8"), (77, 48, 1000, "bf16")]:
        x = rng.integers(-127, 128, (m, k), dtype=np.int8)
        w = rng.integers(-127, 128, (k, n), dtype=np.int8)
        ws = rng.uniform(1e-4, 2e-4, n).astype(np.float32)
        b = rng.normal(size=n).astype(np.float32)
        odt = {"int8": (jnp.int8, torch.int8),
               "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
        want = jmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                   w_scale=jnp.asarray(ws), activation="relu",
                   out_dtype=odt[0], x_scale=0.02, out_scale=0.7,
                   interpret=True)
        got = matmul_epilogue(torch.from_numpy(x),
                              gemm_layout(torch.from_numpy(w)),
                              torch.from_numpy(b), torch.from_numpy(ws),
                              activation="relu", out_dtype=odt[1],
                              x_scale=0.02, out_scale=0.7)
        case = f"matmul {(m, k, n)} {out}"
        if out == "int8":
            assert np.array_equal(got.numpy(), np.asarray(want)), case
        else:
            _bf16_close(got, want, case)
    for (nb, h, c, co, s) in [(2, 9, 32, 48, 2), (1, 8, 16, 64, 1)]:
        x = rng.integers(-127, 128, (nb, h, h, c), dtype=np.int8)
        w = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
        ws = rng.uniform(1e-4, 2e-4, co).astype(np.float32)
        b = rng.normal(size=co).astype(np.float32)
        want = jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     w_scale=jnp.asarray(ws), stride=s, pad_h=1, pad_w=1,
                     activation="relu6", out_dtype=jnp.int8, x_scale=0.02,
                     out_scale=5.0, interpret=True)
        got = conv2d_implicit_gemm(torch.from_numpy(x),
                                   gemm_layout(torch.from_numpy(w)),
                                   torch.from_numpy(b), torch.from_numpy(ws),
                                   stride=s, pad_h=1, pad_w=1,
                                   activation="relu6", out_dtype=torch.int8,
                                   x_scale=0.02, out_scale=5.0)
        assert np.array_equal(got.numpy(), np.asarray(want)), (nb, h, c, s)


def _launch_shapes(monkeypatch, build, batch, overrides):
    """Every GEMM launch of the model's int8 forward as (kernel, M at
    ``batch``, K, N, conv C or None, x dtype, w dtype, out dtype), from a
    batch-1 forward on the CPU whose two kernel entry points record their
    arguments and return zeros of the output's shape."""
    g = build(batch=batch)
    x = np.random.default_rng(0).normal(size=(1, 224, 224, 3)).astype(
        np.float32)
    calibrate(g, [x], method="max", device="cpu")
    dw = tuple((n.name, "depthwise") for n in g.nodes
               if n.attrs.get("group", 1) > 1)
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16",
                       quant="w8a8", algo_overrides=dw if overrides else ())
    seen = []

    def fake_mm(x, w, bias=None, w_scale=None, activation=None,
                out_dtype=None, **kw):
        assert is_gemm_layout(w)
        seen.append(("matmul_epilogue", x.shape[0] * batch, x.shape[1],
                     w.shape[1], None, x.dtype, w.dtype, out_dtype))
        return torch.zeros(x.shape[0], w.shape[1], dtype=out_dtype)

    def fake_conv(x, w, bias=None, w_scale=None, stride=1, pad_h=0, pad_w=0,
                  activation=None, out_dtype=None, **kw):
        assert is_gemm_layout(w)
        kh, kw_, c, co = w.shape
        oh = (x.shape[1] + 2 * pad_h - kh) // stride + 1
        ow = (x.shape[2] + 2 * pad_w - kw_) // stride + 1
        seen.append(("conv2d_implicit_gemm", oh * ow * batch, kh * kw_ * c,
                     co, c, x.dtype, w.dtype, out_dtype))
        return torch.zeros(x.shape[0], oh, ow, co, dtype=out_dtype)

    monkeypatch.setattr(dispatch, "matmul_epilogue", fake_mm)
    monkeypatch.setattr(dispatch, "conv2d_implicit_gemm", fake_conv)
    Engine(g, cfg, device="cpu")(x)
    monkeypatch.undo()
    return seen


def test_plan_takes_wgmma_at_every_served_launch(monkeypatch):
    """ResNet-50 b128, MobileNet-v1 b256 and MobileNet-v2 b128 (depthwise
    override) as the chip run drives them: 49, 14 and 35 GEMM launches;
    every one plans "wgmma" with at most 227 KB of shared memory, a tile
    width that is a multiple of 8 and at most 256, and >= 2 stages, but
    MobileNet-v2's K = 24 launches (a 24-byte row pitch), which plan
    "wgmma_ragged" with that reason (the same bounds, a staging ring of
    >= 2 tiles, the weight's rows 32 bytes apart)."""
    for build, batch, dw, want_count in [(resnet50, 128, False, 49),
                                         (mobilenet_v1, 256, False, 14),
                                         (mobilenet_v2, 128, True, 35)]:
        shapes = _launch_shapes(monkeypatch, build, batch, dw)
        assert len(shapes) == want_count, (build.__name__, len(shapes))
        for (kernel, m, k, n, c, xdt, wdt, odt) in shapes:
            case = f"{build.__name__} b{batch} {kernel} M={m} K={k} N={n}"
            assert xdt == torch.int8 and wdt == torch.int8, case
            p = gemm_plan(m, k, n, xdt, wdt, odt, conv_c=c)
            if k % 16:
                assert build is mobilenet_v2 and k == 24, case
                assert p.variant == "wgmma_ragged", (case, p)
                assert "not a multiple of 16" in p.reason, (case, p)
                assert p.sst >= 2 and p.ldw == 32, (case, p)
            else:
                assert p.variant == "wgmma" and not p.reason, (case, p)
            assert p.smem <= SMEM_LIMIT and p.stages >= 2, (case, p)
            assert p.bn % 8 == 0 and 32 <= p.bn <= 256, (case, p)
            assert p.bk in (64, 128) and (p.bk == 64) == (k <= 64), (case, p)
            assert 1 <= p.grid <= 132, (case, p)
            n_tiles = -(-n // p.bn)
            assert p.grid % n_tiles == 0, (case, p)
    i8, bf = torch.int8, torch.bfloat16
    assert gemm_plan(401408, 24, 144, i8, i8, bf).variant == "wgmma_ragged"
    p = gemm_plan(1000, 64, 64, i8, i8, i8, x_ptr=8)
    assert p.variant == "wgmma_ragged" and "aligned" in p.reason
    p = gemm_plan(1000, 9 * 8, 64, i8, i8, i8, conv_c=8)
    assert p.variant == "wgmma_ragged" and p.reason == "C < 16"
    # what neither takes keeps the first body, both reasons given
    p = gemm_plan(1000, 9 * 8, 64, i8, i8, i8, conv_c=8, x_ptr=4)
    assert p.variant == "mma_sync" and p.reason.endswith(
        "x not 8-byte aligned"), p
    p = gemm_plan(1000, 7 * 7 * 3, 64, i8, i8, i8, conv_c=3)
    assert p.variant == "mma_sync" and "not a multiple of 8" in p.reason
    p = gemm_plan(1000, 300, 64, i8, i8, i8)
    assert p.variant == "mma_sync" and "K = 300 > 256" in p.reason
    for odt in (i8, bf, torch.float32):     # every output type fits
        p = gemm_plan(401408, 2048, 2560, i8, i8, odt)
        assert p.variant == "wgmma" and p.smem <= SMEM_LIMIT and \
            p.stages >= 2, (odt, p)
    assert gemm_plan(128, 2048, 1000, bf, bf, bf).variant == "wgmma_bf16"
    assert gemm_plan(128, 2044, 1000, bf, bf, bf).variant == "simt"
    assert gemm_plan(128, 2048, 1000, bf, bf, bf, x_ptr=8).variant == "simt"
    assert gemm_plan(77, 64, 24, torch.float32, torch.float32,
                     torch.float32).variant == "simt"


def _small_int8_graph():
    """Stem, a 1x1, a 3x3 and a merged pair of 1x1 convs, an FC: every
    route into the two GEMM kernels."""
    b = GraphBuilder("small_gemm", seed=4)
    x = b.input("data", (2, 20, 20, 3))
    x = b.relu("c1_relu", b.conv("c1", x, 16, 3, 2, 1))
    y = b.relu("c2_relu", b.conv("c2", x, 32, 1))
    y = b.relu("c3_relu", b.conv("c3", y, 32, 3, 1, 1))
    s1 = b.relu("s1_relu", b.conv("s1", y, 16, 1))
    s2 = b.conv("s2", y, 48, 1)
    z = b.eltwise("sum", [b.conv("p1", s1, 48, 1), s2])
    z = b.pool("gp", z, 0, mode="AVE", global_pooling=True)
    return b.finish([b.fc("fc", z, 10)])


def test_lowering_lays_out_each_gemm_weight_once(monkeypatch):
    g = _small_int8_graph()
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(2, 20, 20, 3)).astype(np.float32)
          for _ in range(2)]
    calibrate(g, xs[:1], method="max", device="cpu")
    eng = Engine(g, EngineConfig(backend="cuda", quant="w8a8"), device="cpu")
    made, passed = [], []
    real = dispatch.gemm_layout
    monkeypatch.setattr(dispatch, "gemm_layout",
                        lambda w: made.append(w.shape) or real(w))
    for name in ("matmul_epilogue", "conv2d_implicit_gemm"):
        fn = getattr(dispatch, name)

        def rec(x, w, *a, _fn=fn, **kw):
            assert is_gemm_layout(w) and w.dtype == torch.int8
            passed.append(w)
            return _fn(x, w, *a, **kw)
        monkeypatch.setattr(dispatch, name, rec)
    outs = [eng(x) for x in xs]
    n = len(passed) // 2
    assert n >= 5 and len(passed) == 2 * n, len(passed)
    assert len(made) == n, (made, n)           # once per node, not per call
    assert all(a is b for a, b in zip(passed[:n], passed[n:]))
    monkeypatch.undo()
    ref = Engine(g, EngineConfig(backend="cuda", quant="w8a8"),
                 device="cpu")
    for x, out in zip(xs, outs):
        assert torch.equal(ref(x), out)
    # on the GPU the wrappers refuse any other layout, before the launch
    x = torch.zeros(4, 8, dtype=torch.int8)
    vecs = dict.fromkeys(("bias", "w_scale", "lo", "hi"))
    with pytest.raises(ValueError, match="gemm_layout"):
        launch_args(x, torch.zeros(8, 3, dtype=torch.int8), None, vecs, None,
                    torch.int8)
