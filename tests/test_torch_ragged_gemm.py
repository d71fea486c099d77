"""The GEMM kernels' ragged rows ("wgmma_ragged"), on the CPU.

A launch whose rows are not whole 16-byte pieces (K, or a conv's C, not a
multiple of 16) runs on the "wgmma" ring with another A path, and its
int8 weight is stored by ``gemm_layout`` with its (N, K) rows padded to a
16-byte pitch, zeros past K.  Held here:

- ``gemm_plan`` at every GEMM launch of the four chip paths that have
  such launches (ShuffleNet v1 and v2 b128, GoogLeNet b256, MobileNet-v2
  b128 with the depthwise override), found as
  tests/test_torch_gemm_plan.py finds them: each ragged launch plans
  "wgmma_ragged" with its reason on the weight's padded pitch, every
  other "wgmma";
- the padded layout keeps each weight's values and logical shape, and the
  plain versions give the same result on it as on the unpadded weight
  (0 LSB);
- at K = 24, 58, 116 and 232, and for 5x5 and 3x3 convs on C = 24 at
  stride 1 and 2, the port's ``matmul_epilogue`` and
  ``conv2d_implicit_gemm`` (their plain versions on the CPU) equal the
  JAX package's Pallas kernels run in interpret mode, int8 out at 0 LSB,
  on seeded numpy inputs.

Few test items per file: see tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from feathercnn_tpu.kernels.conv import conv2d_implicit_gemm as jconv
from feathercnn_tpu.kernels.matmul import matmul_epilogue as jmm
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.conv import (conv2d_implicit_gemm,
                                               conv2d_implicit_gemm_plain)
from feathercnn_tpu_torch.kernels.matmul import (
    RAGGED_K_MAX, SMEM_LIMIT, gemm_layout, gemm_pitch, gemm_plan,
    is_gemm_layout, matmul_epilogue, matmul_epilogue_plain,
    ragged_stage_bytes, wgmma_smem)
from feathercnn_tpu_torch.models import (googlenet, mobilenet_v2,
                                         shufflenet_v1, shufflenet_v2)
from feathercnn_tpu_torch.quant import calibrate
from test_torch_zoo_rest import _two_threads  # noqa: F401


def _launch_shapes(monkeypatch, build, batch, overrides):
    """Every GEMM launch of the model's w8a8 forward as (kernel, M at
    ``batch``, K, N, conv C or None, x dtype, w dtype, out dtype, the
    weight's row pitch), from a batch-1 forward on the CPU whose two
    kernel entry points record their arguments and return zeros."""
    g = build(batch=batch)
    shape = (1,) + tuple(g.inputs["data"].shape[1:])
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    calibrate(g, [x], method="max", device="cpu")
    dw = tuple((n.name, "depthwise") for n in g.nodes
               if n.op == "Convolution" and n.attrs.get("group", 1) > 1)
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16",
                       quant="w8a8", algo_overrides=dw if overrides else ())
    seen = []

    def fake_mm(x, w, bias=None, w_scale=None, activation=None,
                out_dtype=None, **kw):
        assert is_gemm_layout(w)
        seen.append(("matmul_epilogue", x.shape[0] * batch, x.shape[1],
                     w.shape[1], None, x.dtype, w.dtype, out_dtype,
                     gemm_pitch(w)))
        return torch.zeros(x.shape[0], w.shape[1], dtype=out_dtype)

    def fake_conv(x, w, bias=None, w_scale=None, stride=1, pad_h=0, pad_w=0,
                  activation=None, out_dtype=None, **kw):
        assert is_gemm_layout(w)
        kh, kw_, c, co = w.shape
        oh = (x.shape[1] + 2 * pad_h - kh) // stride + 1
        ow = (x.shape[2] + 2 * pad_w - kw_) // stride + 1
        seen.append(("conv2d_implicit_gemm", oh * ow * batch, kh * kw_ * c,
                     co, c, x.dtype, w.dtype, out_dtype, gemm_pitch(w)))
        return torch.zeros(x.shape[0], oh, ow, co, dtype=out_dtype)

    monkeypatch.setattr(dispatch, "matmul_epilogue", fake_mm)
    monkeypatch.setattr(dispatch, "conv2d_implicit_gemm", fake_conv)
    Engine(g, cfg, device="cpu")(x)
    monkeypatch.undo()
    return seen


def test_plan_takes_wgmma_ragged_at_every_ragged_launch(monkeypatch):
    """The four chip paths with ragged launches: ShuffleNet v1 b128 (1 of
    2 B1 launches, K = 24), v2 b128 (35 of 37: K = 24, 58, 116, 232),
    GoogLeNet b256 (the 5x5 convs of inception 4b and 4c on C = 24) and
    MobileNet-v2 b128 with the depthwise override (2 B1 launches at
    K = 24).  Each ragged launch plans "wgmma_ragged" with the reason
    "wgmma" refuses it, on the weight's pitch padded to 16 bytes (zeros
    past K), with at most 227 KB of shared memory, >= 2 stages, a tile
    width that is a multiple of 8 and at most 256, the grid a multiple of
    the column tiles and, for a matrix, a staging ring of >= 2 tiles whose
    buffers hold a 128-row tile; every other launch plans "wgmma"."""
    want = {(shufflenet_v1, 128, False): (2, 0, 1, 0),
            (shufflenet_v2, 128, False): (37, 0, 35, 0),
            (googlenet, 256, False): (38, 19, 0, 2),
            (mobilenet_v2, 128, True): (35, 0, 2, 0)}
    ks = set()
    for (build, batch, dw), counts in want.items():
        shapes = _launch_shapes(monkeypatch, build, batch, dw)
        ragged = [0, 0]
        for (kernel, m, k, n, c, xdt, wdt, odt, pitch) in shapes:
            case = f"{build.__name__} b{batch} {kernel} M={m} K={k} N={n}"
            assert xdt == torch.int8 and wdt == torch.int8, case
            conv = kernel == "conv2d_implicit_gemm"
            p = gemm_plan(m, k, n, xdt, wdt, odt, conv_c=c, w_pitch=pitch)
            assert p.ldw == pitch == -(-k // 16) * 16, (case, p)
            if (c if conv else k) % 16:
                ragged[conv] += 1
                ks.add((k, c))
                assert p.variant == "wgmma_ragged", (case, p)
                assert "not a multiple of 16" in p.reason, (case, p)
                if not conv:
                    assert k <= RAGGED_K_MAX and p.sst in (2, 4), (case, p)
                    assert ragged_stage_bytes(k) >= 128 * k + 20, case
                    osize = torch.empty((), dtype=odt).element_size()
                    assert p.smem == wgmma_smem(
                        p.bn, p.bk, p.stages, -(-k // p.bk), p.bres, osize,
                        False, ragged_stage_bytes(k), p.sst), (case, p)
                else:
                    assert p.sst == 0, (case, p)
            else:
                assert p.variant == "wgmma" and not p.reason, (case, p)
            assert p.smem <= SMEM_LIMIT and p.stages >= 2, (case, p)
            assert p.bn % 8 == 0 and 32 <= p.bn <= 256, (case, p)
            assert p.bk in (64, 128) and (p.bk == 64) == (k <= 64), (case, p)
            assert 1 <= p.grid <= 132 and p.grid % -(-n // p.bn) == 0, \
                (case, p)
        got = (sum(s[0] == "matmul_epilogue" for s in shapes),
               sum(s[0] == "conv2d_implicit_gemm" for s in shapes), *ragged)
        assert got == counts, (build.__name__, got)
    assert {k for k, c in ks if c is None} == {24, 58, 116, 232}, ks
    assert {(k, c) for k, c in ks if c is not None} == {(600, 24)}, ks


def test_padded_layout_keeps_values_and_plain_results():
    """An int8 weight whose K is not a multiple of 16 keeps its values and
    logical shape in ``gemm_layout``, its rows 16-byte pieces apart with
    zeros past K; its plain products (matrix and conv, every output type)
    equal those on the unpadded weight, int8 at 0 LSB and the float ones
    bit for bit; a float weight is not padded."""
    rng = np.random.default_rng(13)
    for shape in [(24, 144), (58, 58), (116, 116), (232, 232), (24, 1),
                  (5, 5, 24, 64), (3, 3, 24, 40), (1, 1, 58, 116)]:
        w = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        lw = gemm_layout(w)
        k = w.numel() // shape[-1]
        assert lw.shape == w.shape and torch.equal(lw, w), shape
        assert is_gemm_layout(lw) and gemm_pitch(lw) == -(-k // 16) * 16, \
            shape
        rows = torch.as_strided(lw, (shape[-1], gemm_pitch(lw)),
                                (gemm_pitch(lw), 1))
        assert torch.equal(rows[:, :k], w.reshape(k, -1).t()), shape
        assert not rows[:, k:].any(), shape
        assert gemm_pitch(gemm_layout(w.float())) == k, shape
        n = shape[-1]
        bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        ws = torch.from_numpy(rng.uniform(1e-4, 2e-4, n).astype(np.float32))
        for out in (torch.int8, torch.bfloat16, torch.float32):
            ep = dict(bias=bias, w_scale=ws, activation="relu",
                      out_dtype=out, x_scale=0.02, out_scale=0.7)
            if w.dim() == 2:
                x = torch.from_numpy(rng.integers(-127, 128, (37, k),
                                                  dtype=np.int8))
                got = matmul_epilogue(x, lw, **ep)
                want = matmul_epilogue_plain(x, w.contiguous(), **ep)
            else:
                x = torch.from_numpy(rng.integers(
                    -127, 128, (2, 9, 7, shape[2]), dtype=np.int8))
                conv = dict(stride=2, pad_h=shape[0] // 2,
                            pad_w=shape[0] // 2, **ep)
                got = conv2d_implicit_gemm(x, lw, **conv)
                want = conv2d_implicit_gemm_plain(x, w.contiguous(), **conv)
            assert got.dtype == out and torch.equal(got, want), (shape, out)


def test_ragged_matmul_matches_pallas():
    """K = 24, 58, 116, 232 (the ShuffleNets' and MobileNet-v2's ragged
    1x1 convs), M not a multiple of 128, N ragged too: the port's
    ``matmul_epilogue`` on the padded weight equals the reference's Pallas
    kernel (interpret mode), int8 out at 0 LSB, relu and relu6."""
    rng = np.random.default_rng(14)
    for (m, k, n, act) in [(130, 24, 144, "relu6"), (77, 58, 58, "relu"),
                           (200, 116, 116, "relu"), (61, 232, 232, None)]:
        x = rng.integers(-127, 128, (m, k), dtype=np.int8)
        w = rng.integers(-127, 128, (k, n), dtype=np.int8)
        ws = (rng.uniform(0.5, 1.5, n) * 1e-3 / np.sqrt(k)).astype(np.float32)
        b = rng.normal(size=n).astype(np.float32)
        want = jmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                   w_scale=jnp.asarray(ws), activation=act,
                   out_dtype=jnp.int8, x_scale=0.05, out_scale=20.0,
                   interpret=True)
        got = matmul_epilogue(torch.from_numpy(x),
                              gemm_layout(torch.from_numpy(w)),
                              torch.from_numpy(b), torch.from_numpy(ws),
                              activation=act, out_dtype=torch.int8,
                              x_scale=0.05, out_scale=20.0)
        assert np.array_equal(got.numpy(), np.asarray(want)), (m, k, n)
        assert len(np.unique(got.numpy())) > 16, (m, k, n)   # not saturated


def test_ragged_conv_matches_pallas():
    """5x5 (GoogLeNet's inception 4b/4c 5x5 convs: C = 24, pad 2) and 3x3
    convs on C = 24 at stride 1 and 2, odd H and W: the port's
    ``conv2d_implicit_gemm`` on the padded weight equals the reference's
    Pallas kernel (interpret mode), int8 out at 0 LSB."""
    rng = np.random.default_rng(15)
    for (nb, h, w_, kk, co, s) in [(2, 14, 14, 5, 64, 1),
                                   (1, 13, 11, 5, 40, 2),
                                   (2, 9, 11, 3, 32, 1), (1, 10, 9, 3, 24, 2)]:
        x = rng.integers(-127, 128, (nb, h, w_, 24), dtype=np.int8)
        w = rng.integers(-127, 128, (kk, kk, 24, co), dtype=np.int8)
        k = kk * kk * 24
        ws = (rng.uniform(0.5, 1.5, co) * 1e-3 / np.sqrt(k)).astype(np.float32)
        b = rng.normal(size=co).astype(np.float32)
        p = kk // 2
        want = jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     w_scale=jnp.asarray(ws), stride=s, pad_h=p, pad_w=p,
                     activation="relu", out_dtype=jnp.int8, x_scale=0.05,
                     out_scale=20.0, interpret=True)
        got = conv2d_implicit_gemm(torch.from_numpy(x),
                                   gemm_layout(torch.from_numpy(w)),
                                   torch.from_numpy(b), torch.from_numpy(ws),
                                   stride=s, pad_h=p, pad_w=p,
                                   activation="relu", out_dtype=torch.int8,
                                   x_scale=0.05, out_scale=20.0)
        case = (nb, h, w_, kk, co, s)
        assert np.array_equal(got.numpy(), np.asarray(want)), case
        assert len(np.unique(got.numpy())) > 16, case
