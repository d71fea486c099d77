"""The weight-only int8 variant of the GEMM kernels ("wgmma_w8": bf16 x,
int8 w, f32 sums) on the CPU.

- ``gemm_plan`` gives "wgmma_w8" at every GEMM launch shape of VGG-16 b128
  under ``quant="w8"`` (12 convs after the float stem, 3 FCs), found by a
  batch-1 forward whose two kernel entry points record their arguments
  (M scales with the batch), within the shared memory of a block; it
  refuses to "simt", with its reason, a K or C that is not a multiple of
  8 and a misaligned pointer.
- The port's ``matmul_epilogue`` and ``conv2d_implicit_gemm`` on bf16 x
  int8 w (their plain versions on the CPU) against the Pallas kernels in
  interpret mode, on the same seeded numpy inputs.
- The split-K plan's sum order (``matmul_epilogue_split_plain``: f32 sums
  per slice of ``w8_split``'s slices, the slices added in index order)
  against ``matmul_epilogue_plain``.

Tolerances.  Against Pallas: bf16 out within 1 bf16 ulp of the reference
value plus 1e-5 of the magnitude of its sum (the sum of |x*w| terms,
scaled, plus |bias|), as tests/test_torch_kernels.py holds float sums in
another order.  The split-K order: the float gate of ``chip_smoke.py``
(every bf16 output within 2 ulp of the plain value or within 1e-2 of the
largest |value|, at most 0.1% of them more than 1 ulp apart): two f32
orders of the same bf16-exact products.  Few test items (see
tests/test_torch_kernels.py for why).
"""

import jax.numpy as jnp
import numpy as np
import torch

from feathercnn_tpu.kernels.conv import conv2d_implicit_gemm as jconv
from feathercnn_tpu.kernels.matmul import matmul_epilogue as jmm
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
from feathercnn_tpu_torch.kernels.matmul import (
    SMEM_LIMIT, W8_BK, conv_tile, gemm_layout, gemm_plan, is_gemm_layout,
    matmul_epilogue, matmul_epilogue_plain, matmul_epilogue_split_plain,
    w8_smem, w8_split)
from feathercnn_tpu_torch.models import vgg16

BF, I8 = torch.bfloat16, torch.int8


def _vgg16_w8_launches(monkeypatch, batch=128):
    """Every GEMM launch of VGG-16's w8 forward as (kernel, M at
    ``batch``, K, N, conv C or None, x dtype, w dtype, out dtype, the
    conv's (images, OH, OW) and stride or None)."""
    g = vgg16(batch=batch)
    x = np.random.default_rng(0).normal(size=(1, 224, 224, 3)).astype(
        np.float32)
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16", quant="w8")
    seen = []

    def fake_mm(x, w, bias=None, w_scale=None, activation=None,
                out_dtype=None, **kw):
        assert is_gemm_layout(w)
        seen.append(("matmul_epilogue", x.shape[0] * batch, x.shape[1],
                     w.shape[1], None, x.dtype, w.dtype, out_dtype or x.dtype,
                     None, None))
        return torch.zeros(x.shape[0], w.shape[1], dtype=out_dtype or x.dtype)

    def fake_conv(x, w, bias=None, w_scale=None, stride=1, pad_h=0, pad_w=0,
                  activation=None, out_dtype=None, **kw):
        assert is_gemm_layout(w)
        kh, kw_, c, co = w.shape
        oh = (x.shape[1] + 2 * pad_h - kh) // stride + 1
        ow = (x.shape[2] + 2 * pad_w - kw_) // stride + 1
        seen.append(("conv2d_implicit_gemm", oh * ow * batch, kh * kw_ * c,
                     co, c, x.dtype, w.dtype, out_dtype or x.dtype,
                     (batch, oh, ow), stride))
        return torch.zeros(x.shape[0], oh, ow, co, dtype=out_dtype or x.dtype)

    monkeypatch.setattr(dispatch, "matmul_epilogue", fake_mm)
    monkeypatch.setattr(dispatch, "conv2d_implicit_gemm", fake_conv)
    Engine(g, cfg, device="cpu")(x)
    monkeypatch.undo()
    return seen


def test_plan_takes_wgmma_w8_at_every_vgg16_w8_launch(monkeypatch):
    shapes = _vgg16_w8_launches(monkeypatch)
    kernels = [s[0] for s in shapes]
    assert kernels.count("conv2d_implicit_gemm") == 12, kernels
    assert kernels.count("matmul_epilogue") == 3, kernels
    for (kernel, m, k, n, c, xdt, wdt, odt, out, stride) in shapes:
        case = f"vgg16 b128 w8 {kernel} M={m} K={k} N={n}"
        assert xdt == BF and wdt == I8, case
        p = gemm_plan(m, k, n, xdt, wdt, odt, conv_c=c, conv_out=out,
                      stride=stride or 1)
        assert p.variant == "wgmma_w8" and not p.reason, (case, p)
        assert p.smem <= SMEM_LIMIT and 2 <= p.stages <= 6, (case, p)
        assert p.bn in (32, 64, 128) and p.bk == 2 * W8_BK, (case, p)
        n_tiles = -(-n // p.bn)
        assert 1 <= p.grid <= 132 and p.grid % n_tiles == 0, (case, p)
        assert p.smem == w8_smem(p.bn, p.stages, c is not None), (case, p)
        k_steps = -(-k // W8_BK)
        per = -(-k_steps // p.split)
        assert (p.split - 1) * per < k_steps <= p.split * per, (case, p)
        if kernel == "matmul_epilogue":
            # the FCs at M = 128: K split until the tiles fill the SMs
            units = -(-m // 128) * n_tiles * p.split
            assert p.split > 1 and units == p.grid <= 132, (case, p)
            assert p.th == p.tw == 0, (case, p)
        else:
            # stride 1, C a multiple of 64: A by TMA over rectangles of at
            # most 128 output pixels that cover the image
            _, oh, ow = out
            assert stride == 1 and c % 64 == 0, case
            assert p.split == 1 and p.grid == 132, (case, p)
            assert 0 < p.th * p.tw <= 128 and p.th <= oh and p.tw <= ow, \
                (case, p)


def test_plan_refuses_what_wgmma_w8_does_not_take():
    """A row pitch that is not a multiple of 16 bytes (K or C not a
    multiple of 8 bf16) or a misaligned x or w plans "simt" with its
    reason; f32 x keeps "simt" (f32 on the tensor cores is TF32); every
    output type and tile fits in shared memory."""
    for (m, k, n, c, ptrs, why) in [
            (128, 4100, 1000, None, {}, "(K = 4100 bf16)"),
            (1000, 9 * 12, 64, 12, {}, "(C = 12 bf16)"),
            (1000, 64, 64, None, {"x_ptr": 2}, "x not 16-byte aligned"),
            (1000, 9 * 64, 64, 64, {"w_ptr": 8}, "w not 16-byte aligned")]:
        p = gemm_plan(m, k, n, BF, I8, BF, conv_c=c, **ptrs)
        assert p.variant == "simt" and why in p.reason, (m, k, n, c, p)
    p = gemm_plan(128, 4096, 1000, torch.float32, I8, torch.float32)
    assert p.variant == "simt" and not p.reason, p
    # a conv's A is gathered at stride 2 or C not a multiple of 64
    for (c, stride) in [(64, 2), (72, 1), (8, 1)]:
        p = gemm_plan(2 * 9 * 9, 9 * c, 64, BF, I8, BF, conv_c=c,
                      conv_out=(2, 9, 9), stride=stride)
        assert p.variant == "wgmma_w8" and p.th == p.tw == 0, (c, stride, p)
    assert conv_tile(224, 224) == (4, 32) and conv_tile(28, 28) == (4, 28)
    assert conv_tile(14, 14) == (9, 14) and conv_tile(1, 300) == (1, 128)
    for odt in (I8, BF, torch.float32):
        for (m, k, n, c) in [(401408, 2048, 2560, None), (1, 64, 24, None),
                             (100352, 9 * 512, 512, 512),
                             (50, 9 * 8, 40, 8)]:
            p = gemm_plan(m, k, n, BF, I8, odt, conv_c=c)
            assert p.variant == "wgmma_w8" and p.smem <= SMEM_LIMIT, (odt, p)
            assert p.stages >= 2, (odt, p)


def _bf16_close(got, want, mag, case):
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    excess = np.abs(g - w) - ulp - 1e-5 * mag
    assert excess.max() <= 0, f"{case}: off by > 1 ulp: {excess.max()}"


def _w8_operands(rng, x_shape, w_shape):
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=w_shape).astype(np.float32)
    ws = (np.abs(w).max(axis=tuple(range(w.ndim - 1))) / 127.0).astype(
        np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    xb = jnp.asarray(x, jnp.bfloat16)   # the bf16 x both receive
    return xb, torch.from_numpy(np.asarray(xb, np.float32)).to(BF), wq, ws


def test_w8_gemms_match_pallas():
    rng = np.random.default_rng(9)
    for (m, k, n, act) in [(128, 576, 1000, "relu"), (77, 136, 24, None),
                           (1, 64, 200, "relu6")]:
        jx, tx, wq, ws = _w8_operands(rng, (m, k), (k, n))
        b = rng.normal(size=n).astype(np.float32)
        want = jmm(jx, jnp.asarray(wq), jnp.asarray(b),
                   w_scale=jnp.asarray(ws), activation=act,
                   out_dtype=jnp.bfloat16, interpret=True)
        got = matmul_epilogue(tx, gemm_layout(torch.from_numpy(wq)),
                              torch.from_numpy(b), torch.from_numpy(ws),
                              activation=act, out_dtype=BF)
        mag = (np.abs(np.asarray(jx, np.float64)) @ np.abs(wq.astype(
            np.float64))) * ws + np.abs(b)
        _bf16_close(got, want, mag, f"w8 matmul {(m, k, n)}")
    for (nb, h, w, c, co, s) in [(2, 9, 11, 64, 40, 1), (1, 13, 9, 8, 64, 2),
                                 (1, 7, 7, 72, 24, 2)]:
        jx, tx, wq, ws = _w8_operands(rng, (nb, h, w, c), (3, 3, c, co))
        b = rng.normal(size=co).astype(np.float32)
        want = jconv(jx, jnp.asarray(wq), jnp.asarray(b),
                     w_scale=jnp.asarray(ws), stride=s, pad_h=1, pad_w=1,
                     activation="relu", out_dtype=jnp.bfloat16,
                     interpret=True)
        got = conv2d_implicit_gemm(tx, gemm_layout(torch.from_numpy(wq)),
                                   torch.from_numpy(b), torch.from_numpy(ws),
                                   stride=s, pad_h=1, pad_w=1,
                                   activation="relu", out_dtype=BF)
        mag = torch.nn.functional.conv2d(
            torch.from_numpy(np.abs(np.asarray(jx, np.float64))).permute(
                0, 3, 1, 2),
            torch.from_numpy(np.abs(wq.astype(np.float64))).permute(
                3, 2, 0, 1), stride=s, padding=1).permute(0, 2, 3, 1).numpy()
        _bf16_close(got, want, mag * ws + np.abs(b),
                    f"w8 conv {(nb, h, w, c, co, s)}")


def _float_gate(got, want, case):
    k, p = got.double(), want.double()
    err = (k - p).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        p.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    top = float(p.abs().max())
    assert bool(((err <= 2 * ulp) | (err <= 1e-2 * top)).all()), case
    assert int((err > ulp).sum()) <= 1e-3 * err.numel(), case


def test_split_k_order_within_the_float_gate():
    """Each launch's plan, stitched through the plain version of its sum
    order, against the plain version: the FCs of VGG-16 b128 (fc7, fc8
    and a narrow fc6), a batch of 1, a ragged M; one slice is the plain
    version bit for bit."""
    gen = torch.Generator().manual_seed(3)
    for (m, k, n) in [(128, 4096, 1000), (128, 4096, 4096), (1, 25088, 96),
                      (300, 2048, 200)]:
        p = gemm_plan(m, k, n, BF, I8, BF)
        assert p.variant == "wgmma_w8" and p.split == w8_split(
            m, k, p.bn, n, 132) > 1, (m, k, n, p)
        x = torch.randn(m, k, generator=gen).to(BF)
        w = torch.randint(-127, 128, (k, n), generator=gen).to(I8)
        ws = torch.rand(n, generator=gen) * 1e-2 / k ** 0.5 + 1e-4
        b = torch.randn(n, generator=gen)
        want = matmul_epilogue_plain(x, w, b, ws, "relu", BF)
        got = matmul_epilogue_split_plain(x, w, p.split, b, ws, "relu", BF)
        _float_gate(got, want, f"split {p.split} at {(m, k, n)}")
        assert torch.equal(matmul_epilogue_split_plain(
            x, w, 1, b, ws, "relu", BF), want), (m, k, n)
