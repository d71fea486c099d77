"""The depthwise kernel's launch plan (``dw_plan``), on the CPU.

The CUDA kernel (``kernels/csrc/depthwise_conv.cu``) runs only on the
card; its geometry is made here, on the host, and held here: every
depthwise launch shape of MobileNet-v1 b256 and MobileNet-v2 b128 (found by
running each model's int8 forward at batch 1 on the CPU with the two
depthwise entry points replaced by recorders, on both routes) and ragged
shapes plan a variant, a tile, a channel slice and shared memory that the
kernel takes, and whose blocks cover every output exactly once.  Then the
plan's tiling is emulated with the plain versions: each block's input
window (zero outside the image, as the kernel stages it) through the plain
version without padding, the results stitched together, against the plain
version on the whole tensor.

Tolerance: equality.  Both sides run the same plain code on the same
values in the same tap order; only the cut into windows differs, which the
kernel's zero-filled staging makes exact.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.depthwise import (
    DW_MAX_THREADS, DW_V, depthwise_conv2d_int8_plain,
    depthwise_conv2d_plain, dw_plan)
from feathercnn_tpu_torch.kernels.matmul import SMEM_LIMIT
from feathercnn_tpu_torch.models import mobilenet_v1, mobilenet_v2
from feathercnn_tpu_torch.quant import calibrate

_SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def _check_plan(p, n, h, w, c, kh, kw, s, ph, pw, xs, ss, case):
    """What the kernel checks before its launch, and that the blocks cover
    every output (image, row, column, channel) exactly once."""
    oh = (h + 2 * ph - kh) // s + 1
    ow = (w + 2 * pw - kw) // s + 1
    rw = {"tiled": 1, "k3s1": 8, "k3s2": 4}[p.variant]
    want = ("k3s1" if (kh, kw, s) == (3, 3, 1) else
            "k3s2" if (kh, kw, s) == (3, 3, 2) else "tiled")
    assert p.variant == want, case
    ch = 16 // xs
    assert p.tw % rw == 0 and p.cs % ch == 0 and p.cs % DW_V == 0, case
    assert p.pitch % 16 == 0 and p.pitch >= p.cs * ss, case
    assert p.threads == (p.cs // DW_V) * p.th * (p.tw // rw), case
    assert 1 <= p.threads <= DW_MAX_THREADS, case
    wh, ww = (p.th - 1) * s + kh, (p.tw - 1) * s + kw
    assert p.smem == wh * ww * p.pitch + 4 * kh * kw * p.cs, case
    assert p.smem <= SMEM_LIMIT, case
    tiles = -(-oh // p.th) * -(-ow // p.tw)
    assert p.grid == (n * tiles, -(-c // p.cs)), case
    assert p.grid[0] <= 0x7fffffff and p.grid[1] <= 65535, case
    assert len(p.args()) == 7, case
    # coverage: each block's outputs, clipped to the tensor, counted once
    # per image (the blocks of every image are alike)
    seen = np.zeros((oh, ow, c), np.int32)
    for t in range(tiles):
        ty, tx = divmod(t, -(-ow // p.tw))
        for cy in range(p.grid[1]):
            seen[ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw,
                 cy * p.cs:(cy + 1) * p.cs] += 1
    assert (seen == 1).all(), case


def _launches(monkeypatch, build, batch):
    """(int variant, x dtype, out dtype, N at ``batch``, H, W, C, KH, KW,
    stride, pad) of every depthwise launch of the model's int8 forward on
    the default route and with the depthwise override."""
    g = build(batch=batch)
    x = np.random.default_rng(0).normal(size=(1, 224, 224, 3)).astype(
        np.float32)
    calibrate(g, [x], method="max", device="cpu")
    dw = tuple((nd.name, "depthwise") for nd in g.nodes
               if nd.attrs.get("group", 1) > 1)
    seen = []

    def rec(int_variant):
        def fake(x, w, *a, stride=1, pad_h=0, pad_w=0, out_dtype=None,
                 **kw):
            kh, kw_ = w.shape[0], w.shape[1]
            oh = (x.shape[1] + 2 * pad_h - kh) // stride + 1
            ow = (x.shape[2] + 2 * pad_w - kw_) // stride + 1
            odt = out_dtype or (torch.bfloat16 if x.dtype == torch.int8
                                else x.dtype)
            seen.append((int_variant, x.dtype, odt, batch, x.shape[1],
                         x.shape[2], x.shape[3], kh, kw_, stride, pad_h))
            return torch.zeros(x.shape[0], oh, ow, x.shape[3], dtype=odt)
        return fake

    for over in ((), dw):
        monkeypatch.setattr(dispatch, "depthwise_conv2d", rec(False))
        monkeypatch.setattr(dispatch, "depthwise_conv2d_int8", rec(True))
        Engine(g, EngineConfig(backend="cuda", compute_dtype="bfloat16",
                               quant="w8a8", algo_overrides=over),
               device="cpu")(x)
        monkeypatch.undo()
    return seen


def test_dw_plan_at_every_served_launch_and_ragged_shapes(monkeypatch):
    """MobileNet-v1 b256 (13 depthwise launches on each route) and -v2
    b128 (17 on the override route; its default route takes PyTorch's
    grouped conv): each plans "k3s1" or "k3s2" within the kernel's
    limits, covering every output once; so do ragged shapes (odd H/W,
    stride 2 on odd inputs, C below one vector and not a multiple of it, a
    5x5 kernel, batch 1).  The int8 variant refuses more taps than its exact f32 sum
    takes."""
    for build, batch, count in [(mobilenet_v1, 256, 26),
                                (mobilenet_v2, 128, 17)]:
        shapes = _launches(monkeypatch, build, batch)
        assert len(shapes) == count, (build.__name__, len(shapes))
        for (iv, xdt, odt, n, h, w, c, kh, kw, s, p) in shapes:
            case = (build.__name__, iv, xdt, n, h, w, c, s)
            assert (kh, kw, p) == (3, 3, 1) and s in (1, 2), case
            # the staged type: int8 for the int8 variant, the output's
            # type for the float variant's int8 x, else x's
            staged = (torch.int8 if iv else
                      odt if xdt == torch.int8 else xdt)
            plan = dw_plan(n, h, w, c, kh, kw, s, p, p, _SIZE[xdt],
                           _SIZE[staged], iv)
            _check_plan(plan, n, h, w, c, kh, kw, s, p, p, _SIZE[xdt],
                        _SIZE[staged], case)
    for case in [(1, 15, 13, 24, 3, 2, 1), (2, 9, 9, 8, 3, 1, 1),
                 (3, 11, 7, 40, 3, 2, 0), (1, 37, 29, 36, 3, 1, 1),
                 (1, 33, 35, 48, 3, 2, 1), (2, 7, 7, 3, 3, 1, 1),
                 (1, 23, 21, 48, 5, 1, 2), (2, 12, 9, 30, 5, 2, 2),
                 (1, 5, 5, 1024, 3, 2, 1), (1, 1, 1, 16, 1, 1, 0)]:
        n, h, w, c, k, s, p = case
        for xs, ss, iv in ((1, 1, True), (1, 2, False), (1, 4, False),
                           (2, 2, False), (4, 4, False)):
            plan = dw_plan(n, h, w, c, k, k, s, p, p, xs, ss, iv)
            _check_plan(plan, n, h, w, c, k, k, s, p, p, xs, ss,
                        (case, xs, ss, iv))
    with pytest.raises(ValueError):
        dw_plan(1, 40, 40, 16, 33, 33, 1, 0, 0, 1, 1, True)
    dw_plan(1, 40, 40, 16, 33, 33, 1, 0, 0, 1, 2, False)
    with pytest.raises(ValueError):
        dw_plan(1, 2, 2, 16, 3, 3, 1, 0, 0, 2, 2, False)


def _stitched(plan, x, kh, kw, s, ph, pw, run):
    """The plan's blocks emulated: each tile's window of the zero-padded
    ``x`` and slice of channels through ``run(window, c0, c1)`` (the plain
    version, no padding), placed into the output."""
    n, h, w, c = x.shape
    oh = (h + 2 * ph - kh) // s + 1
    ow = (w + 2 * pw - kw) // s + 1
    # room for the last tile's whole window, zeros past the image
    big = F.pad(x, (0, 0, pw, pw + plan.tw * s + kw,
                    ph, ph + plan.th * s + kh))
    out = None
    for ty in range(-(-oh // plan.th)):
        for tx in range(-(-ow // plan.tw)):
            for c0 in range(0, c, plan.cs):
                c1 = min(c, c0 + plan.cs)
                y0, x0 = ty * plan.th * s, tx * plan.tw * s
                win = big[:, y0:y0 + (plan.th - 1) * s + kh,
                          x0:x0 + (plan.tw - 1) * s + kw, c0:c1]
                got = run(win.contiguous(), c0, c1)
                if out is None:
                    out = torch.empty((n, oh, ow, c), dtype=got.dtype)
                r1 = min(oh, (ty + 1) * plan.th)
                q1 = min(ow, (tx + 1) * plan.tw)
                out[:, ty * plan.th:r1, tx * plan.tw:q1, c0:c1] = \
                    got[:, :r1 - ty * plan.th, :q1 - tx * plan.tw]
    return out


def test_dw_plan_tiling_stitches_to_the_plain_versions():
    """For each case the plan's tiling, run tile by tile through the plain
    versions, equals the plain version on the whole tensor, bit for bit:
    the int8 variant (int8 and bf16 out) and the float variant (f32, bf16
    and int8 x)."""
    rng = np.random.default_rng(11)
    for (n, h, w, c, k, s, p) in [(2, 19, 17, 40, 3, 1, 1),
                                  (1, 21, 23, 36, 3, 2, 1),
                                  (2, 9, 7, 30, 5, 2, 2),
                                  (1, 8, 10, 64, 3, 1, 0),
                                  (1, 7, 7, 3, 3, 1, 1)]:
        xq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c),
                                           dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (k, k, c),
                                           dtype=np.int8))
        wf = torch.from_numpy(rng.normal(size=(k, k, c)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=c).astype(np.float32))
        ws = torch.from_numpy(rng.uniform(1e-3, 2e-3, c).astype(np.float32))
        for odt in (torch.int8, torch.bfloat16):
            plan = dw_plan(n, h, w, c, k, k, s, p, p, 1, 1, True)
            want = depthwise_conv2d_int8_plain(xq, wq, bias, ws, s, p, p,
                                               "relu6", odt, 20.0)
            got = _stitched(plan, xq, k, k, s, p, p,
                            lambda win, c0, c1: depthwise_conv2d_int8_plain(
                                win, wq[..., c0:c1], bias[c0:c1],
                                ws[c0:c1], s, 0, 0, "relu6", odt, 20.0))
            assert torch.equal(got, want), ((n, h, w, c, k, s), odt, plan)
        xf = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
            np.float32))
        for x, extra in [(xf, {}), (xf.to(torch.bfloat16), {}),
                         (xq, {"x_scale": 0.013})]:
            staged = 4 if x.dtype == torch.float32 else 2
            plan = dw_plan(n, h, w, c, k, k, s, p, p, x.element_size(),
                           staged, False)
            want = depthwise_conv2d_plain(x, wf, bias, s, p, p, "relu",
                                          **extra)
            got = _stitched(plan, x, k, k, s, p, p,
                            lambda win, c0, c1: depthwise_conv2d_plain(
                                win, wf[..., c0:c1], bias[c0:c1], s, 0, 0,
                                "relu", **extra))
            assert torch.equal(got, want), ((n, h, w, c, k, s), x.dtype,
                                            plan)
