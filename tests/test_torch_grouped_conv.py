"""The grouped int8 conv's route and the GEMM plan at the launch shapes of
the rest of the classification zoo, on the CPU.

A grouped conv with 1 < group < C (ResNeXt-50's cardinality-32 3x3 convs)
runs on the implicit-GEMM kernel as super-groups of q whole groups, its
weight compacted by ``kernels/matmul.py::grouped_layout``
(tests/test_torch_grouped_gemm.py holds that route); where no q fits it
keeps its block-diagonal dense weight (``kernels/dispatch.py::
block_diagonal``, laid out by ``gemm_layout``): the zeros add nothing to
the int32 sums, so the kernel's plain version on either weight must equal
``F.conv2d(groups=g)`` in float64 on the same int8 grids, and the
reference's XLA int8 conv (``feature_group_count``), bit for bit (0 LSB).

``gemm_plan`` is held at every GEMM launch of the six paths the chip run
drives (DenseNet-121, ResNeXt-50, SE-ResNet-50, Inception-v3, ShuffleNet
v1/v2 at their chip batches), found as tests/test_torch_gemm_plan.py finds
them: among them DenseNet's growth convs at N = 32, Inception-v3's 1x7,
7x1, 1x3 and 3x1 convs, and ResNeXt-50's super-group ones.

Few test items per file: see tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
from feathercnn_tpu_torch.kernels.dispatch import block_diagonal
from feathercnn_tpu_torch.kernels.matmul import (SMEM_LIMIT, epilogue_plain,
                                                 gemm_layout, gemm_plan,
                                                 grouped_layout, halo_group,
                                                 is_gemm_layout, supergroup)
from feathercnn_tpu_torch.models import (densenet121, inception_v3,
                                         resnext50, se_resnet50,
                                         shufflenet_v1, shufflenet_v2)
from feathercnn_tpu_torch.models.builder import GraphBuilder
from feathercnn_tpu_torch.quant import calibrate
from test_torch_zoo_rest import _two_threads  # noqa: F401


def test_block_diagonal_equals_grouped_conv():
    """Grouped int8 convs at 4, 8 and 32 channels a group, stride 1 and 2,
    odd H and W: the block-diagonal weight through the implicit-GEMM
    kernel's plain version equals ``F.conv2d(groups=g)`` in float64 plus
    the same epilogue, and the raw sums equal XLA's int32 grouped conv."""
    rng = np.random.default_rng(6)
    for cg, g, co, stride, (h, w) in [(4, 32, 128, 1, (9, 7)),
                                      (4, 32, 128, 2, (11, 9)),
                                      (8, 16, 256, 1, (7, 9)),
                                      (8, 4, 64, 2, (13, 11)),
                                      (32, 32, 1024, 1, (5, 3)),
                                      (32, 2, 64, 2, (9, 15))]:
        case = f"Cg={cg} g={g} Co={co} s{stride} {h}x{w}"
        x = rng.integers(-127, 128, (2, h, w, cg * g), dtype=np.int8)
        wg = rng.integers(-127, 128, (3, 3, cg, co), dtype=np.int8)
        dense = block_diagonal(torch.from_numpy(wg), g)
        assert dense.shape == (3, 3, cg * g, co), case
        # zero wherever the input channel's group is not the output's
        gi = np.arange(cg * g) // cg
        go = np.arange(co) // (co // g)
        off = gi[:, None] != go[None, :]
        assert not dense.numpy()[:, :, off].any(), case
        acc = F.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                       torch.from_numpy(wg).double().permute(3, 2, 0, 1),
                       stride=stride, padding=1, groups=g)
        acc = acc.permute(0, 2, 3, 1)
        want_acc = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(wg), (stride, stride),
            ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=g, preferred_element_type=jnp.int32)
        assert np.array_equal(acc.numpy(), np.asarray(want_acc)), case
        ws = torch.from_numpy(rng.uniform(1e-4, 3e-4, co).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=co).astype(np.float32))
        for out_dtype in (torch.int8, torch.bfloat16):
            kw = dict(activation="relu", out_dtype=out_dtype, x_scale=1.0,
                      out_scale=0.5)
            got = conv2d_implicit_gemm(torch.from_numpy(x),
                                       gemm_layout(dense), bias, ws,
                                       stride=stride, pad_h=1, pad_w=1, **kw)
            want = epilogue_plain(acc.float(), ws, 1.0, bias, "relu", None,
                                  None, out_dtype, 0.5)
            assert torch.equal(got, want), (case, out_dtype)


def _grouped_graph(group, dilation=1, num_output=64, stride=1):
    b = GraphBuilder("grouped", seed=3)
    x = b.input("data", (1, 9, 9, 64))
    x = b.conv("c", x, 64, 1, relu=True)
    x = b.conv("g", x, num_output, 3, stride=stride, pad=dilation,
               group=group, dilation=dilation, relu=True)
    return b.finish([b.pool("p", x, 0, mode="AVE", global_pooling=True)])


def test_grouped_int8_conv_routes():
    """Through the engine (w8a8, ``int8_grouped`` on): a grouped conv with
    1 < group < C runs on the implicit-GEMM kernel with its super-group
    weight (8 groups of 8 channels: q = 4, S = 32), laid out once.  A dilated grouped conv takes float inputs and
    PyTorch's float conv, as the reference's rewrite and dispatcher send it
    to XLA's float conv; a dilated ungrouped int8 conv runs on the
    implicit-GEMM kernel with its dilation, and a grouped conv with group
    == C and two outputs per channel (not plain depthwise) runs on the
    implicit-GEMM kernel with its block-diagonal weight, as the reference
    runs it through XLA's grouped int8 conv."""
    x = np.random.default_rng(1).normal(size=(1, 9, 9, 64)).astype(
        np.float32)
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16",
                       quant="w8a8")
    g = _grouped_graph(8)
    calibrate(g, [x], method="max", device="cpu")
    eng = Engine(g, cfg, device="cpu")
    seen = []
    orig = dispatch.conv2d_implicit_gemm

    def record(xq, w, *a, **kw):
        seen.append((w, kw["groups"]))
        return orig(xq, w, *a, **kw)

    dispatch.conv2d_implicit_gemm = record
    try:
        eng(x)
        eng(x)
    finally:
        dispatch.conv2d_implicit_gemm = orig
    assert len(seen) == 2 and seen[0][0] is seen[1][0] and seen[0][1] == 8
    w = eng.graph.params[eng.graph.node_map()["g"].params[0]]
    assert seen[0][0].dtype == torch.int8 and is_gemm_layout(seen[0][0])
    assert supergroup(64, 64, 8) == (4, "")
    assert torch.equal(seen[0][0], grouped_layout(torch.from_numpy(w), 8, 4))
    ref = Engine(g, cfg.replace(int8_grouped=False), device="cpu")
    assert ref(x).shape == eng(x).shape
    g = _grouped_graph(8, dilation=2)
    calibrate(g, [x], method="max", device="cpu")
    eng = Engine(g, cfg, device="cpu")
    assert "x_scale" in eng.graph.meta["quant"]["g"]
    assert "emit_int8" not in eng.graph.meta["quant"]["c"]
    assert torch.isfinite(eng(x).float()).all()
    g = _grouped_graph(1, dilation=2)
    calibrate(g, [x], method="max", device="cpu")
    seen = []
    dispatch.conv2d_implicit_gemm = lambda *a, **kw: seen.append(
        kw["dilation"]) or orig(*a, **kw)
    try:
        assert torch.isfinite(Engine(g, cfg, device="cpu")(x).float()).all()
    finally:
        dispatch.conv2d_implicit_gemm = orig
    assert seen == [2]
    graph = _grouped_graph(64, num_output=128)
    calibrate(graph, [x], method="max", device="cpu")
    seen = []
    dispatch.conv2d_implicit_gemm = record
    try:
        out = Engine(graph, cfg, device="cpu")(x)
    finally:
        dispatch.conv2d_implicit_gemm = orig
    assert torch.isfinite(out.float()).all()
    assert len(seen) == 1 and seen[0][1] == 64
    assert supergroup(64, 128, 64)[0] == 0          # C/g = 1, Co/g = 2
    assert tuple(seen[0][0].shape) == (3, 3, 64, 128)


def _launch_shapes(monkeypatch, build, batch):
    """Every GEMM launch of the model's w8a8 forward as (kernel, M at
    ``batch``, K, N, conv C or None, KH, KW, x dtype, w dtype, out dtype,
    groups, the conv's (images, OH, OW) at ``batch`` or None, stride),
    from a batch-1 forward on the CPU whose two kernel entry points record
    their arguments and return zeros of the output's shape."""
    g = build(batch=batch)
    shape = (1,) + tuple(g.inputs["data"].shape[1:])
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    calibrate(g, [x], method="max", device="cpu")
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16",
                       quant="w8a8")
    seen = []

    def fake_mm(x, w, bias=None, w_scale=None, activation=None,
                out_dtype=None, **kw):
        assert is_gemm_layout(w)
        seen.append(("matmul_epilogue", x.shape[0] * batch, x.shape[1],
                     w.shape[1], None, 1, 1, x.dtype, w.dtype, out_dtype, 1,
                     None, 1))
        return torch.zeros(x.shape[0], w.shape[1], dtype=out_dtype)

    def fake_conv(x, w, bias=None, w_scale=None, stride=1, pad_h=0, pad_w=0,
                  activation=None, out_dtype=None, groups=1, **kw):
        assert is_gemm_layout(w)
        kh, kw_, s, co = w.shape
        oh = (x.shape[1] + 2 * pad_h - kh) // stride + 1
        ow = (x.shape[2] + 2 * pad_w - kw_) // stride + 1
        seen.append(("conv2d_implicit_gemm", oh * ow * batch, kh * kw_ * s,
                     co, x.shape[3], kh, kw_, x.dtype, w.dtype, out_dtype,
                     groups, (batch, oh, ow), stride))
        return torch.zeros(x.shape[0], oh, ow, co, dtype=out_dtype)

    monkeypatch.setattr(dispatch, "matmul_epilogue", fake_mm)
    monkeypatch.setattr(dispatch, "conv2d_implicit_gemm", fake_conv)
    Engine(g, cfg, device="cpu")(x)
    monkeypatch.undo()
    return seen


def test_plan_at_the_new_paths_launch_shapes(monkeypatch):
    """Every GEMM launch of the six paths as the chip run drives them:
    (B1, B2) launches per forward DenseNet-121 b128 (62, 58), ResNeXt-50
    b128 (37, 16), SE-ResNet-50 b96 (69, 16), Inception-v3 b128 (38, 53,
    34 of them asymmetric), ShuffleNet v1 b128 (2, 0), v2 b128 (37, 0);
    every one int8 x int8 and
    planned "wgmma" with at most 227 KB of shared memory, >= 2 stages and
    a tile width that is a multiple of 8 and at most 256, but the
    ShuffleNets' launches whose K is not a multiple of 16 (a row pitch
    that is not whole 16-byte pieces: "wgmma_ragged" with that reason): v1's
    first 1x1 conv (K = 24) and 35 of v2's 37 (K = 24, 58, 116, 232).
    Among them N = 32 (DenseNet's growth convs), every KH x KW of
    Inception-v3 and ResNeXt-50's 16 grouped convs as super-groups on
    "wgmma_halo" (BN 32, K = 288)."""
    want = {densenet121: (128, 62, 58), resnext50: (128, 37, 16),
            se_resnet50: (96, 69, 16), inception_v3: (128, 38, 53),
            shufflenet_v1: (128, 2, 0), shufflenet_v2: (128, 37, 0)}
    kernels, fallbacks, supers = set(), {}, set()
    for build, (batch, n_mm, n_conv) in want.items():
        shapes = _launch_shapes(monkeypatch, build, batch)
        counts = (sum(s[0] == "matmul_epilogue" for s in shapes),
                  sum(s[0] == "conv2d_implicit_gemm" for s in shapes))
        assert counts == (n_mm, n_conv), (build.__name__, counts)
        for (kernel, m, k, n, c, kh, kw, xdt, wdt, odt, grp, out,
             stride) in shapes:
            case = f"{build.__name__} b{batch} {kernel} M={m} K={k} N={n}"
            assert xdt == torch.int8 and wdt == torch.int8, case
            p = gemm_plan(m, k, n, xdt, wdt, odt, conv_c=c, group=grp,
                          conv_s=k // (kh * kw), kernel=(kh, kw),
                          conv_out=out, stride=stride)
            if grp > 1:
                assert build is resnext50 and grp == 32, case
                assert (k, p.bn, p.variant) == (288, 32, "wgmma_halo"), \
                    (case, p)
                supers.add(c)
            if k % 16:
                # ShuffleNet v1's first 1x1 conv (the stem's 24 channels) and
                # v2's 1x1 convs (K = 24, 58, 116, 232)
                assert build in (shufflenet_v1, shufflenet_v2), case
                fallbacks[build.__name__] = fallbacks.get(build.__name__,
                                                          0) + 1
                assert p.variant == "wgmma_ragged", (case, p)
                assert "not a multiple of 16" in p.reason, (case, p)
                assert p.sst >= 2 and p.ldw % 16 == 0, (case, p)
            elif grp == 1:
                assert p.variant == "wgmma" and not p.reason, (case, p)
            assert p.smem <= SMEM_LIMIT and p.stages >= 2, (case, p)
            assert p.bn % 8 == 0 and 32 <= p.bn <= 256, (case, p)
            # a block keeps its column tile (a super-group launch: its
            # group of the tiles one halo holds)
            cols = -(-n // p.bn)
            if grp > 1:
                cols //= halo_group(cols, stride, 1)
            assert 1 <= p.grid <= 132 and p.grid % cols == 0, (case, p)
            if kernel == "conv2d_implicit_gemm":
                kernels.add((build.__name__, kh, kw, n == 32))
    assert fallbacks == {"shufflenet_v1": 1, "shufflenet_v2": 35}, fallbacks
    assert ("densenet121", 3, 3, True) in kernels
    assert supers == {128, 256, 512, 1024}
    assert {(kh, kw) for name, kh, kw, _ in kernels
            if name == "inception_v3"} >= {(1, 7), (7, 1), (1, 3), (3, 1),
                                           (3, 3), (5, 5)}
