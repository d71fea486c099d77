"""The GEMM kernels' split-K plans on the CPU: the bf16 x bf16 variant
("wgmma_bf16") and the int8 "wgmma" plan that splits K where its tiles
leave SMs idle.

- ``gemm_plan`` gives ResNet-50's bf16 FC (128, 2048, 1000), on both bf16
  routes (unchained and ``fuse_chains``), "wgmma_bf16" with ``w8_split``'s
  slices, found by a forward whose two GEMM entry points record their
  arguments (M scales with the batch).
- From R-FCN ResNet-101's graph at batch 1 and 600x800 (shapes only), its
  three stage-5 dilated convs plan a split; every int8 conv launch of
  ResNet-50 b128 keeps one slice and the plan it had before the split.
- The split order's plain version (``matmul_epilogue_split_plain``) of a
  bf16 x bf16 product against the Pallas kernel in interpret mode and
  against the unsplit plain version.
- A small R-FCN-like dilated int8 conv (stage 5 at batch 1, narrowed)
  equal to the JAX engine's, whose dispatcher leaves it to XLA's int8
  conv; its plan splits K, ``GemmPlan.args()`` carries the split, and the
  wrapper's workspace is split x M x N int32.

Tolerances.  int8 edges equal (0 LSB).  Float sums in another order: the
float gate of ``chip_smoke.py`` (every bf16 output within 2 ulp of the
other or within 1e-2 of the largest |value|, at most 0.1% of them more
than 1 ulp apart).  Few test items (see tests/test_torch_kernels.py for
why); two torch intra-op threads while the module runs (``_two_threads``,
as tests/test_torch_zoo_rest.py says why).
"""

import jax.numpy as jnp
import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.kernels.matmul import matmul_epilogue as jmm
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.matmul import (
    BF16_MIN_STEPS, _wgmma_plan, gemm_plan, is_gemm_layout,
    matmul_epilogue_plain, matmul_epilogue_split_plain, split_workspace,
    w8_split)
from feathercnn_tpu_torch.models import resnet50, rfcn_resnet101
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _hold_int8_edges
from test_torch_gemm_plan import _launch_shapes
from test_torch_w8_gemm import _float_gate
from test_torch_zoo_rest import _two_threads  # noqa: F401

BF, I8 = torch.bfloat16, torch.int8


def _bf16_launches(monkeypatch, fuse_chains):
    """Every GEMM launch of ResNet-50's bf16 forward (built at b128, as the
    chip run builds it, and run on one image) as (M at 128, K, N, x dtype,
    w dtype, out dtype)."""
    g = resnet50(batch=128)
    if fuse_chains:
        g.meta["chain_regions"] = {"*": True}
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16", quant=None,
                       fuse_chains=fuse_chains)
    seen = []

    def fake_mm(x, w, bias=None, w_scale=None, activation=None,
                out_dtype=None, **kw):
        assert is_gemm_layout(w)
        odt = out_dtype or x.dtype
        seen.append((x.shape[0] * 128, x.shape[1], w.shape[1], x.dtype,
                     w.dtype, odt))
        return torch.zeros(x.shape[0], w.shape[1], dtype=odt)

    def fake_conv(x, w, *a, **kw):
        raise AssertionError("a bf16 conv reached conv2d_implicit_gemm")

    monkeypatch.setattr(dispatch, "matmul_epilogue", fake_mm)
    monkeypatch.setattr(dispatch, "conv2d_implicit_gemm", fake_conv)
    x = np.random.default_rng(0).normal(size=(1, 224, 224, 3)).astype(
        np.float32)
    Engine(g, cfg, device="cpu")(x)
    monkeypatch.undo()
    return seen


def test_bf16_fc_plans_wgmma_bf16_on_both_routes(monkeypatch):
    """ResNet-50 b128 in bf16, unchained and with ``fuse_chains``: one
    GEMM launch, the FC (128, 2048, 1000), bf16 x bf16, planned
    "wgmma_bf16" on 128 x 64 tiles (16 for 132 SMs) with ``w8_split``'s 4
    slices of 8 K steps (slices at least ``BF16_MIN_STEPS`` long) and 6
    stages, within a block's shared memory."""
    for fuse in (False, True):
        launches = _bf16_launches(monkeypatch, fuse)
        assert [s[:3] for s in launches] == [(128, 2048, 1000)], launches
        for (m, k, n, xdt, wdt, odt) in launches:
            assert xdt == wdt == BF, (fuse, xdt, wdt)
            p = gemm_plan(m, k, n, xdt, wdt, odt)
            assert p.variant == "wgmma_bf16", p
            assert p.split == w8_split(m, k, p.bn, n, 132,
                                       BF16_MIN_STEPS) == 4, p
            assert (p.bn, p.bk, p.stages, p.grid) == (64, 128, 6, 64), p
            assert p.smem <= 227 * 1024 and not p.bres, p


def test_split_rule_reaches_rfcn_stage5_not_resnet50_convs(monkeypatch):
    """R-FCN ResNet-101 b1 at 600x800: its three stage-5 convs at
    dilation 2 (38x50 maps, 3x3, 512 -> 512: M = 1,900, K = 4,608,
    N = 512) leave 30 of 132 SMs busy unsplit; the rule splits them 4
    ways (9 of 36 K steps each, 120 blocks, no resident panel).  Every
    int8 conv launch of ResNet-50 b128, and a ragged conv, keeps split 1
    and the plan it had before the rule (``_wgmma_plan`` with ``split=False``)."""
    g = rfcn_resnet101(batch=1)
    dilated = [n for n in g.nodes
               if n.op == "Convolution" and n.attrs.get("dilation", 1) > 1]
    assert len(dilated) == 3, [n.name for n in dilated]
    for node in dilated:
        nb, h, w, c = g.specs[node.inputs[0]].shape
        _, oh, ow, co = g.specs[node.outputs[0]].shape
        kh = node.attrs["kernel_h"]
        assert (nb, oh, ow, c, co, kh) == (1, 38, 50, 512, 512, 3), node.name
        p = gemm_plan(oh * ow, kh * kh * c, co, I8, I8, I8, conv_c=c)
        assert p.variant == "wgmma" and p.split == 4, (node.name, p)
        assert (p.bn, p.grid, p.bres) == (256, 120, False), (node.name, p)
        unsplit = _wgmma_plan("wgmma", oh * ow, kh * kh * c, co, 1, True,
                              132, kh * kh * c, split=False)
        assert unsplit.grid == 30 and unsplit._replace(
            split=4, grid=120) == p, (p, unsplit)
    # the rule leaves "wgmma_ragged" whole (a ragged conv at C = 40 whose
    # 4 tiles and 16 K steps would split on "wgmma")
    p = gemm_plan(400, 49 * 40, 200, I8, I8, I8, conv_c=40)
    assert p.variant == "wgmma_ragged" and p.split == 1, p
    convs = [s for s in _launch_shapes(monkeypatch, resnet50, 128, False)
             if s[0] == "conv2d_implicit_gemm"]
    assert len(convs) == 16, len(convs)
    for (_, m, k, n, c, xdt, wdt, odt) in convs:
        p = gemm_plan(m, k, n, xdt, wdt, odt, conv_c=c)
        osize = torch.empty((), dtype=odt).element_size()
        assert p.split == 1 and p == _wgmma_plan(
            "wgmma", m, k, n, osize, True, 132, k, split=False), (m, k, n, p)


def test_bf16_split_order_plain_within_the_float_gate():
    """bf16 x bf16: ``matmul_epilogue_split_plain`` at the FC's plan (4
    slices), at 8, and at 2 and 3 slices of a ragged shape, against the Pallas
    ``matmul_epilogue`` in interpret mode (f32 sums per K block) and
    against the unsplit plain version, every one within the float gate;
    one slice is the unsplit plain version bit for bit."""
    rng = np.random.default_rng(11)
    for (m, k, n, splits) in [(128, 2048, 1000, (4, 8)),
                              (40, 520, 72, (2, 3))]:
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
        b = rng.normal(size=n).astype(np.float32)
        xb = torch.from_numpy(x).to(BF)
        wb = torch.from_numpy(w).to(BF)
        want = jmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   jnp.asarray(b), activation="relu", out_dtype=jnp.bfloat16,
                   interpret=True)
        ref = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
        plain = matmul_epilogue_plain(xb, wb, torch.from_numpy(b), None,
                                      "relu", BF)
        for split in splits:
            got = matmul_epilogue_split_plain(xb, wb, split,
                                              torch.from_numpy(b), None,
                                              "relu", BF)
            case = f"split {split} at {(m, k, n)}"
            _float_gate(got, ref.to(BF), case + " vs Pallas")
            _float_gate(got, plain, case + " vs unsplit plain")
        assert torch.equal(matmul_epilogue_split_plain(
            xb, wb, 1, torch.from_numpy(b), None, "relu", BF), plain)
    assert gemm_plan(128, 2048, 1000, BF, BF, BF).split == 4


def _rfcn_like_graph():
    """A float stem to 128 channels at 19x25 (R-FCN's stage-5 map, halved),
    a 3x3 int8 conv at dilation 2 and pad 2 to 256 (stage 5's, narrowed),
    read by an int8 1x1 conv, so that the dilated conv takes and emits
    int8 edges."""
    b = JBuilder("rfcn_like", seed=14)
    x = b.input("data", (1, 19, 25, 3))
    x = b.conv("stem", x, 128, 3, pad=1, relu=True)
    y = b.conv("res5a_branch2b", x, 256, 3, pad=2, dilation=2, relu=True)
    return b.finish([b.conv("head", y, 16, 1)])


def test_dilated_int8_conv_splits_and_matches_reference():
    """The R-FCN-like dilated conv on the CPU (the wrapper's plain
    version) equals the JAX engine's, edge by edge at 0 LSB; it went
    through ``conv2d_implicit_gemm`` at dilation 2.  Its plan at batch 1
    (M = 475, K = 1,152, N = 256: 4 tiles of 128 x 256, 9 K steps of 128
    bytes, 432 KB a block) splits K 2 ways; ``GemmPlan.args()`` hands the
    split to the C entry point, and the wrapper's workspace for that plan
    is 2 x 475 x 256 int32."""
    rng = np.random.default_rng(5)
    g = _rfcn_like_graph()
    jcalibrate(g, [rng.normal(size=(1, 19, 25, 3)).astype(np.float32)],
               method="max")
    x = rng.normal(size=(1, 19, 25, 3)).astype(np.float32)
    kw = dict(quant="w8a8", compute_dtype="bfloat16")
    jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
    teng = Engine(graph_from_reference(g), EngineConfig(backend="cuda", **kw),
                  device="cpu")
    seen = []
    orig = dispatch.conv2d_implicit_gemm

    def spy(x, w, *a, **k):
        seen.append((tuple(x.shape), x.dtype, k.get("dilation", 1)))
        return orig(x, w, *a, **k)

    dispatch.conv2d_implicit_gemm = spy
    try:
        n_int8, _, ref, _ = _hold_int8_edges("rfcn-like dilated", jeng, teng,
                                              x)
    finally:
        dispatch.conv2d_implicit_gemm = orig
    node = next(n for n in teng.graph.nodes if n.name == "res5a_branch2b")
    assert ref[node.inputs[0]].dtype == np.int8
    assert ref[node.outputs[0]].dtype == np.int8
    assert ((1, 19, 25, 128), I8, 2) in seen, seen
    p = gemm_plan(19 * 25, 9 * 128, 256, I8, I8, I8, conv_c=128)
    assert p.variant == "wgmma" and p.split == 2 and p.args()[7] == 2, p
    ws = split_workspace(p, 19 * 25, 256, I8, "cpu")
    assert ws.dtype == torch.int32 and tuple(ws.shape) == (2, 475, 256)
    assert ws.numel() == p.split * 475 * 256
    assert split_workspace(p._replace(split=1), 475, 256, I8, "cpu") is None
