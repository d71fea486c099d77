"""The super-group route of the grouped int8 conv, on the CPU.

A grouped int8 kxk conv (1 < group < C: ResNeXt-50's cardinality-32 3x3
convs, the reference's XLA int8 conv with ``feature_group_count``) runs on
``conv2d_implicit_gemm`` as super-groups of q whole groups
(``kernels/matmul.py::supergroup``): a column tile of BN = q * Co/g = 32
output channels reads only its S = q * C/g = 32 input channels, against
the compact weight ``grouped_layout`` makes; a grouped conv no q fits
keeps its block-diagonal weight.  These tests hold the layout, the route's
plain version (which reads the compact weight as the kernel does, one conv
per super-group) against XLA's int32 grouped conv plus the epilogue at 0
LSB, the plan at ResNeXt-50 b128's 16 launch shapes, and a small grouped
graph through both engines.

Few test items per file: see tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import dispatch
from feathercnn_tpu_torch.kernels.conv import conv2d_implicit_gemm
from feathercnn_tpu_torch.kernels.dispatch import block_diagonal
from feathercnn_tpu_torch.kernels.matmul import (SMEM_LIMIT, epilogue_plain,
                                                 gemm_layout, gemm_pitch,
                                                 gemm_plan, grouped_layout,
                                                 halo_group, halo_images,
                                                 is_gemm_layout, supergroup)
from feathercnn_tpu_torch.models import resnext50
from feathercnn_tpu_torch.numerics import conv_hparams
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _hold_int8_edges

# (C/g, g, Co, q): ResNeXt-50's four stages, Co != C (Co/g = 16 at g = 4:
# no q on the route, its layout at q = 2) and two groups of 32
LAYOUTS = [(4, 32, 128, 8), (8, 32, 256, 4), (16, 32, 512, 2),
           (32, 32, 1024, 1), (8, 4, 64, 2), (32, 2, 64, 1)]


def _xla_grouped(x, w, stride, pad, group):
    """XLA's int32 grouped conv (the reference's int8 branch) on int8
    NHWC ``x`` and HWIO ``w``."""
    return np.array(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=group, preferred_element_type=jnp.int32))


def test_grouped_layout():
    """The compact weight at each shape's q (the route's, where supergroup
    gives one: BN = S = 32): (3, 3, S, Co) as gemm_layout stores it (rows
    16-byte pieces), each output channel's weights at its own group's slot
    of its super-group and exact zeros everywhere else; at q = g it is the
    block-diagonal weight."""
    rng = np.random.default_rng(11)
    for cgi, g, co, q in LAYOUTS:
        c, cgo = cgi * g, co // g
        case = f"C/g={cgi} g={g} Co={co} q={q}"
        assert supergroup(c, co, g)[0] == (q if cgo == cgi else 0), case
        s = q * cgi
        assert s % 16 == 0 and (cgo != cgi or q * cgo == s == 32), case
        w = rng.integers(-127, 128, (3, 3, cgi, co), dtype=np.int8)
        wc = grouped_layout(torch.from_numpy(w), g, q)
        assert wc.shape == (3, 3, s, co) and is_gemm_layout(wc), case
        assert gemm_pitch(wc) % 16 == 0 and gemm_pitch(wc) >= 9 * s, case
        # input slot i of output channel o: its own group's slot, else 0
        own = (np.arange(s)[:, None] // cgi
               == (np.arange(co)[None, :] // cgo) % q)
        dense = wc.numpy()
        assert not dense[:, :, ~own].any(), case
        for o in range(0, co, max(1, co // 16)):
            jl = (o // cgo) % q
            assert np.array_equal(dense[:, :, jl * cgi:(jl + 1) * cgi, o],
                                  w[..., o]), (case, o)
        full = grouped_layout(torch.from_numpy(w), g, g)
        assert torch.equal(full, block_diagonal(torch.from_numpy(w), g)), case


def test_supergroup_plain_equals_xla_grouped_conv():
    """The route's plain version on the compact weight (one float64 conv
    per super-group of x's channels) against XLA's int32 grouped conv and
    the epilogue, 0 LSB with int8 and bf16 outputs: stride 1 and 2, odd H
    and W, M = 2 * OH * OW not a multiple of 128; where no q fits (Co !=
    C), the block-diagonal weight's."""
    rng = np.random.default_rng(12)
    for (cgi, g, co, _), stride, (h, w_) in zip(
            LAYOUTS, (1, 2, 1, 2, 1, 2),
            ((9, 7), (11, 9), (7, 9), (5, 7), (13, 11), (9, 15))):
        c = cgi * g
        q = supergroup(c, co, g)[0] or g
        case = f"C/g={cgi} g={g} Co={co} s{stride} {h}x{w_}"
        x = rng.integers(-127, 128, (2, h, w_, c), dtype=np.int8)
        wg = rng.integers(-127, 128, (3, 3, cgi, co), dtype=np.int8)
        acc = torch.from_numpy(_xla_grouped(x, wg, stride, 1, g)).float()
        assert acc.shape[0] * acc.shape[1] * acc.shape[2] % 128, case
        ws = torch.from_numpy(rng.uniform(1e-4, 3e-4, co).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=co).astype(np.float32))
        wc = grouped_layout(torch.from_numpy(wg), g, q)
        for out_dtype in (torch.int8, torch.bfloat16):
            kw = dict(activation="relu", out_dtype=out_dtype, x_scale=1.0,
                      out_scale=0.5)
            got = conv2d_implicit_gemm(torch.from_numpy(x), wc, bias, ws,
                                       stride=stride, pad_h=1, pad_w=1,
                                       groups=g, **kw)
            want = epilogue_plain(acc, ws, 1.0, bias, "relu", None, None,
                                  out_dtype, 0.5)
            assert torch.equal(got, want), (case, out_dtype)


def test_plan_at_resnext50_launches():
    """ResNeXt-50 b128's 16 grouped 3x3 convs (C = Co = 128 to 1024,
    stride 2 in the first block of stages 3-5): q = 32 / (C/32), each on
    "wgmma_halo" with BN 32 and K 288 (its panel in 128-byte tiles), a
    tile of at most 128 rows (two whole maps at 7 x 7), smem within the
    limit and a grid that is a multiple of the C/S column tiles' groups
    (four at stride 1, one halo's 128 channels; one at stride 2).  A shape
    with no q (C/g = 32 over Co/g = 512; a 1x1; a 5x5) keeps its
    block-diagonal weight and plan, the reason named."""
    g = resnext50(batch=128)
    grouped = [n for n in g.nodes if n.attrs.get("group", 1) > 1]
    assert len(grouped) == 16
    shapes = set()
    for n in grouped:
        kh, kw, sh, sw, ph, pw, dil, group = conv_hparams(n)
        nb, _, _, c = g.specs[n.inputs[0]].shape
        _, oh, ow, co = g.specs[n.outputs[0]].shape
        q, why = supergroup(c, co, group, (kh, kw))
        case = f"{n.name} C={c} Co={co} s{sh}"
        assert group == 32 and (kh, kw) == (3, 3) and q == 32 * 32 // c, case
        s = q * c // group
        p = gemm_plan(nb * oh * ow, 9 * s, co, torch.int8, torch.int8,
                      torch.int8, conv_c=c, group=group, conv_s=s,
                      kernel=(3, 3), conv_out=(nb, oh, ow), stride=sh)
        assert (p.variant, p.bn, p.bk, p.reason) == (
            "wgmma_halo", 32, 128, ""), (case, p)
        # the tile: at most 128 rows, the halo within TMA's box
        ti = halo_images(p.th, p.tw, oh, ow)
        assert ti * p.th * p.tw <= 128 and (ti == 1 or oh == 7), (case, p)
        assert (p.th - 1) * sh + 3 <= 256 and (p.tw - 1) * sh + 3 <= 256
        assert 9 * s == 288 and p.split == 1 and p.stages >= 3, (case, p)
        # at stride 1 a halo holds four column tiles' 32 channels (rows
        # of 128 bytes), at stride 2 one's
        g4 = halo_group(c // s, sh, 1)
        assert g4 == (4 if sh == 1 else 1), case
        assert p.smem <= SMEM_LIMIT and p.grid % (c // s // g4) == 0, \
            (case, p)
        assert p.grid <= 132, (case, p)
        shapes.add((c, sh))
    assert sorted(shapes) == [(128, 1), (256, 1), (256, 2), (512, 1),
                              (512, 2), (1024, 1), (1024, 2)]
    # no q: Co/g = 512 != C/g, a grouped 1x1 conv (a B1 matrix), a 5x5
    q, why = supergroup(64, 1024, 2)
    assert q == 0 and "Co/g = 512" in why
    assert supergroup(128, 128, 32, (1, 1)) == (
        0, "a grouped 1x1 conv is a B1 matrix")
    assert supergroup(128, 128, 32, (5, 5))[0] == 0
    p = gemm_plan(2 * 81, 9 * 64, 1024, torch.int8, torch.int8, torch.int8,
                  conv_c=64, group=2, conv_s=64, kernel=(3, 3))
    assert p.variant == "wgmma" and p.reason == f"block-diagonal: {why}"
    assert p == gemm_plan(2 * 81, 9 * 64, 1024, torch.int8, torch.int8,
                          torch.int8, conv_c=64)._replace(reason=p.reason)


def _grouped_graph(group, num_output):
    """A float stem to 64 channels, an int8 1x1 conv, the grouped 3x3 conv
    at stride 1 and at stride 2, each read by an int8 1x1 conv."""
    b = JBuilder(f"grouped{group}", seed=group)
    x = b.input("data", (2, 11, 9, 3))
    x = b.conv("stem", x, 64, 3, pad=1, relu=True)
    x = b.conv("c", x, 64, 1, relu=True)
    outs = []
    for stride in (1, 2):
        y = b.conv(f"g{stride}", x, num_output, 3, stride=stride, pad=1,
                   group=group, relu=True)
        outs.append(b.conv(f"g{stride}_head", y, 16, 1))
    return b.finish(outs)


def test_grouped_graph_both_engines():
    """A small grouped graph through the reference (Pallas interpret) and the
    port: every int8 edge equal (0 LSB) node by node and end to end; each
    grouped conv runs on the super-group route with its compact weight,
    kept once per node (the same tensor on every forward), or, at 12
    outputs a group (no q), on its block-diagonal weight."""
    rng = np.random.default_rng(13)
    for group, num_output in ((16, 64), (2, 64), (4, 48)):
        g = _grouped_graph(group, num_output)
        jcalibrate(g, [rng.normal(size=(2, 11, 9, 3)).astype(np.float32)],
                   method="max")
        x = rng.normal(size=(2, 11, 9, 3)).astype(np.float32)
        kw = dict(quant="w8a8", compute_dtype="bfloat16")
        jeng = JEngine(g, JConfig(backend="pallas", interpret=True, **kw))
        teng = Engine(graph_from_reference(g),
                      EngineConfig(backend="cuda", **kw), device="cpu")
        seen = []
        orig = dispatch.conv2d_implicit_gemm

        def spy(xq, w, *a, **k):
            seen.append((k.get("groups", 1), w))
            return orig(xq, w, *a, **k)

        dispatch.conv2d_implicit_gemm = spy
        try:
            n_int8, _, ref, _ = _hold_int8_edges(f"grouped g={group}", jeng,
                                                  teng, x)
        finally:
            dispatch.conv2d_implicit_gemm = orig
        case = f"g={group} Co={num_output}"
        assert n_int8 >= 4, case
        q = supergroup(64, num_output, group)[0]
        params = teng.graph.params
        for stride in (1, 2):
            node = teng.graph.node_map()[f"g{stride}"]
            assert ref[node.inputs[0]].dtype == np.int8, case
            assert ref[node.outputs[0]].dtype == np.int8, case
            w = torch.from_numpy(params[node.params[0]])
            want = (grouped_layout(w, group, q) if q
                    else gemm_layout(block_diagonal(w, group)))
            mine = [t for gr, t in seen if gr == group
                    and t.shape == want.shape and torch.equal(t, want)]
            # node by node and end to end: one kept tensor per node
            assert len(mine) >= 2 and all(t is mine[0] for t in mine), case
        assert q == {16: 8, 2: 1, 4: 0}[group], (case, q)


def test_route_refuses_what_it_does_not_take():
    """The route raises where it does not apply, and nothing falls back:
    a weight whose width is no super-group's, a dilated or float grouped
    conv, a plan asked for a block-diagonal weight where a q fits, and a
    super-group launch whose x or w is not 16-byte aligned."""
    x = torch.zeros(1, 5, 5, 64, dtype=torch.int8)
    wc = grouped_layout(torch.zeros(3, 3, 2, 64, dtype=torch.int8), 32, 16)
    conv2d_implicit_gemm(x, wc, stride=1, pad_h=1, pad_w=1, groups=32)
    for bad in (dict(w=torch.zeros(3, 3, 24, 64, dtype=torch.int8)),
                dict(dilation=2), dict(x=x.float(), w=wc.float())):
        a = dict(x=x, w=wc, stride=1, pad_h=1, pad_w=1, groups=32)
        a.update(bad)
        try:
            conv2d_implicit_gemm(**a)
        except ValueError:
            continue
        raise AssertionError(f"{sorted(bad)} did not raise")
    # (C = 128, g = 32: q = 8; a block-diagonal weight is 128 wide)
    for conv_s in (128, 64):
        try:
            gemm_plan(81, 9 * conv_s, 128, torch.int8, torch.int8,
                      torch.int8, conv_c=128, group=32, conv_s=conv_s,
                      kernel=(3, 3), conv_out=(1, 9, 9))
        except ValueError:
            continue
        raise AssertionError(f"conv_s={conv_s} did not raise")
    # the halo kernel's TMA maps need 16-byte aligned x and w
    for ptrs in (dict(x_ptr=8), dict(w_ptr=4)):
        try:
            gemm_plan(81, 9 * 32, 128, torch.int8, torch.int8, torch.int8,
                      conv_c=128, group=32, conv_s=32, kernel=(3, 3),
                      conv_out=(1, 9, 9), **ptrs)
        except ValueError:
            continue
        raise AssertionError(f"{ptrs} did not raise")
