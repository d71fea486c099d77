"""ResNeXt-50 (32x4d), the configuration ``resnext50_w8a8``, on the CPU at
the benchmark's small size (64x64 images, batch 4, every layer at its
published width): the program against its plain reference
(``reference/resnext50.py``) and the int4 control, each layer on the
program's own inputs, the frozen counts against the paper's, the cell
``resnext50_w8a8.offline`` end to end and under both faults, and the
``grouped_conv_roofline`` reader."""

import math

import pytest
import torch

import check
import flops
import program
import run
from faults import answer_altered, broken_program, half_left_out
from harness import Profile, Trace
from reference import _qnet
from test_bench_flops import layers_of
from test_bench_reference import cell_of

NAME = "resnext50_w8a8"
CELL = "resnext50_w8a8.offline"
# each first block's projection shortcut and its first 1x1 read one value
SIBLINGS = {f"res{s}a_branch{b}" for s in "2345" for b in ("1", "2a")}


@pytest.mark.parametrize("transfer", [False, True], ids=["float", "int8in"])
def test_reference_agrees_with_the_program(small, transfer):
    cell = cell_of(small, NAME)
    eng = program.build_engine(cell.cfg, cell.params, cell.calib, "cpu")
    x = cell.images(16, 40)
    ref = check.reference_logits(cell, x, transfer)
    if transfer:                     # the server's int8 ingest
        s = eng.graph.meta["value_scales"]["data"]
        x = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    got = check.compare([(torch.arange(16), eng(x))], ref)
    low = check.reference_logits(cell, cell.images(16, 40), transfer, bits=4)
    ctl = check.compare([(torch.arange(16), torch.softmax(low, -1))], ref)
    assert got["top1_gap"] < 5.0 and got["prob_l1_mean"] < 1.0, got
    assert ctl["top1_gap"] > 3 * max(got["top1_gap"], 1.0), (got, ctl)
    assert ctl["prob_l1_mean"] > 2 * got["prob_l1_mean"], (got, ctl)


class OwnScales(_qnet.Quantized):
    """The reference with every value at its own calibrated scale: the
    program's scales where, as in ResNeXt-50, no sibling convs merge."""

    def __init__(self, layers, P, amax, bits=8, compute_dtype="bfloat16"):
        super().__init__(layers, P, amax, bits, compute_dtype)
        self.x_scale = {k: max(v, 1e-12) / self.qmax for k, v in amax.items()}
        self.grid = self._grid_scales()


def test_each_layer_agrees_on_the_programs_own_inputs(small, monkeypatch):
    """The second witness (``witness.py``).  The reference gives the four
    sibling pairs one scale each, as a merged conv has one; the program
    merges none of them, so only those values and their readers may part
    from it by more than a grid step.  With every value at its own scale,
    each layer fed the program's values lands within one grid step of the
    program's, on a small share of elements."""
    import witness
    cell = cell_of(small, NAME)
    readers = {L["name"] for L in cell.layers
               if set(L.get("srcs") or [L["src"]]) & SIBLINGS}
    x = cell.images(4, 40)
    cell.engine = program.build_engine(cell.cfg, cell.params, cell.calib,
                                       "cpu")
    rows = witness.compare_layers(cell, x, 4)
    apart = {r["layer"] for r in rows if r["grid"] and (
        r["local_max"] > 1.0 or (r["scale_rel_diff"] or 0.0) > 1e-5)}
    assert apart <= SIBLINGS | readers, apart - SIBLINGS - readers

    monkeypatch.setattr(_qnet, "Quantized", OwnScales)
    cell.engine = program.build_engine(cell.cfg, cell.params, cell.calib,
                                       "cpu")
    s = witness.summary(witness.compare_layers(cell, x, 4))
    assert s["grid_here_float_there"] == [], s
    assert s["local_max_steps"] <= 1.0, s
    assert s["local_off_share_mean"] < 1e-3, s
    assert s["float_layers_local_rel_max"] < 1e-2, s
    assert s["scale_rel_diff_max"] < 1e-5, s


def test_counts_are_the_papers():
    layers, cfg = layers_of(NAME)
    rows = flops.layer_costs(layers, cfg)
    assert len(rows) == 54             # 53 convs and the FC
    macs = sum(r["macs"] for r in rows)
    assert 4.1e9 <= macs <= 4.3e9      # the paper's 4.2 x 10^9
    grouped = [L for L in layers if L["op"] == "conv" and L["group"] > 1]
    assert [L["group"] for L in grouped] == [32] * 16
    # the BatchNorm statistics are not learned parameters
    n = sum(math.prod(s) for _, s, k in _qnet.param_specs(layers)
            if k not in ("mean", "var"))
    assert abs(n - 25.0e6) / 25.0e6 < 0.02
    sh = flops.shapes(layers, cfg)
    assert sh["res2a_branch2b"] == (56, 56, 128)
    assert sh["res3a_branch2a"] == (56, 56, 256)    # the stride on the 3x3
    assert sh["res3a_branch2b"] == (28, 28, 256)
    assert sh["res5c"] == (7, 7, 2048)


@pytest.mark.parametrize("fault", [None, half_left_out, answer_altered],
                         ids=lambda f: f.__name__ if f else "none")
def test_cell_end_to_end(small, bench, fault):
    r = run.run_cell(bench, CELL, 2 ** 31 + 9, 1.0, False, "cpu",
                     bench_dir=small, t_start=0.0,
                     program=broken_program(fault) if fault else None)
    assert r["correct"] is (fault is None), r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}


def test_grouped_conv_roofline(small, bench):
    """The reader: nothing where no super-group kernel ran (a traced run on
    the CPU), else the grouped convs' least time over that kernel's device
    time an image."""
    from harness import load_module
    r = run.run_cell(bench, CELL, 5, 1.0, True, "cpu", bench_dir=small,
                     t_start=0.0)
    assert "grouped_conv_roofline" not in r["metrics"]
    reader = load_module(small / "metrics" / "grouped_conv_roofline.py")
    least_us = reader.grouped_least_s_per_image() * 1e6
    layers, cfg = layers_of(NAME)
    cfg.update(input_hw=[64, 64], graph_batch=4)     # the small copy's
    assert 0 < least_us < flops.least_seconds_per_image(layers, cfg) * 1e6
    prof = Profile(0.0, 400.0, [(0.0, 50.0, "void fcnn::hgemm_kernel<4>()"),
                                (40.0, 90.0, "void fcnn::hgemm_kernel<1>()"),
                                (90.0, 300.0, "void fcnn::wgemm_kernel()")],
                   [], images=2)
    # 90 us of the kernel (the overlap counted once) for 2 images
    assert reader.read(Trace(1.0, profile=prof)) == pytest.approx(
        100.0 * least_us / 45.0)
    prof.device = prof.device[2:]
    assert reader.read(Trace(1.0, profile=prof)) is None
    assert reader.read(Trace(1.0)) is None
