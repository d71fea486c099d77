"""DenseNet-121 (``reference/densenet121.py``), the first layer list of
standalone BatchNorm + Scale pairs, concats and windowed AVE pools, on the
CPU at the benchmark's small size (64x64 images, batch 4, every layer at
its published width): the program against its plain reference and the
int4 control, each pair, concat and transition pool on the program's own
inputs, the program's acceptance of the reference's parameters, and the
frozen counts against the paper's.  No cell runs it yet, so each test
writes its configuration into its copy of the benchmark."""

import json
import math

import pytest
import torch

import check
import flops
import program
from conftest import BENCH_DIR
from harness import load_module
from reference import _qnet
from test_bench_reference import cell_of

NAME = "densenet121_w8a8"
CONFIG = {
    "architecture": "densenet121",
    "source": "Huang et al. 2017, Densely Connected Convolutional Networks, "
              "arXiv:1608.06993, Table 1, DenseNet-121 (DenseNet-BC, k = 32)",
    "input_hw": [224, 224], "channels": 3, "classes": 1000,
    "stage_blocks": [6, 12, 24, 16], "growth_rate": 32, "stem_width": 64,
    "bottleneck_width": 128, "compression": 0.5,
    "graph_batch": 128,
    "engine": {"backend": "cuda", "quant": "w8a8",
               "compute_dtype": "bfloat16"},
    "calibration": {"method": "max", "batches": 3, "batch": 8},
    "act_bytes": 1, "float_bytes": 2,
    "init": {"batch": 8, "logit_std": 4.0, "beta_mean": 0.0,
             "residual_gamma": 1.0},
}


@pytest.fixture
def dense(small):
    """The configuration in the small copy, at its size; returns a cell."""
    cfg = dict(CONFIG, input_hw=[64, 64], graph_batch=4)
    (small / "configs" / f"{NAME}.json").write_text(json.dumps(cfg))
    return cell_of(small, NAME)


@pytest.mark.parametrize("transfer", [False, True], ids=["float", "int8in"])
def test_reference_agrees_with_the_program(dense, transfer):
    cell = dense
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


def test_each_pair_concat_and_pool_agrees_on_the_programs_own_inputs(dense):
    """The second witness (``witness.py``): every value the reference holds
    as a grid the program holds as int8 at the same scale, and fed the
    program's own values of what it reads, each layer lands within one
    grid step of the program's.  The pairs, concats and transition pools
    differ on at most 1e-3 of their elements (the program folds the
    pair's affine into one rounding, rescales a concat's operand by one
    multiply and averages a pool's integer sums), the float values
    (block 5's concats, ``conv5_blk``'s pair, the global pool) by at most
    1e-2 of their largest magnitude."""
    import witness
    cell = dense
    cell.engine = program.build_engine(cell.cfg, cell.params, cell.calib,
                                       "cpu")
    rows = witness.compare_layers(cell, cell.images(4, 40), 4)
    s = witness.summary(rows)
    assert s["grid_here_float_there"] == [], s
    assert s["local_max_steps"] <= 1.0, s
    assert s["scale_rel_diff_max"] < 1e-5, s
    assert s["float_layers_local_rel_max"] < 1e-2, s
    new = [r for r in rows if r["op"] in ("bn", "concat")
           or (r["op"] == "avgpool" and r["layer"] != "pool5")]
    assert len(new) == 62 + 58 + 3
    grid = [r for r in new if r["grid"]]
    assert {r["op"] for r in grid} == {"bn", "concat", "avgpool"}
    assert max(r["local_off_share"] for r in grid) < 1e-3, grid
    assert sum(r["local_off_share"] for r in rows if r["grid"]) / len(
        [r for r in rows if r["grid"]]) < 1e-3


def test_program_takes_the_references_parameters(dense):
    """``program.build_engine`` accepts the reference's parameters (it
    stops on any name or shape the zoo's graph lacks), and every layer of
    the list names a value the program's engine holds."""
    cell = dense
    assert len(cell.params) == 606
    eng = program.build_engine(cell.cfg, cell.params, cell.calib, "cpu")
    assert not {L["name"] for L in cell.layers} - set(eng.graph.specs)


def test_counts_are_the_papers():
    layers = load_module(BENCH_DIR / "reference" / "densenet121.py").layers(
        CONFIG)
    rows = flops.layer_costs(layers, CONFIG)
    assert len(rows) == 121              # 120 convs and the FC
    macs = sum(r["macs"] for r in rows)
    assert round(macs / 1e6) == 2834     # 2.834 G mult-adds
    assert flops.ops_per_image(layers, CONFIG) == 2 * macs
    # weights, gammas, betas and the FC's bias: the paper's 8.0 M; the
    # BatchNorm statistics are not learned parameters
    n = sum(math.prod(s) for _, s, k in _qnet.param_specs(layers)
            if k not in ("mean", "var"))
    assert n == 7_978_856
    assert sum(L["op"] == "bn" for L in layers) == 62
    assert sum(L["op"] == "conv" and L["bn"] is None for L in layers) == 61
    sh = flops.shapes(layers, CONFIG)
    assert sh["pool1"] == (56, 56, 64)
    assert sh["concat_2_6"] == (56, 56, 256)
    assert sh["pool2"] == (28, 28, 128)
    assert sh["concat_3_12"] == (28, 28, 512)
    assert sh["pool3"] == (14, 14, 256)
    assert sh["concat_4_24"] == (14, 14, 1024)
    assert sh["pool4"] == (7, 7, 512)
    assert sh["concat_5_16"] == (7, 7, 1024)
    assert sh["conv5_blk/scale"] == (7, 7, 1024)
