"""Each plain reference against the program on the CPU at a small batch
(64x64 images, every layer at its published width), and against its own
int4 control."""

import json

import pytest
import torch

import check
import program
from harness import Cell, load_module, sub_seed
from reference import _qnet


def cell_of(small, name, seed=11):
    cfg = json.loads((small / "configs" / f"{name}.json").read_text())
    arch = load_module(small / "reference" / f"{cfg['architecture']}.py")
    layers = arch.layers(cfg)
    params = _qnet.init_weights(layers, sub_seed(seed, 1), "cpu",
                                cfg["channels"], cfg["input_hw"], cfg["init"])
    cell = Cell(name, cfg, {}, seed, 0.0, False, torch.device("cpu"), 0.0,
                layers, params, [], program)
    cell.calib = [cell.images(8, 2 + i) for i in range(3)]
    return cell


@pytest.mark.parametrize("name", ["resnet50_w8a8", "mobilenet_v1_w8a8"])
@pytest.mark.parametrize("transfer", [False, True], ids=["float", "int8in"])
def test_reference_agrees_with_the_program(small, name, transfer):
    cell = cell_of(small, name)
    eng = program.build_engine(cell.cfg, cell.params, cell.calib, "cpu")
    x = cell.images(16, 40)
    ref = check.reference_logits(cell, x, transfer)
    if transfer:                     # the server's int8 ingest
        s = eng.graph.meta["value_scales"]["data"]
        x = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    got = check.compare([(torch.arange(16), eng(x))], ref)
    low = check.reference_logits(cell, cell.images(16, 40), transfer, bits=4)
    ctl = check.compare([(torch.arange(16), torch.softmax(low, -1))], ref)
    # at this size the program reads a fraction of what int4 reads (at
    # 224x224 a smaller one: PERF.md gives the readings)
    assert got["top1_gap"] < 5.0 and got["prob_l1_mean"] < 1.0, got
    assert ctl["top1_gap"] > 3 * max(got["top1_gap"], 1.0), (got, ctl)
    assert ctl["prob_l1_mean"] > 2 * got["prob_l1_mean"], (got, ctl)


def test_weights_reproduce_from_seed(small):
    a = cell_of(small, "mobilenet_v1_w8a8", seed=5).params
    b = cell_of(small, "mobilenet_v1_w8a8", seed=5).params
    c = cell_of(small, "mobilenet_v1_w8a8", seed=6).params
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1/w"], c["conv1/w"])


def test_program_refuses_another_layer_list(small):
    cell = cell_of(small, "mobilenet_v1_w8a8")
    params = dict(cell.params)
    params.pop("fc7/b")
    with pytest.raises(SystemExit):
        program.build_engine(cell.cfg, params, cell.calib, "cpu")


@pytest.mark.parametrize("name", ["resnet50_w8a8", "mobilenet_v1_w8a8"])
def test_each_layer_agrees_on_the_programs_own_inputs(small, name):
    """The second witness (``witness.py``): fed the program's own values of
    what it reads, each layer of the reference lands within one grid step
    of the program's, on a small share of elements; only the chained
    forward drifts further."""
    import witness
    cell = cell_of(small, name)
    cell.engine = program.build_engine(cell.cfg, cell.params, cell.calib,
                                       "cpu")
    rows = witness.compare_layers(cell, cell.images(4, 40), 4)
    s = witness.summary(rows)
    assert s["local_max_steps"] <= 1.0, s
    assert s["local_off_share_mean"] < 1e-3, s
    assert s["float_layers_local_rel_max"] < 1e-2, s
    assert s["scale_rel_diff_max"] < 1e-5, s
