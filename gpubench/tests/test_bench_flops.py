"""The frozen counts against the published ones."""

import json

import pytest

import flops
from conftest import BENCH_DIR
from harness import load_module


def layers_of(name):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    arch = load_module(BENCH_DIR / "reference" / f"{cfg['architecture']}.py")
    return arch.layers(cfg), cfg


@pytest.mark.parametrize("name, lo, hi", [
    ("resnet50_w8a8", 3.8e9, 3.9e9),        # the paper's 3.8 x 10^9
    ("mobilenet_v1_w8a8", 0.56e9, 0.58e9),  # the paper's 569M
])
def test_mult_adds_per_image(name, lo, hi):
    layers, cfg = layers_of(name)
    macs = sum(r["macs"] for r in flops.layer_costs(layers, cfg))
    assert lo <= macs <= hi
    assert flops.ops_per_image(layers, cfg) == 2 * macs


@pytest.mark.parametrize("name, params", [
    ("resnet50_w8a8", 25.6e6), ("mobilenet_v1_w8a8", 4.2e6)])
def test_parameters_published(name, params):
    from reference import _qnet
    layers, cfg = layers_of(name)
    # the BatchNorm statistics are not learned parameters
    n = sum(int(__import__("math").prod(s)) for _, s, k in
            _qnet.param_specs(layers) if k not in ("mean", "var"))
    assert abs(n - params) / params < 0.02


def test_least_time_bounds_each_layer():
    layers, cfg = layers_of("resnet50_w8a8")
    rows = flops.layer_costs(layers, cfg)
    assert len(rows) == 54             # 53 convs and the FC
    least = flops.least_seconds_per_image(layers, cfg)
    assert sum(2 * r["macs"] for r in rows) / flops.PEAK_INT8_OPS <= least
    assert sum(r["bytes"] for r in rows) / flops.PEAK_HBM_BYTES <= least


def test_shapes_follow_caffe():
    layers, cfg = layers_of("resnet50_w8a8")
    sh = flops.shapes(layers, cfg)
    assert sh["conv1"] == (112, 112, 64)
    assert sh["pool1"] == (56, 56, 64)          # ceil mode
    assert sh["res5c"] == (7, 7, 2048)
    layers, cfg = layers_of("mobilenet_v1_w8a8")
    sh = flops.shapes(layers, cfg)
    assert sh["conv14/sep"] == (7, 7, 1024)
